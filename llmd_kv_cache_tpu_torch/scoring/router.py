"""KV-cache-aware router: the scheduler-side scoring plugin.

Copy of ``llmd_kv_cache_tpu/scoring/router.py`` (counterpart of reference
``examples/kv_cache_aware_scorer``, the EPP ``PrecisePrefixCacheScorer``):
wraps the Indexer into a routing decision and, crucially, inserts
**speculative** index entries for the blocks the routed request will
create — so identical prompts arriving before the engine's KV events
confirm residency still converge onto the same pod instead of fanning out.
Speculative entries carry a TTL and are dropped if unconfirmed (the real
event stream overwrites them with authoritative entries; both coexist as
distinct PodEntry values).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

from ..core.keys import TIER_TPU_HBM, KeyType, PodEntry
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .indexer import Indexer

logger = get_logger("scoring.router")


@dataclass
class RouterConfig:
    # Weight multiplier applied to the KV score when combining with external
    # signals (the reference's "precise" config uses weight 3.0 inside EPP).
    kv_score_weight: float = 3.0
    # Speculative entries expire after this many seconds if no KV event
    # confirmed the blocks.
    speculative_ttl_s: float = 30.0
    # Minimum score advantage (in blocks) required to override round-robin.
    min_score_to_prefer: float = 1.0


class KVAwareRouter:
    """Routes requests to the pod holding the longest cached prefix."""

    def __init__(self, indexer: Indexer, pods: Sequence[str],
                 config: Optional[RouterConfig] = None):
        self.indexer = indexer
        self.pods = list(pods)
        self.config = config or RouterConfig()
        self._rr_counter = 0
        self._lock = new_lock()
        # (pod, block-key) → expiry of outstanding speculative inserts;
        # keyed per block (not per chain) so overlapping prompts sharing a
        # prefix refresh the shared keys' TTLs — a shorter prompt's expiry
        # must never evict keys still covered by a longer prompt's record.
        self._speculative: dict[tuple[str, int], float] = {}

    def set_pods(self, pods: Sequence[str]) -> None:
        with self._lock:
            self.pods = list(pods)

    def route(self, tokens: Sequence[int], model_name: str) -> str:
        """Pick the pod for a request and record speculative residency."""
        if not self.pods:
            # Must fail loudly: an empty filter set means "all pods" to the
            # index, which would happily route to a drained pod.
            raise RuntimeError("no candidate pods")
        self._expire_speculative()
        # Hash once; reuse the key chain for lookup, scoring, and the
        # speculative insert.
        keys = self.indexer.compute_block_keys(tokens, model_name)
        scores: dict[str, float] = {}
        if keys:
            key_to_pods = self.indexer.kv_block_index.lookup(keys, set(self.pods))
            scores = self.indexer.scorer.score(keys, key_to_pods)
        pod = self._pick(scores)
        self._add_speculative(keys, pod)
        return pod

    def scores(self, tokens: Sequence[int], model_name: str) -> dict[str, float]:
        """Weighted scores for external scheduler composition."""
        raw = self.indexer.score_tokens(tokens, model_name, set(self.pods))
        return {p: s * self.config.kv_score_weight for p, s in raw.items()}

    def _pick(self, scores: dict[str, float]) -> str:
        with self._lock:
            if scores:
                best_pod, best = max(scores.items(), key=lambda kv: kv[1])
                if best >= self.config.min_score_to_prefer:
                    return best_pod
            if not self.pods:
                raise RuntimeError("no candidate pods")
            pod = self.pods[self._rr_counter % len(self.pods)]
            self._rr_counter += 1
            return pod

    def _add_speculative(self, keys: Sequence[int], pod: str) -> None:
        if not keys:
            return
        entry = PodEntry(pod_identifier=pod, device_tier=TIER_TPU_HBM,
                         speculative=True)
        try:
            self.indexer.kv_block_index.add(None, list(keys), [entry])
        except Exception:
            logger.exception("speculative add failed")
            return
        expiry = time.monotonic() + self.config.speculative_ttl_s
        with self._lock:
            for key in keys:
                self._speculative[(pod, key)] = expiry

    def _expire_speculative(self) -> None:
        now = time.monotonic()
        with self._lock:
            expired = [k for k, expiry in self._speculative.items() if expiry <= now]
            for k in expired:
                del self._speculative[k]
        for pod, key in expired:
            entry = PodEntry(pod_identifier=pod, device_tier=TIER_TPU_HBM,
                             speculative=True)
            try:
                self.indexer.kv_block_index.evict(key, KeyType.REQUEST, [entry])
            except Exception:
                logger.debug("speculative evict failed for key %d", key)
