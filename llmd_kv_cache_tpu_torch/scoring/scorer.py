"""KV-block scorers.

Copy of ``llmd_kv_cache_tpu/scoring/scorer.py`` (counterpart of reference
``pkg/kvcache/kvblock_scorer.go`` + ``pkg/kvcache/backend.go``). The
longest-prefix scorer ranks candidate pods by the longest consecutive run
of cached blocks from block 0, weighting each hit by the device tier it
lives on; the hybrid-aware scorer values a sliding-window group by the
trailing window a resume needs. The tier weights are the JAX package's:
``tpu-hbm`` and ``gpu`` (the device tier) 1.0, ``cpu`` host memory 0.8,
shared storage 0.5. A ``PodLivenessTracker`` attached by the host
(``Indexer.attach_liveness``) scales each pod's score by its liveness
factor and drops zeroed pods.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.hma import SPEC_SINK_FULL
from ..core.keys import (
    TIER_CPU,
    TIER_OBJECT_STORE,
    TIER_SHARED_STORAGE,
    TIER_TPU_HBM,
    BlockHash,
    PodEntry,
)

LONGEST_PREFIX_MATCH = "LongestPrefix"
HYBRID_AWARE = "HybridAware"


@dataclass
class KVCacheBackendConfig:
    """A device tier/medium and its scoring weight (``backend.go:19-24``)."""

    name: str
    weight: float


def default_backend_configs() -> list[KVCacheBackendConfig]:
    """The JAX package's tier weights (``gpu`` weighs like the HBM tier)."""
    return [
        KVCacheBackendConfig(name=TIER_TPU_HBM, weight=1.0),
        KVCacheBackendConfig(name="gpu", weight=1.0),
        KVCacheBackendConfig(name=TIER_CPU, weight=0.8),
        KVCacheBackendConfig(name=TIER_SHARED_STORAGE, weight=0.5),
        KVCacheBackendConfig(name=TIER_OBJECT_STORE, weight=0.5),
    ]


@dataclass
class KVBlockScorerConfig:
    scoring_strategy: str = LONGEST_PREFIX_MATCH
    backend_configs: list[KVCacheBackendConfig] = field(default_factory=default_backend_configs)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "KVBlockScorerConfig":
        if not d:
            return cls()
        backends = d.get("backendConfigs", d.get("backend_configs"))
        cfg = cls(scoring_strategy=d.get("scoringStrategy", d.get("scoring_strategy", LONGEST_PREFIX_MATCH)))
        if backends:
            cfg.backend_configs = [
                KVCacheBackendConfig(name=b["name"], weight=float(b["weight"])) for b in backends
            ]
        return cfg


class LongestPrefixScorer:
    """Longest-consecutive-prefix scorer with tier weighting.

    Mirrors reference ``kvblock_scorer.go:106-154``: per key, each pod takes
    the max weight across its tiers holding the block; pods drop out of the
    active set at their first gap; scores accumulate while active.
    """

    def __init__(self, medium_weights: Optional[dict[str, float]] = None):
        self.medium_weights = (
            medium_weights
            if medium_weights is not None
            else {b.name: b.weight for b in default_backend_configs()}
        )
        # Optional PodLivenessTracker (resilience.liveness), attached by
        # the host (Indexer.attach_liveness): demotes pods whose event
        # stream, and therefore whose index view, has gone stale.
        self.liveness = None

    @property
    def strategy(self) -> str:
        return LONGEST_PREFIX_MATCH

    def _apply_liveness(self, scores: dict[str, float]) -> dict[str, float]:
        """Degraded-mode weighting: multiply each pod's score by its
        liveness factor (1 fresh → 0 dead) and drop zeroed pods. With every
        pod stale, scores empty out and the router falls back to
        round-robin: degrading toward fairness, never toward a corpse."""
        if self.liveness is None or not scores:
            return scores
        out = {}
        for pod, s in scores.items():
            f = self.liveness.factor(pod)
            if s * f > 0.0:
                out[pod] = s * f
        return out

    def _fill_max_weights(
        self, entries: Sequence[PodEntry]
    ) -> dict[str, float]:
        weights: dict[str, float] = {}
        for entry in entries:
            w = self.medium_weights.get(entry.device_tier, 1.0)
            cur = weights.get(entry.pod_identifier)
            if cur is None or w > cur:
                weights[entry.pod_identifier] = w
        return weights

    def score(
        self,
        keys: Sequence[BlockHash],
        key_to_pods: dict[BlockHash, list[PodEntry]],
    ) -> dict[str, float]:
        if not keys:
            return {}

        cur_weights = self._fill_max_weights(key_to_pods.get(keys[0], []))
        pod_scores = dict(cur_weights)
        active = set(cur_weights)

        for key in keys[1:]:
            if not active:
                break
            cur_weights = self._fill_max_weights(key_to_pods.get(key, []))
            for pod in list(active):
                w = cur_weights.get(pod)
                if w is not None:
                    pod_scores[pod] += w
                else:
                    active.discard(pod)

        return self._apply_liveness(pod_scores)


class HybridAwareScorer(LongestPrefixScorer):
    """Sliding-window-aware scoring (the reference's documented WIP,
    ``docs/architecture.md`` "Hybrid attention").

    For a full-attention group a cached prefix of L blocks saves L blocks of
    prefill: the longest-prefix rule. For a ``sliding_window`` group of
    window W, a resume at length L needs only the blocks covering the last
    W tokens of L, so the usable prefix is the deepest L whose trailing
    window of blocks is all present, and the saving is capped at the
    window. A pod scores the minimum over its cataloged groups (a resume
    needs every group's share); pods the ``GroupCatalog`` does not know
    score as full attention.
    """

    def __init__(self, medium_weights=None, group_catalog=None,
                 block_size_tokens: int = 16):
        super().__init__(medium_weights)
        self.group_catalog = group_catalog
        self.block_size_tokens = block_size_tokens

    @property
    def strategy(self) -> str:
        return HYBRID_AWARE

    def _window_blocks(self, pod: str, group_idx) -> Optional[int]:
        """A group's sliding window in blocks; None = full attention.

        ``sink_full_attention`` groups are None too: their mask keeps the
        sink prefix attendable past the window and their engines resume by
        longest prefix, so a trailing window without block 0 is worth
        nothing there.
        """
        if group_idx is None or self.group_catalog is None:
            return None
        meta = self.group_catalog.get(pod, group_idx)
        if (meta is not None and meta.sliding_window_size
                and meta.kind != SPEC_SINK_FULL):
            return max(1, -(-meta.sliding_window_size // self.block_size_tokens))
        return None

    @staticmethod
    def _merge_max(dst: dict[int, float], src: dict[int, float]) -> None:
        """Fold ``src`` into ``dst`` keeping the per-index max weight."""
        for i, w in src.items():
            if w > dst.get(i, 0.0):
                dst[i] = w

    @staticmethod
    def _prefix_value(blocks: dict[int, float]) -> float:
        """Longest-consecutive-from-0 weighted value."""
        total = 0.0
        i = 0
        while i in blocks:
            total += blocks[i]
            i += 1
        return total

    @staticmethod
    def _window_value(blocks: dict[int, float], n_keys: int, wb: int) -> float:
        """Deepest resume length whose trailing min(wb, L) blocks are all
        present; value = their weights (capped at the window). One pass:
        the present run ending at each position and a weight prefix sum."""
        run = 0
        best_end = 0
        prefix = [0.0] * (n_keys + 1)
        for i in range(n_keys):
            w = blocks.get(i)
            prefix[i + 1] = prefix[i] + (w or 0.0)
            run = run + 1 if w is not None else 0
            if run >= min(wb, i + 1):
                best_end = i + 1
        if best_end == 0:
            return 0.0
        return prefix[best_end] - prefix[max(0, best_end - wb)]

    def score(self, keys, key_to_pods):
        if not keys:
            return {}
        if self.group_catalog is None:
            return super().score(keys, key_to_pods)

        # One pass: per pod, a presence map per tagged group and one for the
        # untagged entries (tokenless tier updates carry no group: they
        # assert residency for every group).
        tagged: dict[str, dict[int, dict[int, float]]] = {}
        untagged: dict[str, dict[int, float]] = {}
        for i, key in enumerate(keys):
            for e in key_to_pods.get(key, []):
                w = self.medium_weights.get(e.device_tier, 1.0)
                slot = (
                    tagged.setdefault(e.pod_identifier, {}).setdefault(e.group_idx, {})
                    if e.has_group
                    else untagged.setdefault(e.pod_identifier, {})
                )
                if w > slot.get(i, 0.0):
                    slot[i] = w

        # A pod's score is the minimum over its cataloged groups (full
        # attention: longest prefix; SWA: trailing window); a cataloged
        # group with nothing resident zeroes it. Pods with no cataloged
        # group score by the longest prefix; tagged entries of a group the
        # catalog does not know fold into that fallback.
        scores: dict[str, float] = {}
        for pod in set(tagged) | set(untagged):
            pod_groups = tagged.get(pod, {})
            cataloged = self.group_catalog.groups(pod)
            extra = dict(untagged.get(pod, {}))
            for g, presence in pod_groups.items():
                if g not in cataloged:
                    self._merge_max(extra, presence)
            if not cataloged:
                scores[pod] = self._prefix_value(extra) if extra else 0.0
                continue
            value = None
            for g in cataloged:
                blocks = dict(extra)
                self._merge_max(blocks, pod_groups.get(g, {}))
                wb = self._window_blocks(pod, g)
                gv = (self._prefix_value(blocks) if wb is None
                      else self._window_value(blocks, len(keys), wb))
                value = gv if value is None else min(value, gv)
            scores[pod] = value or 0.0
        return self._apply_liveness(
            {p: v for p, v in scores.items() if v > 0.0})


def create_scorer(config: Optional[KVBlockScorerConfig] = None,
                  block_size_tokens: int = 16) -> LongestPrefixScorer:
    config = config or KVBlockScorerConfig()
    weights = {b.name: b.weight for b in config.backend_configs}
    if config.scoring_strategy == LONGEST_PREFIX_MATCH:
        return LongestPrefixScorer(weights)
    if config.scoring_strategy == HYBRID_AWARE:
        # The GroupCatalog lives on the event pool: the host wires it after
        # construction (Indexer.attach_group_catalog).
        return HybridAwareScorer(weights, None, block_size_tokens)
    raise ValueError(f"unsupported scoring strategy: {config.scoring_strategy}")
