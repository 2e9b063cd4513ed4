"""Indexer orchestrator: tokens → block keys → index lookup → pod scores.

Port of ``llmd_kv_cache_tpu/scoring/indexer.py`` (counterpart of reference
``pkg/kvcache/indexer.go``): ``compute_block_keys`` and ``score_tokens``
over the in-memory index, with hybrid-aware scoring
(``attach_group_catalog``) and the residency bonus of role-aware decode
scoring (``attach_residency``), and without the native fused scorer,
tracing, ledger, working-set and audit hooks (later slices). This is the
scheduler hot path: it answers "which pods hold the longest cached prefix
for these tokens, and how much of it" in a single in-process call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.extra_keys import BlockExtraFeatures
from ..core.keys import TIER_SHARED_STORAGE, BlockHash
from ..core.token_processor import ChunkedTokenDatabase, TokenProcessorConfig
from ..index.base import Index
from ..index.in_memory import InMemoryIndex
from .scorer import KVBlockScorerConfig, create_scorer


@dataclass
class IndexerConfig:
    """Top-level config (reference ``indexer.go:39-61``)."""

    token_processor_config: TokenProcessorConfig = field(default_factory=TokenProcessorConfig)
    scorer_config: KVBlockScorerConfig = field(default_factory=KVBlockScorerConfig)
    # Early-exit chunked lookup: score_tokens looks blocks up in chunks of
    # this many keys and stops at the first chunk that breaks the prefix
    # chain (0 disables — single full lookup).
    lookup_chunk_size: int = 128


class Indexer:
    """KV-cache indexer: the library's main entry point."""

    def __init__(
        self,
        config: Optional[IndexerConfig] = None,
        index: Optional[Index] = None,
    ):
        self.config = config or IndexerConfig()
        self.token_processor = ChunkedTokenDatabase(self.config.token_processor_config)
        self.kv_block_index: Index = index if index is not None else InMemoryIndex()
        self.scorer = create_scorer(self.config.scorer_config,
                                    block_size_tokens=self.token_processor.block_size)
        # Residency-aware decode-pod scoring (prefill/decode
        # disaggregation): None until attach_residency wires a
        # scoring.residency.ResidencyTracker.
        self.residency = None

    def attach_group_catalog(self, group_catalog) -> None:
        """Wire the event pool's GroupCatalog into hybrid-aware scoring
        (no-op for the longest-prefix strategy)."""
        if hasattr(self.scorer, "group_catalog"):
            self.scorer.group_catalog = group_catalog

    def attach_residency(self, tracker) -> None:
        """Wire a scoring.residency.ResidencyTracker into role-aware
        scoring: ``score_tokens(..., role="decode")`` adds each decode
        pod's transferred-prefix residency bonus (landed blocks full
        weight, in-flight discounted) on top of the base prefix score.
        When the index exposes a ``tier_discount`` hook, the bonus is
        additionally scaled by the transfer tier's observed restore
        latency — the discount engages ONLY through this path (the port's
        ``InMemoryIndex`` has none).
        """
        self.residency = tracker
        fn = getattr(self.kv_block_index, "tier_discount", None)
        if fn is not None and tracker.tier_discount_fn is None:
            tracker.tier_discount_fn = lambda: fn(TIER_SHARED_STORAGE)

    def compute_block_keys(
        self,
        tokens: Sequence[int],
        model_name: str,
        extra_features: Optional[Sequence[Optional[BlockExtraFeatures]]] = None,
    ) -> list[BlockHash]:
        """Content-address tokens at the canonical block size
        (reference ``indexer.go:178-195``)."""
        return self.token_processor.tokens_to_kv_block_keys(
            0, tokens, model_name, extra_features
        )

    def score_tokens(
        self,
        tokens: Sequence[int],
        model_name: str,
        pod_identifiers: Optional[set[str]] = None,
        extra_features: Optional[Sequence[Optional[BlockExtraFeatures]]] = None,
        role: str = "",
        detail: Optional[dict] = None,
    ) -> dict[str, float]:
        """Score candidate pods for the given tokens
        (reference ``indexer.go:238-303``).

        Returns pod → tier-weighted consecutive-prefix score. Pods in
        ``pod_identifiers`` that hold nothing simply do not appear.

        ``role`` is the requesting scheduler's target pod role ("" =
        role-agnostic, the legacy behavior). For ``role="decode"`` with a
        residency tracker attached, each pod's transferred-prefix
        residency bonus is added on top; when ``detail`` is a dict, the
        per-pod bonus is written into ``detail["residency"]``.
        """
        block_keys = self.compute_block_keys(tokens, model_name, extra_features)
        if not block_keys:
            return {}
        chunk = self.config.lookup_chunk_size
        if chunk > 0:
            key_to_pods = self.kv_block_index.lookup_chunked(
                block_keys, pod_identifiers, chunk_size=chunk)
        else:
            key_to_pods = self.kv_block_index.lookup(block_keys, pod_identifiers)
        scores = self.scorer.score(block_keys, key_to_pods)
        return self._apply_residency(scores, block_keys, pod_identifiers, role, detail)

    def _apply_residency(
        self,
        scores: dict[str, float],
        block_keys: Sequence[BlockHash],
        pod_identifiers: Optional[set[str]],
        role: str,
        detail: Optional[dict],
    ) -> dict[str, float]:
        """Add transferred-prefix residency bonuses for decode-role scoring.

        No-op unless the request targets decode pods and a residency
        tracker is attached; block keys are the same canonical chunk keys
        the index uses, so the tracker's claims line up 1:1.
        """
        if role != "decode" or self.residency is None:
            return scores
        bonus = self.residency.bonus(block_keys, pod_identifiers)
        if bonus:
            scores = dict(scores)
            for pod, b in bonus.items():
                scores[pod] = scores.get(pod, 0.0) + b
        if detail is not None:
            detail["residency"] = bonus
        return scores
