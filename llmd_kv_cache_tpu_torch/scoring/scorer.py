"""KV-block scorer.

Copy of the longest-prefix scorer in ``llmd_kv_cache_tpu/scoring/scorer.py``
(counterpart of reference ``pkg/kvcache/kvblock_scorer.go`` +
``pkg/kvcache/backend.go``). Scores candidate pods by the longest
consecutive run of cached blocks from block 0, weighting each hit by the
device tier it lives on. The tier weights are the JAX package's: ``tpu-hbm``
and ``gpu`` (the device tier) 1.0, ``cpu`` host memory 0.8, shared storage
0.5. The hybrid-aware strategy and liveness demotion are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.keys import (
    TIER_CPU,
    TIER_OBJECT_STORE,
    TIER_SHARED_STORAGE,
    TIER_TPU_HBM,
    BlockHash,
    PodEntry,
)

LONGEST_PREFIX_MATCH = "LongestPrefix"


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

    @property
    def strategy(self) -> str:
        return LONGEST_PREFIX_MATCH

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

        return pod_scores


def create_scorer(config: Optional[KVBlockScorerConfig] = None) -> LongestPrefixScorer:
    config = config or KVBlockScorerConfig()
    if config.scoring_strategy != LONGEST_PREFIX_MATCH:
        raise ValueError(f"unsupported scoring strategy: {config.scoring_strategy}")
    return LongestPrefixScorer({b.name: b.weight for b in config.backend_configs})
