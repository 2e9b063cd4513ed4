"""Cost-aware (byte-budget) in-memory index backend.

Copy of ``llmd_kv_cache_tpu/index/cost_aware.py`` (counterpart of reference ``pkg/kvcache/kvblock/cost_aware_memory.go``,
which builds on ristretto). Rather than bounding the number of keys, the backend
bounds the approximate resident byte size of the index, evicting
least-recently-used request keys when over budget. This implementation uses
a strict LRU with exact cost bookkeeping instead of ristretto's sampled
admission/eviction — simpler, deterministic, and sufficient since the hot
path is dict-speed either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..core.keys import BlockHash, KeyType, PodEntry
from ..utils.humanize import parse_bytes
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from ..utils.lru import LRUCache
from .base import Index, infer_engine_mappings

logger = get_logger("index.cost_aware")

DEFAULT_MAX_COST = "2GiB"  # reference cost_aware_memory.go:47-51

# Approximate per-object overheads used for cost accounting, mirroring the
# role of CostPodCache.CalculateByteSize (cost_aware_memory.go:191).
_KEY_COST = 8 + 48  # uint64 key + map slot overhead
_ENTRY_BASE_COST = 64

# Tier-latency discount hook: restore
# latency is folded as an EMA per tier, and ``tier_discount`` maps it to a
# multiplicative factor in (0, 1] — 1.0 for an unobserved/fast tier,
# approaching 0 as observed restore latency dwarfs the baseline. Consumed
# only by residency-aware scoring (scoring.residency wires it through
# Indexer.attach_residency); the base prefix scores never see it.
_TIER_LATENCY_ALPHA = 0.2
_TIER_DISCOUNT_BASELINE_S = 0.05


def _entry_cost(entry: PodEntry) -> int:
    return _ENTRY_BASE_COST + len(entry.pod_identifier) + len(entry.device_tier)


@dataclass
class CostAwareMemoryIndexConfig:
    max_cost: str | int = DEFAULT_MAX_COST
    # Engine→request mappings are kept in a bounded LRU sized by entry count;
    # each mapping is tiny (two uint64s), so a count bound suffices.
    mapping_size: int = 2_000_000

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "CostAwareMemoryIndexConfig":
        if not d:
            return cls()
        return cls(
            max_cost=d.get("maxCost", d.get("max_cost", DEFAULT_MAX_COST)) or DEFAULT_MAX_COST,
            mapping_size=d.get("mappingSize", d.get("mapping_size", 2_000_000)) or 2_000_000,
        )


class _CostPodCache:
    __slots__ = ("entries", "mu", "cost")

    def __init__(self) -> None:
        self.entries: dict[PodEntry, None] = {}
        self.mu = new_lock()
        self.cost = _KEY_COST


class CostAwareMemoryIndex(Index):
    """Byte-budgeted LRU index."""

    def __init__(self, cfg: Optional[CostAwareMemoryIndexConfig] = None):
        cfg = cfg or CostAwareMemoryIndexConfig()
        self._max_cost = parse_bytes(cfg.max_cost)
        if self._max_cost <= 0:
            raise ValueError(f"max_cost must be positive, got {cfg.max_cost!r}")
        # Outer map with LRU ordering; capacity is effectively unbounded by
        # count — the byte budget drives eviction.
        self._data: LRUCache[BlockHash, _CostPodCache] = LRUCache(2**62)
        self._engine_to_request: LRUCache[BlockHash, list[BlockHash]] = LRUCache(cfg.mapping_size)
        self._total_cost = 0
        self._mu = new_lock()
        # Tier restore-latency EMAs feeding ``tier_discount`` (see module
        # header); observed by whoever times restores against the tier
        # (the engine's deferred-restore path via on_restore_latency).
        self._tier_latency_ema: dict[str, float] = {}

    @property
    def total_cost(self) -> int:
        return self._total_cost

    def observe_tier_latency(self, tier: str, seconds: float) -> None:
        """Fold one restore-latency observation into the tier's EMA."""
        seconds = max(float(seconds), 0.0)
        with self._mu:
            prev = self._tier_latency_ema.get(tier)
            self._tier_latency_ema[tier] = (
                seconds if prev is None
                else prev + _TIER_LATENCY_ALPHA * (seconds - prev)
            )

    def tier_discount(self, tier: str) -> float:
        """Restore-latency discount for ``tier`` in (0, 1].

        ``baseline / (baseline + ema)``: 1.0 when the tier has never been
        observed, ~0.5 at the baseline latency, and decaying toward 0 for
        tiers whose restores are slow enough that recomputing locally
        starts to win. Applied only when residency scoring is on.
        """
        with self._mu:
            ema = self._tier_latency_ema.get(tier)
        if ema is None:
            return 1.0
        return _TIER_DISCOUNT_BASELINE_S / (_TIER_DISCOUNT_BASELINE_S + ema)

    def lookup(
        self,
        request_keys: Sequence[BlockHash],
        pod_identifier_set: Optional[set[str]] = None,
    ) -> dict[BlockHash, list[PodEntry]]:
        if not request_keys:
            raise ValueError("no request_keys provided for lookup")

        pods_per_key: dict[BlockHash, list[PodEntry]] = {}
        filter_pods = bool(pod_identifier_set)

        for key in request_keys:
            pod_cache = self._data.get(key)
            if pod_cache is None:
                continue
            with pod_cache.mu:
                entries = list(pod_cache.entries.keys())
            if not entries:
                return pods_per_key  # chain broken at a known key
            if filter_pods:
                filtered = [e for e in entries if e.pod_identifier in pod_identifier_set]
                if filtered:
                    pods_per_key[key] = filtered
            else:
                pods_per_key[key] = entries
        return pods_per_key

    def add(
        self,
        engine_keys: Optional[Sequence[BlockHash]],
        request_keys: Sequence[BlockHash],
        entries: Sequence[PodEntry],
    ) -> None:
        if not request_keys or not entries:
            raise ValueError("no keys or entries provided for adding to index")

        if engine_keys is not None:
            for ek, rks in infer_engine_mappings(engine_keys, request_keys).items():
                self._engine_to_request.add(ek, rks)

        with self._mu:
            for key in request_keys:
                pod_cache, _ = self._data.get_or_create(key, _CostPodCache)
                with pod_cache.mu:
                    if pod_cache.cost == _KEY_COST and not pod_cache.entries:
                        self._total_cost += _KEY_COST  # newly admitted key
                    for entry in entries:
                        if entry not in pod_cache.entries:
                            delta = _entry_cost(entry)
                            pod_cache.entries[entry] = None
                            pod_cache.cost += delta
                            self._total_cost += delta
            self._evict_over_budget_locked()

    def _evict_over_budget_locked(self) -> None:
        """Evict least-recently-used keys until under the byte budget."""
        while self._total_cost > self._max_cost:
            keys = self._data.keys()  # oldest first
            if not keys:
                break
            victim = keys[0]
            pod_cache = self._data.peek(victim)
            self._data.remove(victim)
            if pod_cache is not None:
                with pod_cache.mu:
                    self._total_cost -= pod_cache.cost
                    pod_cache.entries.clear()
                    pod_cache.cost = 0

    def evict(
        self,
        key: BlockHash,
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")

        if key_type is KeyType.ENGINE:
            rks = self._engine_to_request.get(key)
            if rks is None:
                return
            for rk in rks:
                self._evict_pods_from_request_key(rk, entries)
            with self._mu:
                all_empty = all(
                    (pc := self._data.get(rk)) is None or not pc.entries for rk in rks
                )
                if all_empty:
                    self._engine_to_request.remove(key)
        elif key_type is KeyType.REQUEST:
            self._evict_pods_from_request_key(key, entries)
        else:  # pragma: no cover
            raise ValueError(f"unknown key type: {key_type}")

    def _evict_pods_from_request_key(
        self, request_key: BlockHash, entries: Sequence[PodEntry]
    ) -> None:
        with self._mu:
            # Re-fetch under the global lock: a concurrent over-budget
            # eviction + re-add may have replaced the cache object, and
            # removing via a stale reference would delete the new entries
            # and leak their accounted cost (cf. in_memory.go:300-312).
            pod_cache = self._data.get(request_key)
            if pod_cache is None:
                return
            with pod_cache.mu:
                for entry in entries:
                    if entry in pod_cache.entries:
                        delta = _entry_cost(entry)
                        del pod_cache.entries[entry]
                        pod_cache.cost -= delta
                        self._total_cost -= delta
                if not pod_cache.entries:
                    if self._data.remove(request_key):
                        self._total_cost -= pod_cache.cost
                        pod_cache.cost = 0

    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        rks = self._engine_to_request.get(engine_key)
        if not rks:
            return None
        return rks[-1]

    def clear(self, pod_identifier: str) -> None:
        for request_key in self._data.keys():
            pod_cache = self._data.peek(request_key)
            if pod_cache is None:
                continue
            with pod_cache.mu:
                matched = [
                    e for e in pod_cache.entries if e.pod_identifier == pod_identifier
                ]
            if matched:
                self._evict_pods_from_request_key(request_key, matched)

    def __len__(self) -> int:
        return len(self._data)
