"""In-memory index backend: two-level LRU.

Copy of ``llmd_kv_cache_tpu/index/in_memory.py`` (counterpart of reference
``pkg/kvcache/kvblock/in_memory.go``).
Outer LRU maps request key → per-key pod LRU (bounded, default 10 pods); a
sibling LRU maps engine key → request key list. All state is soft and
converges from the event stream.

Concurrency notes carried over from the reference (its documented TOCTOU
guards, ``in_memory.go:80-82,185-186,300-312``): a global mutex serializes
Evict's all-empty check + mapping removal against Add's entry insertion, and
empty-key removal re-checks emptiness under the per-key lock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Sequence

from ..core.keys import BlockHash, KeyType, PodEntry
from ..utils.lru import LRUCache
from .base import Index, infer_engine_mappings

DEFAULT_INDEX_SIZE = 10**8  # max request keys (reference in_memory.go:35)
DEFAULT_PODS_PER_KEY = 10  # max pod entries per key (in_memory.go:36)


@dataclass
class InMemoryIndexConfig:
    size: int = DEFAULT_INDEX_SIZE
    pod_cache_size: int = DEFAULT_PODS_PER_KEY

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "InMemoryIndexConfig":
        if not d:
            return cls()
        return cls(
            size=d.get("size", DEFAULT_INDEX_SIZE) or DEFAULT_INDEX_SIZE,
            pod_cache_size=d.get("podCacheSize", d.get("pod_cache_size", DEFAULT_PODS_PER_KEY))
            or DEFAULT_PODS_PER_KEY,
        )


class _PodCache:
    """Bounded LRU of pod entries for one request key."""

    __slots__ = ("cache", "mu")

    def __init__(self, capacity: int):
        self.cache: LRUCache[PodEntry, None] = LRUCache(capacity)
        self.mu = threading.Lock()


class InMemoryIndex(Index):
    """Two-level-LRU in-memory index."""

    def __init__(self, cfg: Optional[InMemoryIndexConfig] = None):
        cfg = cfg or InMemoryIndexConfig()
        self._data: LRUCache[BlockHash, _PodCache] = LRUCache(cfg.size)
        self._engine_to_request: LRUCache[BlockHash, list[BlockHash]] = LRUCache(cfg.size)
        self._pod_cache_size = cfg.pod_cache_size
        # Serializes engine-key-level check-and-act (Evict's all-empty check
        # + mapping removal vs Add's insertion) — reference in_memory.go:80-82.
        self._mu = threading.Lock()

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
                continue  # absent key does not break the scan (in_memory.go:142-144)
            entries = pod_cache.cache.keys()
            if not entries:
                # Known key with no pods: prefix chain breaks here — stop.
                return pods_per_key
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
                pod_cache, _ = self._data.get_or_create(
                    key, lambda: _PodCache(self._pod_cache_size)
                )
                with pod_cache.mu:
                    for entry in entries:
                        pod_cache.cache.add(entry, None)

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
                return  # unknown engine key: nothing to evict
            for rk in rks:
                self._evict_pods_from_request_key(rk, entries)
            with self._mu:
                all_empty = True
                for rk in rks:
                    pc = self._data.get(rk)
                    if pc is not None and len(pc.cache) > 0:
                        all_empty = False
                        break
                if all_empty:
                    self._engine_to_request.remove(key)
        elif key_type is KeyType.REQUEST:
            self._evict_pods_from_request_key(key, entries)
        else:  # pragma: no cover - enum exhaustive
            raise ValueError(f"unknown key type: {key_type}")

    def _evict_pods_from_request_key(
        self, request_key: BlockHash, entries: Sequence[PodEntry]
    ) -> None:
        pod_cache = self._data.get(request_key)
        if pod_cache is None:
            return

        with pod_cache.mu:
            for entry in entries:
                pod_cache.cache.remove(entry)
            is_empty = len(pod_cache.cache) == 0

        if not is_empty:
            return

        # Remove the now-empty key; re-check emptiness under the per-key
        # lock to avoid racing a concurrent Add (in_memory.go:300-312).
        current = self._data.get(request_key)
        if current is None:
            return
        with current.mu:
            if len(current.cache) == 0:
                self._data.remove(request_key)

    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        rks = self._engine_to_request.get(engine_key)
        if not rks:
            return None
        return rks[-1]

    def get_request_keys(self, engine_key: BlockHash) -> Optional[list[BlockHash]]:
        rks = self._engine_to_request.get(engine_key)
        return list(rks) if rks else None

    def clear(self, pod_identifier: str) -> None:
        # Peek so the scan does not promote LRU recency (in_memory.go:327-330).
        # The engine→request mapping is intentionally left untouched: it is
        # LRU-bounded, self-heals on re-Add, and stale mappings resolve to
        # emptied request keys that correctly break the prefix chain.
        for request_key in self._data.keys():
            pod_cache = self._data.peek(request_key)
            if pod_cache is None:
                continue
            with pod_cache.mu:
                matched = [
                    e for e in pod_cache.cache.keys() if e.pod_identifier == pod_identifier
                ]
            if matched:
                self._evict_pods_from_request_key(request_key, matched)

    # -- snapshot capability --

    def dump_state(self) -> dict:
        entries: list = []
        # Peek so the full-table scan does not promote LRU recency.
        for request_key in self._data.keys():
            pod_cache = self._data.peek(request_key)
            if pod_cache is None:
                continue
            with pod_cache.mu:
                rows = [
                    [
                        e.pod_identifier,
                        e.device_tier,
                        (1 if e.speculative else 0) | (2 if e.has_group else 0),
                        e.group_idx,
                    ]
                    for e in pod_cache.cache.keys()
                ]
            entries.append([int(request_key), rows])
        mappings: list = []
        for engine_key in self._engine_to_request.keys():
            rks = self._engine_to_request.peek(engine_key)
            if rks:
                mappings.append([int(engine_key), [int(rk) for rk in rks]])
        return {"entries": entries, "mappings": mappings}

    def restore_state(self, state: dict) -> int:
        restored = 0
        for request_key, rows in state.get("entries", []):
            pod_entries = [
                PodEntry(
                    pod_identifier=pod,
                    device_tier=tier,
                    speculative=bool(flags & 1),
                    has_group=bool(flags & 2),
                    group_idx=group_idx,
                )
                for pod, tier, flags, group_idx in rows
            ]
            if pod_entries:
                self.add(None, [request_key], pod_entries)
                restored += len(pod_entries)
        for engine_key, rks in state.get("mappings", []):
            self._engine_to_request.add(engine_key, list(rks))
        return restored

    def __len__(self) -> int:
        return len(self._data)
