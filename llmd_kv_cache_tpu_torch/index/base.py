"""Index contract.

Copy of the contract in ``llmd_kv_cache_tpu/index/base.py`` (counterpart of
reference ``pkg/kvcache/kvblock/index.go``). The index is LRU-bounded soft
state that converges from the KV-event stream; it tracks, for each request
key (content-addressed block hash), which pods hold the block and on which
device tier.

Dual key space (``index.go:108-155``): *request keys* are computed by the
indexer from tokens at the canonical block size; *engine keys* are whatever
hashes the engine itself emits. ``add`` learns the engine→request mapping
from the length ratio of the two key lists (both derive from the same token
count, so they divide evenly): 1:1, many:1 or 1:many.

The JAX package's backend selection (native, Redis, cost-aware) and its
snapshot capability are later slices; the port has the in-memory backend.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

from ..core.keys import BlockHash, KeyType, PodEntry


class Index(abc.ABC):
    """Thread-safe KV-block index backend contract."""

    @abc.abstractmethod
    def lookup(
        self,
        request_keys: Sequence[BlockHash],
        pod_identifier_set: Optional[set[str]] = None,
    ) -> dict[BlockHash, list[PodEntry]]:
        """Return pods per request key, filtered to ``pod_identifier_set``.

        An empty/None pod set returns all pods. A key present in the index
        with an empty pod set terminates the scan early (prefix chain broken
        at a once-known block); a key simply absent does not.
        """

    @abc.abstractmethod
    def add(
        self,
        engine_keys: Optional[Sequence[BlockHash]],
        request_keys: Sequence[BlockHash],
        entries: Sequence[PodEntry],
    ) -> None:
        """Store request-key → pod entries; learn engine→request mappings.

        ``engine_keys=None`` adds speculative entries with no mapping.
        """

    @abc.abstractmethod
    def evict(
        self,
        key: BlockHash,
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        """Remove the given pod entries from a key.

        ``KeyType.ENGINE`` resolves through the engine→request mapping
        first; ``KeyType.REQUEST`` operates on the key directly.
        """

    @abc.abstractmethod
    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        """Resolve an engine key to its last (highest-index) request key.

        Returns ``None`` when the mapping is unknown (e.g. already evicted).
        """

    @abc.abstractmethod
    def clear(self, pod_identifier: str) -> None:
        """Drop every entry for a pod, across all device tiers.

        Backs the pod-wide AllBlocksCleared KV-event (engine prefix-cache
        reset, e.g. after a weight rollout). O(N), off the hot path.
        """

    def lookup_chunked(
        self,
        request_keys: Sequence[BlockHash],
        pod_identifier_set: Optional[set[str]] = None,
        chunk_size: int = 128,
    ) -> dict[BlockHash, list[PodEntry]]:
        """``lookup`` issued in chunks, stopping at the first chunk with
        zero hits.

        Sound for longest-prefix scoring only: the scorer counts
        consecutive-from-0 runs, and an all-miss chunk proves the run ended
        inside or before it, so later keys cannot contribute. The result
        may therefore be a *subset* of a full ``lookup`` (hits after a gap
        are skipped) — identical scores, fewer backend round-trips.
        ``chunk_size <= 0`` degrades to a single full lookup.
        """
        n = len(request_keys)
        if chunk_size <= 0 or n <= chunk_size:
            return self.lookup(request_keys, pod_identifier_set)
        result: dict[BlockHash, list[PodEntry]] = {}
        for start in range(0, n, chunk_size):
            chunk = request_keys[start:start + chunk_size]
            found = self.lookup(chunk, pod_identifier_set)
            if not found:
                break
            result.update(found)
            # A partial chunk means some key in it missed, so the
            # consecutive-from-0 run ends inside this chunk; later chunks
            # cannot change any longest-prefix score.
            if len(found) < len(chunk):
                break
        return result

    def evict_batch(
        self,
        keys: Sequence[BlockHash],
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        """Evict the same pod entries from many keys."""
        for key in keys:
            self.evict(key, key_type, entries)


def infer_engine_mappings(
    engine_keys: Sequence[BlockHash], request_keys: Sequence[BlockHash]
) -> dict[BlockHash, list[BlockHash]]:
    """Infer engine→request key mappings from the length ratio.

    Mirrors reference ``in_memory.go:164-180``: with ``n = max(len(e),
    len(r))`` the i-th virtual slot maps ``engine[i*len(e)//n] →
    request[i*len(r)//n]``, producing 1:1, many:1 or 1:many fan-outs.
    """
    mappings: dict[BlockHash, list[BlockHash]] = {}
    ne, nr = len(engine_keys), len(request_keys)
    if ne == 0 or nr == 0:
        return mappings
    n = max(ne, nr)
    for i in range(n):
        ek = engine_keys[i * ne // n]
        rk = request_keys[i * nr // n]
        mappings.setdefault(ek, []).append(rk)
    return mappings
