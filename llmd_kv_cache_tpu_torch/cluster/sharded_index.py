"""Index partitioning: per-block-key routing and per-shard ownership filters.

Copy of ``llmd_kv_cache_tpu/cluster/sharded_index.py``.

Two complementary pieces of the sharded control plane:

- :class:`ShardedIndex` — an :class:`~llmd_kv_cache_tpu_torch.index.base.Index`
  over N child backends routed by the consistent-hash ring. One event
  pool writes through it and every block key lands on its owning child
  — the single-process form of sharded ingestion (also what bench.py
  uses to populate a toy cluster deterministically). The pool's
  write-combining ``_IngestCoalescer`` sits above it per drained batch;
  routed writes arrive already batched and are re-grouped per shard
  here, so each child sees one call per (shard, op) instead of one per
  key.

- :class:`ShardFilterIndex` — wraps ONE shard replica's local backend so
  the replica can ingest the full broadcast event stream but persist
  only the keys it owns (``shard_id ∈ owners(key, replication_factor)``).
  Engine→request *mappings* are kept for every key regardless of
  ownership: they are small ints, and chained parent resolution
  (``events.pool._handle_block_stored``) must never dead-end just
  because the parent block belongs to another shard. Each replica keeps
  its own pool, ``_IngestCoalescer``, journal and snapshots — the
  ingest and recovery machinery is reused per shard unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.keys import BlockHash, KeyType, PodEntry
from ..index.base import Index, infer_engine_mappings
from ..utils.logging import get_logger
from .ring import HashRing

logger = get_logger("cluster.sharded_index")


class ShardedIndex(Index):
    """Route every Index operation to the owning child by block key."""

    def __init__(self, children: dict[str, Index], ring: HashRing):
        missing = set(ring.shards) - set(children)
        if missing:
            raise ValueError(f"no child index for shards: {sorted(missing)}")
        self.children = dict(children)
        self.ring = ring

    def _child(self, key: BlockHash) -> Index:
        return self.children[self.ring.owner(key)]

    def _group(self, keys: Sequence[BlockHash]) -> dict[str, list[BlockHash]]:
        groups: dict[str, list[BlockHash]] = {}
        for key in keys:
            groups.setdefault(self.ring.owner(key), []).append(key)
        return groups

    # -- reads ------------------------------------------------------------

    def lookup(
        self,
        request_keys: Sequence[BlockHash],
        pod_identifier_set: Optional[set[str]] = None,
    ) -> dict[BlockHash, list[PodEntry]]:
        result: dict[BlockHash, list[PodEntry]] = {}
        for shard, keys in self._group(request_keys).items():
            result.update(self.children[shard].lookup(keys, pod_identifier_set))
        return result

    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        return self._child(engine_key).get_request_key(engine_key)

    def get_request_keys(self, engine_key: BlockHash) -> Optional[list[BlockHash]]:
        return self._child(engine_key).get_request_keys(engine_key)

    # -- writes -----------------------------------------------------------

    def add(
        self,
        engine_keys: Optional[Sequence[BlockHash]],
        request_keys: Sequence[BlockHash],
        entries: Sequence[PodEntry],
    ) -> None:
        # Mappings route by ENGINE key (get_request_key asks that owner);
        # entries route by REQUEST key. The two families shard
        # independently, so the inferred mapping is distributed explicitly
        # instead of letting each child re-infer from a partial list.
        if engine_keys is not None:
            by_shard: dict[str, dict[BlockHash, list[BlockHash]]] = {}
            for ek, rks in infer_engine_mappings(engine_keys, request_keys).items():
                by_shard.setdefault(self.ring.owner(ek), {})[ek] = rks
            for shard, mappings in by_shard.items():
                self.children[shard].add_mappings(mappings)
        for shard, keys in self._group(request_keys).items():
            self.children[shard].add(None, keys, entries)

    def evict(
        self,
        key: BlockHash,
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        if key_type is KeyType.ENGINE:
            # The mapping owner resolves; the entry owners evict.
            rks = self._child(key).get_request_keys(key)
            if not rks:
                return
            for shard, keys in self._group(rks).items():
                self.children[shard].evict_batch(keys, KeyType.REQUEST, entries)
            return
        self._child(key).evict(key, key_type, entries)

    def evict_batch(
        self,
        keys: Sequence[BlockHash],
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        if key_type is KeyType.ENGINE:
            resolved: list[BlockHash] = []
            for key in keys:
                rks = self._child(key).get_request_keys(key)
                if rks:
                    resolved.extend(rks)
            if not resolved:
                return
            for shard, group in self._group(resolved).items():
                self.children[shard].evict_batch(group, KeyType.REQUEST, entries)
            return
        for shard, group in self._group(keys).items():
            self.children[shard].evict_batch(group, key_type, entries)

    def clear(self, pod_identifier: str) -> None:
        for child in self.children.values():
            child.clear(pod_identifier)

    # -- snapshot capability ----------------------------------------------

    def dump_state(self) -> Optional[dict]:
        """Merged view across children (digest sources, tests). Real shard
        replicas snapshot their own child; this merge is the coordinator's
        whole-cluster view."""
        entries: list = []
        mappings: list = []
        for shard in self.ring.shards:
            state = self.children[shard].dump_state()
            if not state:
                return None
            entries.extend(state.get("entries", []))
            mappings.extend(state.get("mappings", []))
        return {"entries": entries, "mappings": mappings}

    def restore_state(self, state: dict) -> int:
        restored = 0
        by_shard: dict[str, dict] = {
            s: {"entries": [], "mappings": []} for s in self.ring.shards
        }
        for row in state.get("entries", []):
            by_shard[self.ring.owner(row[0])]["entries"].append(row)
        for row in state.get("mappings", []):
            by_shard[self.ring.owner(row[0])]["mappings"].append(row)
        for shard, sub in by_shard.items():
            if sub["entries"] or sub["mappings"]:
                restored += self.children[shard].restore_state(sub)
        return restored


class ShardFilterIndex(Index):
    """One replica's ownership filter over its local backend.

    Reads and writes pass through for owned keys; entry writes for keys
    this shard does not own are dropped (another replica owns them).
    Mappings always pass through — see the module docstring.
    """

    def __init__(
        self,
        inner: Index,
        ring: HashRing,
        shard_id: str,
        replication_factor: int = 2,
    ):
        if shard_id not in ring.shards:
            raise ValueError(f"shard id {shard_id!r} not in ring membership")
        self.inner = inner
        self.ring = ring
        self.shard_id = shard_id
        self.replication_factor = max(1, replication_factor)
        # Ingest accounting for the shard debug view.
        self.owned_writes = 0
        self.filtered_writes = 0

    def owns(self, key: BlockHash) -> bool:
        return self.shard_id in self.ring.owners(key, self.replication_factor)

    # -- reads ------------------------------------------------------------

    def lookup(
        self,
        request_keys: Sequence[BlockHash],
        pod_identifier_set: Optional[set[str]] = None,
    ) -> dict[BlockHash, list[PodEntry]]:
        return self.inner.lookup(request_keys, pod_identifier_set)

    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        return self.inner.get_request_key(engine_key)

    def get_request_keys(self, engine_key: BlockHash) -> Optional[list[BlockHash]]:
        return self.inner.get_request_keys(engine_key)

    # -- writes -----------------------------------------------------------

    def add(
        self,
        engine_keys: Optional[Sequence[BlockHash]],
        request_keys: Sequence[BlockHash],
        entries: Sequence[PodEntry],
    ) -> None:
        owned = [rk for rk in request_keys if self.owns(rk)]
        if engine_keys is not None:
            # Full mapping table regardless of ownership (parent chains).
            self.inner.add_mappings(infer_engine_mappings(engine_keys, request_keys))
        self.owned_writes += len(owned)
        self.filtered_writes += len(request_keys) - len(owned)
        if owned:
            self.inner.add(None, owned, entries)

    def add_mappings(self, mappings: dict[BlockHash, list[BlockHash]]) -> None:
        self.inner.add_mappings(mappings)

    def evict(
        self,
        key: BlockHash,
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        # Evicting a key we never stored is a no-op in every backend, so
        # ENGINE-type evicts (which resolve through the always-complete
        # mapping table) and non-owned REQUEST evicts are safe to forward.
        self.inner.evict(key, key_type, entries)

    def evict_batch(
        self,
        keys: Sequence[BlockHash],
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        self.inner.evict_batch(keys, key_type, entries)

    def clear(self, pod_identifier: str) -> None:
        self.inner.clear(pod_identifier)

    # -- snapshot capability ----------------------------------------------

    def dump_state(self) -> Optional[dict]:
        return self.inner.dump_state()

    def restore_state(self, state: dict) -> int:
        return self.inner.restore_state(state)

    def debug_view(self) -> dict:
        return {
            "shard_id": self.shard_id,
            "replication_factor": self.replication_factor,
            "owned_writes": self.owned_writes,
            "filtered_writes": self.filtered_writes,
            "ring": self.ring.describe(),
        }
