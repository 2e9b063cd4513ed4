"""Bounded-load consistent-hash ring for the sharded indexer control plane.

Copy of ``llmd_kv_cache_tpu/cluster/ring.py`` over the port's
``utils.fnv``: the same memberships give the same table, owners, versions
and fingerprints in both packages.

Partition-table variant of consistent hashing with bounded loads
(Mirrokni/Thorup/Zadimoghaddam): a fixed number of *partitions* is placed
on a 64-bit ring; each shard contributes ``virtual_nodes`` vnode points;
every partition is assigned to the first shard clockwise from it whose
partition count is under the bound ``ceil(load_factor * partitions /
shards)``. Block keys map to partitions, partitions map to shards:

- **balance within bound** — the cap is a hard invariant, not an
  expectation: no shard ever primaries more than ``ceil(load_factor *
  P / N)`` partitions.
- **minimal key movement** — membership change moves only the partitions
  whose clockwise walk now resolves differently; everything else stays
  where it was (the consistent-hashing property the fixed partition
  layer preserves).
- **deterministic across processes** — every placement comes from
  FNV-1a over stable byte strings; Python's randomized ``hash()`` is
  never involved, so N schedulers and N shard replicas that share the
  membership list derive the identical table.

The ring is immutable; membership change means building a new ring and
(optionally) diffing it with :func:`moved_partitions` for rebalance
telemetry.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Iterable, Sequence

from ..utils.fnv import fnv1a_64

_MASK64 = 0xFFFFFFFFFFFFFFFF

DEFAULT_VIRTUAL_NODES = 64
DEFAULT_PARTITIONS = 1024
DEFAULT_LOAD_FACTOR = 1.25


def _mix64(h: int) -> int:
    """MurmurHash3 64-bit finalizer. FNV-1a of short, similar strings
    (vnode/partition labels differ only in trailing digits) clusters on
    the high bits of the ring; the avalanche pass restores uniform
    placement while staying pure integer arithmetic — deterministic
    everywhere."""
    h &= _MASK64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h


def _point(data: bytes) -> int:
    return _mix64(fnv1a_64(data))


def _key_bytes(key: int) -> bytes:
    return (int(key) & _MASK64).to_bytes(8, "big")


class HashRing:
    """Immutable bounded-load consistent-hash ring over shard ids."""

    def __init__(
        self,
        shards: Iterable[str],
        virtual_nodes: int = DEFAULT_VIRTUAL_NODES,
        partitions: int = DEFAULT_PARTITIONS,
        load_factor: float = DEFAULT_LOAD_FACTOR,
        epoch: int = 0,
    ):
        members = sorted(set(shards))
        if epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {epoch}")
        if not members:
            raise ValueError("HashRing needs at least one shard")
        if virtual_nodes <= 0 or partitions <= 0:
            raise ValueError("virtual_nodes and partitions must be positive")
        if load_factor < 1.0:
            raise ValueError(f"load_factor must be >= 1.0, got {load_factor}")
        self.shards: tuple[str, ...] = tuple(members)
        self.virtual_nodes = virtual_nodes
        self.partitions = partitions
        self.load_factor = load_factor
        # Topology epoch this ring was built for (cluster.membership).
        # Placement ignores it — two rings with the same members place
        # identically across epochs — but it feeds ``version`` so plan
        # caches and fingerprints distinguish "same placement, older
        # topology" from "same ring".
        self.epoch = epoch
        # Hard per-shard primary cap (the "bounded load").
        self.capacity = math.ceil(load_factor * partitions / len(members))

        points: list[tuple[int, str]] = []
        for shard in members:
            base = shard.encode("utf-8")
            for i in range(virtual_nodes):
                points.append((_point(base + b"#%d" % i), shard))
        points.sort()
        self._points = points
        self._point_keys = [p for p, _ in points]

        # Per-partition preference list: distinct shards in clockwise vnode
        # order from the partition's own ring point. The bounded-load
        # primary is the first under-cap shard in that list; replicas are
        # the following distinct shards (uncapped — replica load is a soft
        # concern, determinism and failover coverage are the hard ones).
        loads: dict[str, int] = {s: 0 for s in members}
        prefs: list[tuple[str, ...]] = []
        table: list[str] = []
        for p in range(partitions):
            point = _point(b"partition/%d" % p)
            pref = self._walk(point)
            prefs.append(pref)
            primary = next((s for s in pref if loads[s] < self.capacity), pref[0])
            loads[primary] += 1
            table.append(primary)
        self._prefs = prefs
        self._table = table
        self._loads = loads

        # Membership fingerprint for cross-process plan-cache keying: two
        # rings agree on every assignment iff they agree on this.
        sig = "|".join(members).encode("utf-8")
        sig += b"/%d/%d/%d" % (virtual_nodes, partitions, int(load_factor * 1000))
        if epoch:
            # Appended only when set so pre-epoch processes (and journals
            # holding their version numbers) keep hashing identically.
            sig += b"/e%d" % epoch
        self.version = fnv1a_64(sig)

    def with_epoch(self, epoch: int) -> "HashRing":
        """Same membership and shape, new topology epoch (the router's
        atomic swap on an epoch bump — placement provably unchanged)."""
        return HashRing(
            self.shards,
            virtual_nodes=self.virtual_nodes,
            partitions=self.partitions,
            load_factor=self.load_factor,
            epoch=epoch,
        )

    # -- placement --------------------------------------------------------

    def _walk(self, point: int) -> tuple[str, ...]:
        """Distinct shards in clockwise vnode order starting at ``point``."""
        idx = bisect_left(self._point_keys, point)
        n = len(self._points)
        seen: list[str] = []
        seen_set: set[str] = set()
        for step in range(n):
            shard = self._points[(idx + step) % n][1]
            if shard not in seen_set:
                seen_set.add(shard)
                seen.append(shard)
                if len(seen) == len(self.shards):
                    break
        return tuple(seen)

    def partition_of(self, key: int) -> int:
        """Block key → partition. Keys are re-hashed (they are already
        FNV-chained block hashes, but re-hashing decorrelates the
        partition choice from the chain structure)."""
        return _mix64(fnv1a_64(_key_bytes(key))) % self.partitions

    def owner(self, key: int) -> str:
        """Primary shard for a block key."""
        return self._table[self.partition_of(key)]

    def owner_of_partition(self, partition: int) -> str:
        return self._table[partition]

    def owners(self, key: int, n: int = 1) -> list[str]:
        """``n`` distinct shards for a block key, primary first.

        The primary is the bounded-load assignment; replicas follow the
        partition's clockwise preference order, skipping the primary.
        """
        p = self.partition_of(key)
        primary = self._table[p]
        if n <= 1:
            return [primary]
        out = [primary]
        for shard in self._prefs[p]:
            if shard != primary:
                out.append(shard)
                if len(out) >= n:
                    break
        return out

    # -- introspection ----------------------------------------------------

    def load(self) -> dict[str, int]:
        """Primary partition count per shard (skew telemetry)."""
        return dict(self._loads)

    def describe(self) -> dict:
        """JSON-able summary for the admin/debug surface."""
        return {
            "shards": list(self.shards),
            "partitions": self.partitions,
            "virtual_nodes": self.virtual_nodes,
            "capacity": self.capacity,
            "version": self.version,
            "epoch": self.epoch,
            "load": self.load(),
        }


def moved_partitions(old: HashRing, new: HashRing) -> int:
    """Partitions whose primary differs between two rings (must share the
    partition count). The rebalance cost of a membership change."""
    if old.partitions != new.partitions:
        raise ValueError("rings disagree on partition count")
    return sum(
        1
        for p in range(old.partitions)
        if old.owner_of_partition(p) != new.owner_of_partition(p)
    )


def assignment_fingerprint(ring: HashRing) -> int:
    """Order-sensitive FNV digest of the full partition table, salted
    with the ring ``version`` — equal fingerprints mean byte-identical
    assignment AND the same topology epoch, so two rings with identical
    placement but different epochs compare unequal (a stale-epoch plan
    can never masquerade as current just because membership round-
    tripped). Cross-process determinism checks rely on both halves."""
    acc = b"".join(s.encode("utf-8") + b"\x00" for s in ring._table)
    acc += b"@%d" % ring.version
    return fnv1a_64(acc)


def plan_owners(ring: HashRing, keys: Sequence[int]) -> tuple[str, ...]:
    """Primary owner per key, in key order (the router's fan-out plan)."""
    table = ring._table
    return tuple(table[ring.partition_of(k)] for k in keys)
