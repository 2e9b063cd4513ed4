"""Index contract and backend selection.

Port of ``llmd_kv_cache_tpu/index/base.py`` (counterpart of
reference ``pkg/kvcache/kvblock/index.go``). The index is LRU-bounded soft
state that converges from the KV-event stream; it tracks, for each request
key (content-addressed block hash), which pods hold the block and on which
device tier.

Dual key space (``index.go:108-155``): *request keys* are computed by the
indexer from tokens at the canonical block size; *engine keys* are whatever
hashes the engine itself emits. ``add`` learns the engine→request mapping
from the length ratio of the two key lists (both derive from the same token
count, so they divide evenly): 1:1, many:1 or 1:many.

``create_index`` picks a backend with JAX's priority (cost-aware > native >
redis > in-memory) and wraps it in the metrics, tracing and failover
decorators the config asks for. One deliberate difference: with no backend
named, JAX takes the native index where its library builds and the Python
index elsewhere; the port takes the native index and lets a failed build
raise, so a deployment never serves from the slower index unknowingly.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
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

    def get_request_keys(self, engine_key: BlockHash) -> Optional[list[BlockHash]]:
        """Resolve an engine key to ALL of its mapped request keys.

        The sharded control plane (cluster/) needs the full fan-out: an
        engine-key evict must reach every owning shard of every mapped
        request key, not just the last one. Default falls back to the
        single-key resolution; backends that store the full list override.
        """
        rk = self.get_request_key(engine_key)
        return None if rk is None else [rk]

    def add_mappings(
        self, mappings: dict[BlockHash, list[BlockHash]]
    ) -> None:
        """Learn engine→request mappings without storing any pod entries.

        The sharded ingestion filter (cluster.sharded_index) keeps the full
        mapping table on every shard (mappings are small ints; chained
        parent resolution must never dead-end) while entries are stored
        only on owning shards. Default routes through ``restore_state``,
        which every snapshot-capable backend already implements.
        """
        if mappings:
            self.restore_state({
                "entries": [],
                "mappings": [[ek, list(rks)] for ek, rks in mappings.items()],
            })

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

    # -- snapshot capability ------------------------------------------------

    def dump_state(self) -> Optional[dict]:
        """Serialize the index contents for a crash-recovery snapshot.

        Returns ``{"entries": [[request_key, [[pod, tier, flags,
        group_idx], ...]], ...], "mappings": [[engine_key, [request_key,
        ...]], ...]}`` — plain ints/strings/lists, directly
        canonical-CBOR-encodable. ``flags`` packs bit0=speculative,
        bit1=has_group (the native backend's wire layout).

        Returns ``None`` for backends without snapshot support — e.g. the
        Redis/Valkey backend, which is already durable on its own.
        """
        return None

    def restore_state(self, state: dict) -> int:
        """Load a :meth:`dump_state` document; returns entries restored.

        Restored state is soft: live events layered on top converge it,
        so a restore into a non-empty index is additive, not destructive.
        Backends without snapshot support return 0.
        """
        return 0


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


@dataclass
class IndexConfig:
    """Backend selection config (reference ``index.go:29-57``).

    Priority when several are set: cost-aware > native > redis > in-memory
    (Valkey rides the redis backend: same wire).
    """

    in_memory_config: Optional["InMemoryIndexConfig"] = None  # noqa: F821
    cost_aware_memory_config: Optional["CostAwareMemoryIndexConfig"] = None  # noqa: F821
    redis_config: Optional[dict] = None
    # Native C++ index (csrc/kvindex): the high-throughput in-process
    # backend; same contract, GIL-free hot paths.
    native_config: Optional["NativeIndexConfig"] = None  # noqa: F821
    enable_metrics: bool = False
    # Wrap the backend with spans per operation (child spans under
    # score_tokens). Off by default: even no-op span managers cost on the
    # lookup hot path.
    enable_tracing: bool = False
    metrics_logging_interval_s: float = 0.0
    # Wrap a remote backend (Redis/Valkey) in a FailoverIndex: ops run
    # under retry + circuit breaker, and trip to a warm in-memory replica
    # while the primary is down. No-op for in-process backends.
    failover_to_memory: bool = False

    @classmethod
    def default(cls) -> "IndexConfig":
        """Default backend: the native C++ index. Its library is built at
        first use; a failed build raises from ``create_index`` (there is no
        quiet fall back to the Python index)."""
        from .native import NativeIndexConfig

        return cls(native_config=NativeIndexConfig())


def create_index(cfg: Optional[IndexConfig] = None) -> Index:
    """Create an index backend per config priority (``index.go:60-106``)."""
    from .in_memory import InMemoryIndex, InMemoryIndexConfig

    if cfg is None:
        cfg = IndexConfig.default()

    idx: Index
    if cfg.cost_aware_memory_config is not None:
        from .cost_aware import CostAwareMemoryIndex

        idx = CostAwareMemoryIndex(cfg.cost_aware_memory_config)
    elif cfg.native_config is not None:
        from .native import NativeIndex

        idx = NativeIndex(cfg.native_config)
    elif cfg.redis_config is not None:
        from .redis_index import RedisIndex

        idx = RedisIndex(cfg.redis_config)
        if cfg.failover_to_memory:
            from ..resilience.failover import FailoverIndex

            idx = FailoverIndex(idx, InMemoryIndex(InMemoryIndexConfig()))
    elif cfg.in_memory_config is not None:
        idx = InMemoryIndex(cfg.in_memory_config)
    else:
        idx = InMemoryIndex(InMemoryIndexConfig())

    if cfg.enable_metrics:
        from .instrumented import InstrumentedIndex

        idx = InstrumentedIndex(idx)
        if cfg.metrics_logging_interval_s > 0:
            from ..metrics.collector import start_metrics_logging

            start_metrics_logging(cfg.metrics_logging_interval_s)

    if cfg.enable_tracing:
        from .instrumented import TracedIndex

        idx = TracedIndex(idx)

    return idx
