"""Metric families of the ported serving path.

Port of the slice of ``llmd_kv_cache_tpu/metrics/collector.py`` that the
port's modules record: each family keeps the JAX package's name, type,
help text and label names, on the in-repo registry (``metrics.registry``)
whose text exposition is the ``prometheus_client`` one. Since the event
plane's port: event ingestion, zero-copy and shared-memory ingest, lag,
sequence gaps, queue depth, index staleness, dropped events and the
reconcile families; since the index plane's: the index families (recorded
by ``index.instrumented.InstrumentedIndex``), the native chunked-score
families and the periodic metrics beat; since the services': the
tokenization latency and the cache-ledger bridge
(``register_cache_ledger``); since the cluster plane's: the shard router's
fan-out, RPC, degraded-lookup, ring, plan-cache and batch-RPC families,
hedging, and the fence, lease and topology-epoch families; since the
recovery plane's: snapshots, warm restart, drain and the divergence audit.
The families of modules not yet ported (the sampling profiler, exported
spans) wait for them (ROADMAP A.8.6).

``BucketHistogram`` is the JAX package's histogram with buckets chosen at
construction (TTFT/ITL/TPOT resolution depends on the deployment), a
percentile readback and a last-exemplar per bucket; every instance made by
:func:`bucket_histogram` is exposed as a histogram family.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .registry import REGISTRY, Counter, CustomCollector, Gauge, Histogram, MetricFamily

logger = get_logger("metrics")

_NS = "kvcache_index"

INDEX_ADMISSIONS = Counter(f"{_NS}_admissions_total", "Block keys admitted to the index")
INDEX_EVICTIONS = Counter(f"{_NS}_evictions_total", "Block keys evicted from the index")
INDEX_LOOKUP_REQUESTS = Counter(f"{_NS}_lookup_requests_total", "Index lookups served")
INDEX_LOOKUP_HITS = Counter(f"{_NS}_lookup_hits_total", "Block keys found during lookups")
# Accumulates the best per-pod hit count of each lookup, matching the
# reference's counter semantics (collector.go:43-44). Hits are counted at
# any position, not only the consecutive prefix.
INDEX_MAX_POD_HIT_COUNT = Counter(
    f"{_NS}_max_pod_hit_count",
    "Sum over lookups of the highest per-pod block hit count (any position)",
)
INDEX_LOOKUP_LATENCY = Histogram(
    f"{_NS}_lookup_latency_seconds",
    "Index lookup latency",
    buckets=(1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0),
)

# Score-path prefix-key cache (docs/architecture.md "Score-path
# performance").
PREFIX_CACHE_HIT_BLOCKS = Counter(
    f"{_NS}_prefix_cache_hit_blocks_total",
    "Block keys served from the token-processor prefix cache",
)
PREFIX_CACHE_MISS_BLOCKS = Counter(
    f"{_NS}_prefix_cache_miss_blocks_total",
    "Block keys hashed because the prefix cache had no covering prefix",
)


def record_prefix_cache_delta(hit_blocks: int, miss_blocks: int) -> None:
    if hit_blocks > 0:
        PREFIX_CACHE_HIT_BLOCKS.inc(hit_blocks)
    if miss_blocks > 0:
        PREFIX_CACHE_MISS_BLOCKS.inc(miss_blocks)


# Batched event ingestion (docs/architecture.md "Score-path performance").
EVENT_INGEST_BATCHES = Counter(
    "kvcache_event_ingest_batches_total",
    "Worker drain batches processed by the event pool",
)
EVENT_INGEST_MESSAGES = Counter(
    "kvcache_event_ingest_messages_total",
    "Raw event messages ingested by the event pool",
)
EVENT_INGEST_COALESCED_OPS = Counter(
    "kvcache_event_ingest_coalesced_ops_total",
    "Index write calls saved by coalescing consecutive same-pod digests",
)


def record_ingest_batch(messages: int, coalesced_ops: int) -> None:
    EVENT_INGEST_BATCHES.inc()
    if messages > 0:
        EVENT_INGEST_MESSAGES.inc(messages)
    if coalesced_ops > 0:
        EVENT_INGEST_COALESCED_OPS.inc(coalesced_ops)


# Native data-plane ingest (docs/architecture.md "Native data plane"):
# packed batches decoded as views over the received buffer, and messages
# that arrived over the shared-memory ring instead of the socket wire.
INGEST_ZEROCOPY_BATCHES = Counter(
    "kvtpu_ingest_zerocopy_batches_total",
    "Packed event batches decoded as memoryview-sliced key arrays "
    "(no per-key Python objects) and fed straight to the index",
)
INGEST_SHM_MESSAGES = Counter(
    "kvtpu_ingest_shm_messages_total",
    "Event messages consumed from the same-host shared-memory ring",
)


NATIVE_SCORE_CHUNKS = Counter(
    "kvtpu_native_score_chunks_total",
    "Chunks scanned by the fused native chunked-score path",
)
NATIVE_SCORE_EARLY_EXITS = Counter(
    "kvtpu_native_score_early_exits_total",
    "Fused native chunked scores that stopped before the last key "
    "(prefix chain broke mid-prompt)",
)


SHARD_BATCH_RPCS = Counter(
    "kvtpu_shard_batch_rpcs_total",
    "Framed multi-chunk LookupBlocks fan-out RPCs by outcome "
    "(batched = native frame, fallback = legacy per-chunk replay)",
    ["outcome"],
)


def record_native_score(chunks: int, early_exited: int) -> None:
    if chunks > 0:
        NATIVE_SCORE_CHUNKS.inc(chunks)
    if early_exited:
        NATIVE_SCORE_EARLY_EXITS.inc()


def record_batch_rpc(outcome: str) -> None:
    SHARD_BATCH_RPCS.labels(outcome).inc()


def record_zerocopy_batch(shm: bool = False) -> None:
    INGEST_ZEROCOPY_BATCHES.inc()
    if shm:
        INGEST_SHM_MESSAGES.inc()


def record_shm_messages(count: int) -> None:
    if count > 0:
        INGEST_SHM_MESSAGES.inc(count)


# Event-pipeline lag and staleness: publish→ingest delay (the engine's
# batch timestamp against the ingest clock; cross-host skew leaks in) and
# per-pod sequence gaps (messages provably lost on the PUB/SUB hop).
EVENT_LAG = Histogram(
    "kvcache_event_lag_seconds",
    "Publish-timestamp to ingest delay of event batches",
    buckets=(1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0, 30.0),
)
EVENT_POD_LAG = Gauge(
    "kvcache_event_pod_lag_seconds",
    "Most recent publish-to-ingest delay per pod",
    ["pod"],
)
EVENT_SEQ_GAPS = Counter(
    "kvcache_event_seq_gaps_total",
    "Event messages lost per pod (holes in the per-topic sequence)",
    ["pod"],
)
EVENT_QUEUE_DEPTH = Gauge(
    "kvcache_event_queue_depth",
    "Queued raw messages per event-pool shard",
    ["shard"],
)
INDEX_STALENESS = Gauge(
    "kvcache_index_staleness_seconds",
    "Upper-bound age of the index's view of the slowest live pod",
)


def record_event_lag(pod: str, lag_s: float, seq_gap: int) -> None:
    EVENT_LAG.observe(lag_s)
    EVENT_POD_LAG.labels(pod).set(lag_s)
    if seq_gap > 0:
        EVENT_SEQ_GAPS.labels(pod).inc(seq_gap)


TOKENIZATION_LATENCY = Histogram(
    "kvcache_tokenization_latency_seconds",
    "Tokenization / render latency",
    buckets=(1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0),
)


# Bounded shard queues drop the oldest message on overflow; anti-entropy
# reconciliation repairs the holes.
EVENT_DROPPED = Counter(
    "kvcache_event_dropped_events_total",
    "Raw event messages dropped by the bounded shard queues (drop-oldest)",
    ["shard"],
)
RECONCILE_RUNS = Counter(
    "kvcache_recovery_reconcile_runs_total",
    "Anti-entropy digest-exchange rounds",
    ["outcome"],  # clean|divergent
)
RECONCILE_REPAIRED = Counter(
    "kvcache_recovery_reconcile_repaired_total",
    "Index entries repaired by anti-entropy reconciliation",
    ["direction"],  # added|removed
)


DRAIN_SECONDS = Gauge(
    "kvcache_recovery_drain_seconds",
    "Wall time of the last graceful drain",
)
# Snapshots and warm restart (recovery/).
RECOVERY_SNAPSHOTS = Counter(
    "kvcache_recovery_snapshots_total",
    "Index snapshot attempts",
    ["outcome"],  # written|failed
)
RECOVERY_SNAPSHOT_BYTES = Gauge(
    "kvcache_recovery_snapshot_bytes",
    "Size of the most recent index snapshot",
)
RECOVERY_SNAPSHOT_SECONDS = Histogram(
    "kvcache_recovery_snapshot_persist_seconds",
    "Dump + encode + durable-publish time of index snapshots",
    buckets=(1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0),
)
RECOVERY_QUARANTINED = Counter(
    "kvcache_recovery_snapshots_quarantined_total",
    "Snapshots that failed verification and were quarantined",
)
RECOVERY_RESTORED_ENTRIES = Gauge(
    "kvcache_recovery_restored_entries",
    "Index entries restored from the snapshot at the last warm restart",
)
RECOVERY_REPLAYED_RECORDS = Gauge(
    "kvcache_recovery_replayed_records",
    "Journal records replayed at the last warm restart",
)


def record_dropped_events(shard: int, count: int) -> None:
    if count > 0:
        EVENT_DROPPED.labels(str(shard)).inc(count)


def record_snapshot(outcome: str, size_bytes: int, seconds: float) -> None:
    RECOVERY_SNAPSHOTS.labels(outcome).inc()
    if outcome == "written":
        RECOVERY_SNAPSHOT_BYTES.set(size_bytes)
        RECOVERY_SNAPSHOT_SECONDS.observe(max(seconds, 0.0))


def record_snapshot_quarantine() -> None:
    RECOVERY_QUARANTINED.inc()


def record_warm_restart(restored_entries: int, replayed_records: int) -> None:
    RECOVERY_RESTORED_ENTRIES.set(restored_entries)
    RECOVERY_REPLAYED_RECORDS.set(replayed_records)


def record_drain(seconds: float) -> None:
    DRAIN_SECONDS.set(max(seconds, 0.0))


def record_reconcile(added: int, removed: int) -> None:
    RECONCILE_RUNS.labels("divergent" if (added or removed) else "clean").inc()
    if added > 0:
        RECONCILE_REPAIRED.labels("added").inc(added)
    if removed > 0:
        RECONCILE_REPAIRED.labels("removed").inc(removed)


# Offload data-plane metrics, labelled by medium and direction (the
# reference's vllm:kv_offload_{total_bytes,total_time} families).
OFFLOAD_BYTES = Counter(
    "kv_offload_total_bytes",
    "Bytes moved by offload transfers",
    ["medium", "direction"],
)
OFFLOAD_SECONDS = Counter(
    "kv_offload_total_time_seconds",
    "Wall time of completed offload jobs",
    ["medium", "direction"],
)
OFFLOAD_JOBS = Counter(
    "kv_offload_jobs_total",
    "Completed offload jobs",
    ["medium", "direction", "outcome"],  # outcome: success|failure
)
OFFLOAD_SHED_BLOCKS = Counter(
    "kv_offload_shed_blocks_total",
    "Store blocks dropped by write shedding",
    ["medium"],
)

# Admission-to-first-schedule delay (observed at a request's first
# scheduling visit, before any deferred storage restore).
ENGINE_ADMISSION_DELAY = Histogram(
    "kvcache_engine_admission_delay_seconds",
    "enqueue() to first scheduler pick (burst-admission latency; excludes "
    "any deferred storage-restore wait that follows)",
    buckets=(1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0),
)


def record_admission_delay(seconds: float) -> None:
    ENGINE_ADMISSION_DELAY.observe(max(seconds, 0.0))


# I/O pool placement: NUMA pinning and the engaged transfer path.
IO_POOL_NUMA_NODE = Gauge(
    "kv_offload_io_numa_node",
    "Resolved accelerator host NUMA node (-1 = unknown/disabled)",
)
IO_POOL_PINNED_STAGING = Gauge(
    "kv_offload_io_pinned_staging_workers",
    "I/O workers whose staging buffer is mlock'd",
)
IO_POOL_DIRECT_TRANSFERS = Gauge(
    "kv_offload_io_direct_transfers_total",
    "Transfers that took the O_DIRECT staged path",
)


def record_io_pool_placement(engine) -> None:
    """Snapshot a NativeIOEngine's placement/transfer-path gauges."""
    IO_POOL_NUMA_NODE.set(engine.numa_node())
    IO_POOL_PINNED_STAGING.set(engine.pinned_staging_workers())
    IO_POOL_DIRECT_TRANSFERS.set(engine.direct_transfers())


def record_offload_result(medium: str, result) -> None:
    """Record a TransferResult into the offload metric families."""
    direction = "store" if result.is_store else "load"
    outcome = "success" if result.success else "failure"
    OFFLOAD_JOBS.labels(medium, direction, outcome).inc()
    OFFLOAD_BYTES.labels(medium, direction).inc(result.bytes_transferred)
    OFFLOAD_SECONDS.labels(medium, direction).inc(max(result.seconds, 0.0))
    if result.shed_hashes:
        OFFLOAD_SHED_BLOCKS.labels(medium).inc(len(result.shed_hashes))


# --------------------------------------------------------------------------
# BucketHistogram: a histogram with buckets chosen at construction, a
# quantile readback (debug_vars percentiles) and per-bucket exemplars.
# ``observe()`` is allocation-free after construction: one bisect into a
# preallocated bounds tuple plus three stores under a lock.
# --------------------------------------------------------------------------


class BucketHistogram:
    __slots__ = (
        "name",
        "documentation",
        "bounds",
        "_counts",
        "_sum",
        "_count",
        "_exemplars",
        "_lock",
    )

    def __init__(self, name: str, documentation: str, buckets: Sequence[float]):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("BucketHistogram needs at least one bucket bound")
        self.name = name
        self.documentation = documentation
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # per-bucket, +inf last
        self._sum = 0.0
        self._count = 0
        # Per-bucket last exemplar: (trace_id_hex, value, unix_ts) or None.
        self._exemplars: list = [None] * (len(bounds) + 1)
        self._lock = new_lock()

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if trace_id:
                self._exemplars[idx] = (trace_id, float(value), time.time())

    def exemplars(self) -> list:
        """Per-bucket ``(trace_id, value, timestamp) | None``, +Inf last."""
        with self._lock:
            return list(self._exemplars)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from bucket boundaries.

        Linear interpolation inside the containing bucket; the open-ended
        +inf bucket reports its lower bound (the estimate saturates there).
        Returns 0.0 when empty.
        """
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total <= 0:
            return 0.0
        target = max(q, 0.0) * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i == len(self.bounds):  # +inf bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, acc = self._count, self._sum
        cumulative, cum = [], 0
        for c in counts:
            cum += c
            cumulative.append(cum)
        les = [str(b) for b in self.bounds] + ["+Inf"]
        return {
            "count": total,
            "sum": acc,
            "buckets": dict(zip(les, cumulative)),
        }

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0
            self._exemplars = [None] * (len(self.bounds) + 1)


_BUCKET_HISTOGRAMS: Dict[str, BucketHistogram] = {}
_bucket_hist_lock = new_lock()


def _collect_bucket_histograms() -> Iterable[MetricFamily]:
    """Every BucketHistogram as a histogram family (JAX's
    ``HistogramMetricFamily`` shape: buckets by ``le``, then count and sum;
    no ``_created``). A bucket's last trace-id exemplar rides its sample,
    for the OpenMetrics exposition (``/metrics?format=openmetrics``)."""
    with _bucket_hist_lock:
        hists = list(_BUCKET_HISTOGRAMS.values())
    for h in hists:
        snap = h.snapshot()
        exemplars = h.exemplars()
        samples = [(h.name + "_bucket", {"le": le}, cum)
                   for le, cum in snap["buckets"].items()]
        samples.append((h.name + "_count", {}, snap["count"]))
        samples.append((h.name + "_sum", {}, snap["sum"]))
        yield MetricFamily(h.name, "histogram", h.documentation, samples, {
            i: ({"trace_id": ex[0]}, ex[1], ex[2])
            for i, ex in enumerate(exemplars[:len(snap["buckets"])]) if ex is not None})


REGISTRY.register(CustomCollector(_collect_bucket_histograms))


def bucket_histogram(
    name: str, documentation: str, buckets: Sequence[float]
) -> BucketHistogram:
    """Get-or-create a named BucketHistogram on the registry.

    Deduped by name: several engines in one process share the instance
    (the first caller's buckets win), as the JAX package's families are
    process-global.
    """
    with _bucket_hist_lock:
        hist = _BUCKET_HISTOGRAMS.get(name)
        if hist is None:
            hist = BucketHistogram(name, documentation, buckets)
            _BUCKET_HISTOGRAMS[name] = hist
    return hist


# --------------------------------------------------------------------------
# Engine data-plane families (kvtpu_engine_*): KV-pool occupancy, restore
# outcomes, and request lifecycle counters. TTFT/ITL/TPOT and the step
# time are BucketHistograms made by telemetry/engine_telemetry.py.
# --------------------------------------------------------------------------

ENGINE_POOL_FREE_PAGES = Gauge(
    "kvtpu_engine_kv_pool_free_pages",
    "Free pages in the engine KV pool",
    ["group"],
)
ENGINE_POOL_CACHED_BLOCKS = Gauge(
    "kvtpu_engine_kv_pool_cached_blocks",
    "Hashed prefix blocks resident in the engine KV pool",
    ["group"],
)
ENGINE_POOL_ORPHAN_PAGES = Gauge(
    "kvtpu_engine_kv_pool_orphan_pages",
    "Pages held by in-flight requests, not yet hashed into reusable blocks",
    ["group"],
)
ENGINE_POOL_EVICTIONS = Counter(
    "kvtpu_engine_kv_pool_evictions_total",
    "Cached blocks evicted from the engine KV pool to free pages",
    ["group"],
)
ENGINE_RESTORE_JOBS = Counter(
    "kvtpu_engine_restore_jobs_total",
    "Storage-tier KV restore attempts by outcome",
    ["outcome"],  # success|failure|timeout
)
ENGINE_RESTORE_LATENCY = Histogram(
    "kvtpu_engine_restore_latency_seconds",
    "Deferred storage-restore wall time (job start to commit/abandon)",
    buckets=(1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0, 30.0),
)
ENGINE_PREFIX_HIT_BLOCKS = Counter(
    "kvtpu_engine_prefix_hit_blocks_total",
    "HBM-resident prefix blocks reused at request admission",
)
ENGINE_REQUESTS = Counter(
    "kvtpu_engine_requests_total",
    "Requests finished by the engine",
    ["outcome"],  # finished|aborted
)
ENGINE_DECODE_STEPS = Counter(
    "kvtpu_engine_decode_steps_total",
    "Engine step() calls that decoded at least one token",
)
# JAX's help text, naming its profiler; the port's capture is torch.profiler's.
ENGINE_PROFILE_CAPTURES = Counter(
    "kvtpu_engine_profile_captures_total",
    "On-demand jax.profiler captures by outcome",
    ["outcome"],  # success|failure
)
# Padding-waste pair (EngineTelemetry.on_dispatch_tokens).
ENGINE_RAGGED_REAL_TOKENS = Counter(
    "kvtpu_engine_ragged_real_tokens_total",
    "Real (non-padding) tokens dispatched by the engine step path",
    ["group"],
)
ENGINE_RAGGED_PADDED_TOKENS = Counter(
    "kvtpu_engine_ragged_padded_tokens_total",
    "Total padded program tokens dispatched by the engine step path",
    ["group"],
)


def record_engine_restore(outcome: str, seconds: Optional[float] = None) -> None:
    ENGINE_RESTORE_JOBS.labels(outcome).inc()
    if seconds is not None:
        ENGINE_RESTORE_LATENCY.observe(max(seconds, 0.0))


def record_profile_capture(outcome: str) -> None:
    ENGINE_PROFILE_CAPTURES.labels(outcome).inc()


def record_ragged_dispatch(group: str, real: int, padded: int) -> None:
    ENGINE_RAGGED_REAL_TOKENS.labels(group).inc(max(real, 0))
    ENGINE_RAGGED_PADDED_TOKENS.labels(group).inc(max(padded, 0))


# --------------------------------------------------------------------------
# Sharded control-plane families (kvtpu_shard_*): the scatter-gather
# router's fan-out latency, per-shard RPC outcomes, degraded lookups,
# the consistent-hash ring's primary-partition balance, and the ring-plan
# prefix cache (docs/architecture.md "Sharded control plane").
# --------------------------------------------------------------------------

SHARD_FANOUT_LATENCY = Histogram(
    "kvtpu_shard_fanout_latency_seconds",
    "Scatter-gather score latency (keys to merged scores, all shards)",
    buckets=(1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0),
)
SHARD_RPCS = Counter(
    "kvtpu_shard_rpcs_total",
    "LookupBlocks RPCs issued by the router, per shard and outcome",
    ["shard", "outcome"],  # outcome: success|failure|skipped (breaker open)
)
SHARD_DEGRADED_LOOKUPS = Counter(
    "kvtpu_shard_degraded_lookups_total",
    "Score calls that served with at least one unreachable shard",
)
SHARD_RING_PARTITIONS = Gauge(
    "kvtpu_shard_ring_partitions",
    "Primary partitions assigned per shard by the consistent-hash ring",
    ["shard"],
)
SHARD_PLAN_CACHE = Counter(
    "kvtpu_shard_plan_cache_total",
    "Ring-plan prefix-cache lookups by outcome",
    ["outcome"],  # hit|miss
)


def record_shard_fanout(seconds: float) -> None:
    SHARD_FANOUT_LATENCY.observe(max(seconds, 0.0))


def record_shard_rpc(shard: str, outcome: str) -> None:
    SHARD_RPCS.labels(shard, outcome).inc()


def record_shard_degraded_lookup(shards: int) -> None:
    if shards > 0:
        SHARD_DEGRADED_LOOKUPS.inc()


def record_shard_plan_cache(hit: bool) -> None:
    SHARD_PLAN_CACHE.labels("hit" if hit else "miss").inc()


def record_ring_load(load: Dict[str, int]) -> None:
    for shard, partitions in load.items():
        SHARD_RING_PARTITIONS.labels(shard).set(partitions)


# --------------------------------------------------------------------------
# Gray-failure tolerance families (kvtpu_hedge_*, kvtpu_shed_*): hedged
# scatter-gather outcomes and adaptive overload-shed decisions
# (docs/resilience.md "Gray failures, deadlines & overload"). Hedge
# outcomes: issued (hedge RPC sent), win (hedge answered first with fresh
# keys), loss (primary answered first, hedge cancelled), failed (hedge
# itself errored), denied (budget exhausted — no hedge sent). Shed
# outcomes: shed (rejected outright), brownout (served degraded),
# deadline (budget already expired at entry), late (served past its
# deadline, flagged degraded), restore_skip (storage restore skipped for
# deadline, recompute instead).
# --------------------------------------------------------------------------

HEDGE_ATTEMPTS = Counter(
    "kvtpu_hedge_attempts_total",
    "Hedged shard-RPC decisions by shard and outcome",
    ["shard", "outcome"],  # issued|win|loss|failed|denied
)


def record_hedge(shard: str, outcome: str) -> None:
    HEDGE_ATTEMPTS.labels(shard, outcome).inc()


# --------------------------------------------------------------------------
# Overload-shed decisions (kvtpu_shed_*) by site and outcome: shed,
# brownout, deadline, late, restore_skip.
# --------------------------------------------------------------------------

SHED_DECISIONS = Counter(
    "kvtpu_shed_decisions_total",
    "Overload-shed and deadline decisions by site and outcome",
    ["site", "outcome"],  # shed|brownout|deadline|late|restore_skip
)


def record_shed(site: str, outcome: str) -> None:
    SHED_DECISIONS.labels(site, outcome).inc()


# --------------------------------------------------------------------------
# Disaggregated-handoff families (kvtpu_handoff_*), fed by
# offload.handoff.HandoffCoordinator.
# --------------------------------------------------------------------------

HANDOFF_QUEUE_DEPTH = Gauge(
    "kvtpu_handoff_transfer_queue_depth",
    "Active prefill-to-decode handoffs not yet completed or failed",
)
HANDOFF_IN_FLIGHT_JOBS = Gauge(
    "kvtpu_handoff_in_flight_jobs",
    "Handoff store jobs issued to the offload plane and not yet landed",
)
HANDOFF_LATENCY = Histogram(
    "kvtpu_handoff_latency_seconds",
    "Prefill-begin to decode-resident handoff wall time",
    buckets=(1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0, 30.0),
)
HANDOFF_CHUNKS = Counter(
    "kvtpu_handoff_chunks_total",
    "Per-chunk handoff transfer completions by outcome",
    ["outcome"],  # landed|failed
)
HANDOFF_REQUESTS = Counter(
    "kvtpu_handoff_requests_total",
    "Handoff requests by terminal outcome",
    ["outcome"],  # complete|failed|timeout|fallback
)


def record_handoff_gauges(queue_depth: int, in_flight_jobs: int) -> None:
    HANDOFF_QUEUE_DEPTH.set(max(queue_depth, 0))
    HANDOFF_IN_FLIGHT_JOBS.set(max(in_flight_jobs, 0))


def record_handoff_chunk(outcome: str) -> None:
    HANDOFF_CHUNKS.labels(outcome).inc()


def record_handoff_request(outcome: str, seconds: Optional[float] = None) -> None:
    HANDOFF_REQUESTS.labels(outcome).inc()
    if seconds is not None:
        HANDOFF_LATENCY.observe(max(seconds, 0.0))


# Local span-export health: the ring exporter (telemetry/tracing.py) evicts
# its oldest span once full and counts each eviction here.
TRACE_DROPPED_SPANS = Counter(
    "kvtpu_trace_dropped_spans_total",
    "Finished spans evicted from the in-memory ring exporter before export",
)

# Per-tier restore latency: the engine's restore paths label each restore
# with the offload medium (SHARED_STORAGE, OBJECT_STORE).
OFFLOAD_RESTORE_SECONDS = Histogram(
    "kvtpu_offload_restore_seconds",
    "Storage-tier KV restore wall time per tier (sync + deferred paths)",
    ["tier"],
    buckets=(1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 5.0, 30.0),
)


def record_offload_restore(tier: str, seconds: float) -> None:
    OFFLOAD_RESTORE_SECONDS.labels(tier or "unknown").observe(max(seconds, 0.0))


# Working-set analytics (kvtpu_workingset_*, telemetry/workingset.py): the
# sampler's self-measured cost ledger and the tracked-key budget.
WORKINGSET_SAMPLED_TOTAL = Counter(
    "kvtpu_workingset_sampled_accesses_total",
    "Block accesses that passed the working-set spatial sampling filter",
)
WORKINGSET_OVERHEAD_SECONDS = Counter(
    "kvtpu_workingset_overhead_seconds_total",
    "Wall time spent inside working-set tracker hooks (self-measured)",
)
WORKINGSET_TRACKED_BLOCKS = Gauge(
    "kvtpu_workingset_tracked_blocks",
    "Sampled block keys currently tracked for reuse distances (all scopes)",
)
WORKINGSET_WINDOWS_DROPPED = Counter(
    "kvtpu_workingset_windows_dropped_total",
    "Sealed working-set windows evicted before any /debug/workingset pull",
)

# Ground-truth audit plane (kvtpu_audit_*): the AuditJoiner's per-request
# calibration error, attributed by index staleness at score time ("stale"
# vs "fresh"), and routing regret.
AUDIT_JOINED = Counter(
    "kvtpu_audit_joined_total",
    "Prediction/outcome pairs joined by the collector audit leg",
    ["pod"],
)
AUDIT_MISPREDICTED_BLOCKS = Counter(
    "kvtpu_audit_mispredicted_blocks_total",
    "Abs(predicted - realized) hit blocks, attributed by score-time staleness",
    ["pod", "cause"],  # stale|fresh
)
AUDIT_REGRETS = Counter(
    "kvtpu_audit_regret_total",
    "Joined requests where another pod's calibrated prediction beat the "
    "chosen pod's realized hit",
    ["pod"],  # the chosen (losing) pod
)
AUDIT_REGRET_BLOCKS = Counter(
    "kvtpu_audit_regret_blocks_total",
    "Estimated hit blocks forgone to routing regret",
    ["pod"],
)
AUDIT_DROPPED_RECORDS = Counter(
    "kvtpu_audit_dropped_records_total",
    "Audit records evicted from a pod's ring before any /debug/audit pull",
)


def record_audit_join(pod: str, error_blocks: float, cause: str) -> None:
    AUDIT_JOINED.labels(pod).inc()
    if error_blocks > 0:
        AUDIT_MISPREDICTED_BLOCKS.labels(pod, cause).inc(error_blocks)


def record_audit_regret(pod: str, blocks: float) -> None:
    AUDIT_REGRETS.labels(pod).inc()
    if blocks > 0:
        AUDIT_REGRET_BLOCKS.labels(pod).inc(blocks)


def record_audit_dropped(count: int) -> None:
    if count > 0:
        AUDIT_DROPPED_RECORDS.inc(count)


# --------------------------------------------------------------------------
# Epoch-fenced membership plane (kvtpu_fence_* / kvtpu_topology_* /
# kvtpu_lease_*): the fencing-token discipline in cluster.membership.
# Every fence decision that refuses (or would refuse, in warn mode) a
# stale actor's traffic counts here by receiving site and reason; the
# topology-epoch gauge tracks the newest epoch this process has observed
# (minted by the controller, learned by piggyback); the lease families
# track the renewable pod leases that turn "probably dead" into
# "provably fenced".
# --------------------------------------------------------------------------

FENCE_REJECTIONS = Counter(
    "kvtpu_fence_rejections_total",
    "Stale-epoch / lapsed-lease traffic refused (or flagged in warn mode)",
    ["site", "reason"],
)
TOPOLOGY_EPOCH = Gauge(
    "kvtpu_topology_epoch",
    "Newest fleet topology epoch observed by this process",
)
LEASE_ACTIVE = Gauge(
    "kvtpu_lease_active",
    "Pod leases currently within their TTL",
)
LEASE_RENEWALS = Counter(
    "kvtpu_lease_renewals_total",
    "Successful pod lease renewals",
)
LEASE_EXPIRED = Counter(
    "kvtpu_lease_expired_total",
    "Pod leases that lapsed past their TTL (zombie fence armed)",
)
LEASE_READMISSIONS = Counter(
    "kvtpu_lease_readmissions_total",
    "Lapsed pods re-admitted through the warm-restart gate",
)


def record_fence_rejection(site: str, reason: str) -> None:
    FENCE_REJECTIONS.labels(site, reason).inc()


def record_topology_epoch(epoch: int) -> None:
    TOPOLOGY_EPOCH.set(max(int(epoch), 0))


# --------------------------------------------------------------------------
# Cache-efficiency ledger export (kvtpu_cache_ledger_*): the per-pod
# appearance/win/stored/evicted attribution the Indexer already keeps
# (scoring.indexer.CacheEfficiencyLedger), exported as metric families by a
# collector that snapshots the ledger at scrape time — zero cost on the
# score/ingest hot paths, and the /metrics view stays consistent with the
# /debug/vars ledger snapshot.
# --------------------------------------------------------------------------


class _CacheLedgerCollector:
    """Scrape-time bridge from a CacheEfficiencyLedger to /metrics."""

    FAMILIES = (
        ("kvtpu_cache_ledger_appearances_total", "counter",
         "Score results a pod appeared in (cache-efficiency ledger)"),
        ("kvtpu_cache_ledger_wins_total", "counter",
         "Score results a pod won (highest score) per the ledger"),
        ("kvtpu_cache_ledger_score_total", "counter",
         "Cumulative weighted prefix score attributed to a pod"),
        ("kvtpu_cache_ledger_stored_blocks", "gauge",
         "Blocks the event stream has stored minus evicted on a pod"),
        ("kvtpu_cache_ledger_evicted_blocks_total", "counter",
         "Blocks the event stream has evicted from a pod"),
    )

    def __init__(self, snapshot_fn):
        self._snapshot = snapshot_fn

    def collect(self) -> Iterable[MetricFamily]:
        try:
            snap = self._snapshot()
        except Exception:  # a broken snapshot drops the families, as in JAX
            logger.debug("cache-ledger snapshot failed", exc_info=True)
            return
        # A counter's family drops ``_total``; its samples keep it.
        families = [MetricFamily(name.removesuffix("_total") if typ == "counter" else name,
                                 typ, doc) for name, typ, doc in self.FAMILIES]
        for pod, st in (snap.get("pods") or {}).items():
            labels = {"pod": pod}
            values = (st.get("appearances", 0), st.get("wins", 0), st.get("score_total", 0.0),
                      st.get("stored_blocks", 0) - st.get("evicted_blocks", 0),
                      st.get("evicted_blocks", 0))
            for fam, (name, _, _), value in zip(families, self.FAMILIES, values):
                fam.samples.append((name, labels, value))
        yield from families


_ledger_collector_lock = new_lock()
_ledger_collector: Optional[_CacheLedgerCollector] = None


def register_cache_ledger(snapshot_fn) -> None:
    """Export a ledger's snapshot() as kvtpu_cache_ledger_* families.

    Process-global and last-writer-wins (one collector instance, its
    snapshot source swapped), as the JAX package's families are
    process-global — registering again never raises.
    """
    global _ledger_collector
    with _ledger_collector_lock:
        if _ledger_collector is None:
            _ledger_collector = _CacheLedgerCollector(snapshot_fn)
            register_now = True
        else:
            _ledger_collector._snapshot = snapshot_fn
            register_now = False
    if register_now:
        REGISTRY.register(_ledger_collector)


def sample_values(names: Iterable[str]) -> Dict[Tuple[str, Tuple], float]:
    """``{(sample name, sorted labels): value}`` of every sample of the
    named families, by their exposed names and without ``_created`` (tests
    and ``chip_smoke.py`` take deltas of it)."""
    wanted = set(names)
    out = {}
    for fam in REGISTRY.collect():
        if (fam.name + "_total" if fam.type == "counter" else fam.name) in wanted:
            for name, labels, value in fam.samples:
                if name != fam.name + "_created":
                    out[(name, tuple(sorted(labels.items())))] = value
    return out


_beat_thread: Optional[threading.Thread] = None
_beat_stop = threading.Event()


def start_metrics_logging(interval_s: float) -> None:
    """Log a periodic one-line metrics beat. Idempotent, daemon thread."""
    global _beat_thread
    if _beat_thread is not None and _beat_thread.is_alive():
        if not _beat_stop.is_set():
            return
        # A stop was requested but the old thread hasn't exited yet; wait it
        # out so the restart below actually takes effect.
        _beat_thread.join()
    _beat_stop.clear()

    def _beat() -> None:
        while not _beat_stop.wait(interval_s):
            logger.info(
                "metrics beat: admissions=%d evictions=%d lookups=%d hits=%d",
                INDEX_ADMISSIONS._only().value,
                INDEX_EVICTIONS._only().value,
                INDEX_LOOKUP_REQUESTS._only().value,
                INDEX_LOOKUP_HITS._only().value,
            )

    _beat_thread = threading.Thread(target=_beat, name="kvtpu-metrics-beat", daemon=True)
    _beat_thread.start()


def stop_metrics_logging() -> None:
    _beat_stop.set()


# Divergence audit (recovery.reconcile.DivergenceAuditor): per pod,
# phantom blocks (indexed, not held: scores overshoot) and ghost blocks
# (held, not indexed: scores undershoot), the checked/divergent counters
# and the age of each episode when it heals.
DIVERGENCE_CHECKED = Counter(
    "kvtpu_index_divergence_checked_total",
    "Divergence-audit pod checks (one per pod per audit round)",
    ["pod"],
)
DIVERGENCE_DIVERGENT = Counter(
    "kvtpu_index_divergence_divergent_total",
    "Audit rounds where a pod's indexed view diverged from ground truth",
    ["pod"],
)
DIVERGENCE_PHANTOM_BLOCKS = Gauge(
    "kvtpu_index_divergence_phantom_blocks",
    "Blocks the index advertises on a pod that the engine lacks",
    ["pod"],
)
DIVERGENCE_GHOST_BLOCKS = Gauge(
    "kvtpu_index_divergence_ghost_blocks",
    "Blocks an engine holds that its pod's index view is missing",
    ["pod"],
)
DIVERGENCE_AGE_SECONDS = Histogram(
    "kvtpu_index_divergence_age_seconds",
    "Duration of a divergence episode at the audit round that saw it heal",
    buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0),
)


def record_divergence_audit(pod: str, divergent: bool,
                            phantom: int, ghost: int) -> None:
    DIVERGENCE_CHECKED.labels(pod).inc()
    if divergent:
        DIVERGENCE_DIVERGENT.labels(pod).inc()
    DIVERGENCE_PHANTOM_BLOCKS.labels(pod).set(max(phantom, 0))
    DIVERGENCE_GHOST_BLOCKS.labels(pod).set(max(ghost, 0))


def record_divergence_healed(age_s: float) -> None:
    DIVERGENCE_AGE_SECONDS.observe(max(age_s, 0.0))
