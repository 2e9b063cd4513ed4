"""Metric families of the ported serving path.

Port of the slice of ``llmd_kv_cache_tpu/metrics/collector.py`` that the
port's modules record: each family keeps the JAX package's name, type,
help text and label names, on the in-repo registry (``metrics.registry``)
whose text exposition is the ``prometheus_client`` one. The families of
modules not yet ported (the index families, event ingestion and lag,
native score, shared memory, the shard router, snapshots and recovery,
hedging, fencing and leases, divergence audits, the sampling profiler, the
cache-ledger bridge, exported spans) wait for them (ROADMAP A.8).

``BucketHistogram`` is the JAX package's histogram with buckets chosen at
construction (TTFT/ITL/TPOT resolution depends on the deployment), a
percentile readback and a last-exemplar per bucket; every instance made by
:func:`bucket_histogram` is exposed as a histogram family.
"""

from __future__ import annotations

import time
from bisect import bisect_left
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .registry import REGISTRY, Counter, CustomCollector, Gauge, Histogram, MetricFamily

logger = get_logger("metrics")

_NS = "kvcache_index"

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
    no ``_created``)."""
    with _bucket_hist_lock:
        hists = list(_BUCKET_HISTOGRAMS.values())
    for h in hists:
        snap = h.snapshot()
        samples = [(h.name + "_bucket", {"le": le}, cum)
                   for le, cum in snap["buckets"].items()]
        samples.append((h.name + "_count", {}, snap["count"]))
        samples.append((h.name + "_sum", {}, snap["sum"]))
        yield MetricFamily(h.name, "histogram", h.documentation, samples)


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


def sample_values(names: Iterable[str]) -> Dict[Tuple[str, Tuple], float]:
    """``{(sample name, sorted labels): value}`` of every sample of the
    named families (tests and ``chip_smoke.py`` take deltas of it)."""
    wanted = set(names)
    out = {}
    for fam in REGISTRY.collect():
        if fam.name in wanted:
            for name, labels, value in fam.samples:
                out[(name, tuple(sorted(labels.items())))] = value
    return out
