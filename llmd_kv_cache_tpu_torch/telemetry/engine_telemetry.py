"""Engine data-plane telemetry: request lifecycle, KV-pool gauges, profiler.

Port of ``llmd_kv_cache_tpu/telemetry/engine_telemetry.py``.
``EngineTelemetry`` turns the engine's lifecycle into the three serving
histograms operators watch — TTFT (enqueue to first token), ITL
(inter-token latency), TPOT (time per output token) — plus the step-time
histogram, KV-pool occupancy gauges and per-request flight-recorder
events, without touching the step path's allocation budget.

Design constraints, in order:

- **Allocation-light on the step path.** Hooks mutate a preallocated
  ``_ReqState`` (``__slots__``), observe into :class:`BucketHistogram`
  (one bisect + three stores), and scrape pool gauges only every
  ``pool_gauge_every`` steps. No dicts are built per decode step.
- **Config-driven buckets** (:class:`EngineTelemetryConfig`,
  ``engineTelemetry`` in config files).
- **One trace from score to serve.** The engine itself creates spans
  (gated on a request carrying a ``traceparent``); this module only keeps
  the lifecycle clock.
- **The engine's clock.** Every lifecycle time is read from the clock the
  engine was built with (``MiniEngine(clock=...)``, ``time.monotonic`` by
  default), where the JAX module reads ``time.monotonic`` itself: tests
  drive TTFT and ITL exactly. The engine calls ``on_first_token`` and
  ``on_decode_tokens`` after it has read the tokens to the host, so on the
  card an interval ends after the device work it covers.

``ProfilerCapture`` takes on-demand ``torch.profiler`` captures (CPU and,
with a card, CUDA activities) and writes each as a Chrome trace into
``profile_dir``, where the JAX module takes ``jax.profiler`` xplane
captures (guarded: requires a configured ``profileDir``; one capture at a
time). It runs on the caller's thread, typically one of its own beside the
serving loop: the card's kernels are collected process-wide, the serving
thread's CPU operators are not.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.lockdep import new_lock
from ..metrics import collector
from ..utils.logging import get_logger
from . import flight_recorder as fr
from .tracing import parse_traceparent

logger = get_logger("engine_telemetry")


def trace_id_of(traceparent: Optional[str]) -> Optional[str]:
    """Hex trace id from a W3C traceparent, for histogram exemplars."""
    parsed = parse_traceparent(traceparent)
    return None if parsed is None else f"{parsed[0]:032x}"

# Default bucket bounds span CPU dev loops through accelerator pods; deployments
# with tighter SLOs override them via EngineTelemetryConfig.
DEFAULT_TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
DEFAULT_ITL_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)
DEFAULT_STEP_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5, 1.0,
)

MAX_PROFILE_DURATION_S = 60.0


class ProfileInProgress(RuntimeError):
    """A profiler capture is already running (admin maps this to 409)."""


def _as_buckets(value, default: Tuple[float, ...]) -> Tuple[float, ...]:
    if value is None:
        return default
    return tuple(float(v) for v in value)


@dataclass
class EngineTelemetryConfig:
    """Knobs for the engine observability layer (``engineTelemetry``)."""

    enabled: bool = True
    ttft_buckets: Tuple[float, ...] = DEFAULT_TTFT_BUCKETS
    itl_buckets: Tuple[float, ...] = DEFAULT_ITL_BUCKETS
    tpot_buckets: Tuple[float, ...] = DEFAULT_ITL_BUCKETS
    step_buckets: Tuple[float, ...] = DEFAULT_STEP_BUCKETS
    # Pool gauges are scraped once every N steps: gauge label lookups are
    # ~1us each and a tiny-model CPU decode step is sub-millisecond, so an
    # every-step scrape alone could eat the 1% overhead budget.
    pool_gauge_every: int = 16
    # One flight-recorder record per request phase transition (admit,
    # finish); decode steps never write to the ring.
    flight_records: bool = True
    # Directory for on-demand torch.profiler captures (Chrome traces);
    # empty disables ProfilerCapture.
    profile_dir: str = ""
    # Ring of per-request lifecycle summaries kept for /debug/vars.
    max_finished: int = 64

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "EngineTelemetryConfig":
        if not d:
            return cls()

        def k(camel, snake, default):
            return d.get(camel, d.get(snake, default))

        return cls(
            enabled=bool(k("enabled", "enabled", True)),
            ttft_buckets=_as_buckets(
                k("ttftBuckets", "ttft_buckets", None), DEFAULT_TTFT_BUCKETS),
            itl_buckets=_as_buckets(
                k("itlBuckets", "itl_buckets", None), DEFAULT_ITL_BUCKETS),
            tpot_buckets=_as_buckets(
                k("tpotBuckets", "tpot_buckets", None), DEFAULT_ITL_BUCKETS),
            step_buckets=_as_buckets(
                k("stepBuckets", "step_buckets", None), DEFAULT_STEP_BUCKETS),
            pool_gauge_every=int(k("poolGaugeEvery", "pool_gauge_every", 16)),
            flight_records=bool(k("flightRecords", "flight_records", True)),
            profile_dir=str(k("profileDir", "profile_dir", "")),
            max_finished=int(k("maxFinished", "max_finished", 64)),
        )


class _ReqState:
    """Per-request lifecycle clock. Preallocated; mutated in place."""

    __slots__ = (
        "request_id", "traceparent", "enqueue_ts", "admit_ts",
        "first_token_ts", "last_token_ts", "tokens", "prefix_hit_blocks",
    )

    def __init__(self, request_id: str, now: float, prefix_hit_blocks: int,
                 traceparent: Optional[str]):
        self.request_id = request_id
        self.traceparent = traceparent
        self.enqueue_ts = now
        self.admit_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None
        self.tokens = 0
        self.prefix_hit_blocks = prefix_hit_blocks

    def summary(self, finish_ts: float, outcome: str) -> dict:
        return {
            "request_id": self.request_id,
            "enqueue_ts": self.enqueue_ts,
            "admit_ts": self.admit_ts,
            "first_token_ts": self.first_token_ts,
            "last_token_ts": self.last_token_ts,
            "finish_ts": finish_ts,
            "tokens": self.tokens,
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "traced": self.traceparent is not None,
            "outcome": outcome,
        }


class ProfilerCapture:
    """On-demand ``torch.profiler`` capture into a Chrome trace, one at a
    time."""

    def __init__(self, profile_dir: str):
        self.profile_dir = profile_dir
        self._lock = new_lock()
        self.last: Optional[dict] = None

    def capture(self, duration_s: float = 1.0) -> dict:
        """Run a blocking capture; returns ``{"dir", "trace", "duration_s",
        ...}`` (``trace`` is the Chrome trace's path).

        Raises ``ValueError`` on a bad duration, :class:`ProfileInProgress`
        when a capture is already running, and ``RuntimeError`` when there
        is no ``profile_dir`` or the profiler refuses (PyTorch allows one
        profiling session a process).
        """
        duration_s = float(duration_s)
        if not (0.0 < duration_s <= MAX_PROFILE_DURATION_S):
            raise ValueError(
                f"duration_s must be in (0, {MAX_PROFILE_DURATION_S}], "
                f"got {duration_s}")
        if not self.profile_dir:
            raise RuntimeError("profiler capture disabled: no profileDir configured")
        if not self._lock.acquire(blocking=False):
            raise ProfileInProgress("a profiler capture is already running")
        try:
            import torch  # deferred: the telemetry modules import without it
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.profile_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            started = time.time()
            with profile(activities=activities) as prof:
                time.sleep(duration_s)
            trace = os.path.join(
                self.profile_dir,
                f"torch-trace-{os.getpid()}-{int(started * 1e3)}.json")
            prof.export_chrome_trace(trace)
        except Exception as exc:
            collector.record_profile_capture("failure")
            fr.record(fr.KIND_PROFILE, {"outcome": "failure", "error": str(exc)})
            raise RuntimeError(f"torch.profiler capture failed: {exc}") from exc
        finally:
            self._lock.release()
        self.last = {
            "dir": self.profile_dir,
            "trace": trace,
            "duration_s": duration_s,
            "started_ts": started,
            "completed_ts": time.time(),
        }
        collector.record_profile_capture("success")
        fr.record(fr.KIND_PROFILE, {"outcome": "success", "dir": self.profile_dir,
                                    "duration_s": duration_s})
        return dict(self.last)


class EngineTelemetry:
    """Request-lifecycle + KV-pool telemetry for one ``MiniEngine``.

    Histograms are process-global (deduped by metric name), so several
    engines in one process aggregate into the same families; per-request
    state is per-instance. The engine calls the ``on_*`` hooks; everything
    else (admin endpoint, kvdiag) reads :meth:`debug_vars`.
    """

    def __init__(self, config: Optional[EngineTelemetryConfig] = None,
                 group: str = "0", clock: Callable[[], float] = time.monotonic):
        self.cfg = config or EngineTelemetryConfig()
        self.group = str(group)
        self._clock = clock
        self.ttft = collector.bucket_histogram(
            "kvtpu_engine_ttft_seconds",
            "Time from enqueue to first output token",
            self.cfg.ttft_buckets)
        self.itl = collector.bucket_histogram(
            "kvtpu_engine_itl_seconds",
            "Inter-token latency between decode emissions",
            self.cfg.itl_buckets)
        self.tpot = collector.bucket_histogram(
            "kvtpu_engine_tpot_seconds",
            "Time per output token after the first",
            self.cfg.tpot_buckets)
        self.step_seconds = collector.bucket_histogram(
            "kvtpu_engine_decode_step_seconds",
            "Engine step() wall time",
            self.cfg.step_buckets)
        self._requests: Dict[str, _ReqState] = {}
        self.finished: deque = deque(maxlen=max(1, self.cfg.max_finished))
        self._step_counter = 0
        self._pool_stats: Dict[str, dict] = {}
        self._pool_evictions_seen: Dict[str, int] = {}
        self.profiler = ProfilerCapture(self.cfg.profile_dir)
        # Label children resolved once; labels() does a dict lookup + tuple
        # build per call, which the scrape path should not pay repeatedly.
        self._gauge_cache: Dict[str, tuple] = {}
        # Padding-waste accumulators (on_dispatch_tokens): real vs padded
        # tokens per device dispatch, fed by the ragged path AND the
        # padded fallback so the waste ratio compares the schedulers.
        self._dispatch_real = 0
        self._dispatch_padded = 0
        self._dispatches = 0
        self._last_waste_ratio = 0.0

    # -- lifecycle hooks (called by MiniEngine) ---------------------------

    def on_admitted(self, request_id: str, prefix_hit_blocks: int,
                    traceparent: Optional[str] = None) -> None:
        now = self._clock()
        self._requests[request_id] = _ReqState(
            request_id, now, prefix_hit_blocks, traceparent)
        if prefix_hit_blocks > 0:
            collector.ENGINE_PREFIX_HIT_BLOCKS.inc(prefix_hit_blocks)
        if self.cfg.flight_records:
            fr.record(fr.KIND_ENGINE_REQUEST, {
                "request_id": request_id, "phase": "admit",
                "prefix_hit_blocks": prefix_hit_blocks})

    def set_traceparent(self, request_id: str, traceparent: Optional[str]) -> None:
        st = self._requests.get(request_id)
        if st is not None:
            st.traceparent = traceparent

    def on_first_schedule(self, request_id: str) -> None:
        st = self._requests.get(request_id)
        if st is not None and st.admit_ts is None:
            st.admit_ts = self._clock()

    def on_first_token(self, request_id: str) -> None:
        st = self._requests.get(request_id)
        if st is None:
            return
        now = self._clock()
        st.first_token_ts = now
        st.last_token_ts = now
        st.tokens = 1
        if st.admit_ts is None:  # synchronous add_request path
            st.admit_ts = st.enqueue_ts
        # The trace-id exemplar links a slow TTFT bucket straight to the
        # retained trace in the fleet collector (OpenMetrics exposition).
        self.ttft.observe(now - st.enqueue_ts,
                          trace_id=trace_id_of(st.traceparent))

    def on_decode_tokens(self, request_id: str, n: int, now: float) -> None:
        st = self._requests.get(request_id)
        if st is None or n <= 0:
            return
        last = st.last_token_ts
        if last is None:  # decode before a recorded first token: treat as first
            st.first_token_ts = now
            st.tokens = n
            st.last_token_ts = now
            return
        gap = (now - last) / n
        observe = self.itl.observe
        for _ in range(n):
            observe(gap)
        st.tokens += n
        st.last_token_ts = now

    def on_finish(self, request_id: str, outcome: str = "finished") -> None:
        st = self._requests.pop(request_id, None)
        if st is None:
            return
        now = self._clock()
        if st.tokens > 1 and st.first_token_ts is not None \
                and st.last_token_ts is not None:
            self.tpot.observe(
                (st.last_token_ts - st.first_token_ts) / (st.tokens - 1))
        collector.ENGINE_REQUESTS.labels(outcome).inc()
        summary = st.summary(now, outcome)
        self.finished.append(summary)
        if self.cfg.flight_records:
            fr.record(fr.KIND_ENGINE_REQUEST, {
                "request_id": request_id, "phase": "finish",
                "outcome": outcome, "tokens": st.tokens})

    def on_step(self, duration_s: float, decoded: bool,
                pools: Sequence[Tuple[str, Any]] = ()) -> None:
        """Once per engine ``step()``: step timing + decimated pool scrape.

        ``pools`` is ``[(group_name, block_manager), ...]``; each block
        manager answers :meth:`~models.engine.BlockManager.pool_stats`.
        """
        self.step_seconds.observe(duration_s)
        if decoded:
            collector.ENGINE_DECODE_STEPS.inc()
        self._step_counter += 1
        if self._step_counter % max(1, self.cfg.pool_gauge_every) == 0:
            self.scrape_pools(pools)

    def scrape_pools(self, pools: Sequence[Tuple[str, Any]]) -> None:
        for group, bm in pools:
            stats = bm.pool_stats()
            self._pool_stats[group] = stats
            gauges = self._gauge_cache.get(group)
            if gauges is None:
                gauges = (
                    collector.ENGINE_POOL_FREE_PAGES.labels(group),
                    collector.ENGINE_POOL_CACHED_BLOCKS.labels(group),
                    collector.ENGINE_POOL_ORPHAN_PAGES.labels(group),
                )
                self._gauge_cache[group] = gauges
            free_g, cached_g, orphan_g = gauges
            free_g.set(stats["free_pages"])
            cached_g.set(stats["cached_blocks"])
            orphan_g.set(stats["orphan_pages"])
            seen = self._pool_evictions_seen.get(group, 0)
            delta = stats["evictions"] - seen
            if delta > 0:
                collector.ENGINE_POOL_EVICTIONS.labels(group).inc(delta)
                self._pool_evictions_seen[group] = stats["evictions"]

    def on_restore(self, outcome: str, seconds: Optional[float] = None) -> None:
        collector.record_engine_restore(outcome, seconds)

    def on_dispatch_tokens(self, real: int, dispatched: int) -> None:
        """Padding-waste accounting for one device dispatch.

        ``real`` tokens of actual work rode a ``dispatched``-token padded
        program — the gap is pure padding FLOPs. Both the ragged
        single-kernel path and the padded fallback (prefill buckets,
        pad-to-max_batch decode) report here, so the
        ``kvtpu_engine_ragged_*_tokens_total`` counters directly compare
        the two schedulers' waste.
        """
        if dispatched <= 0:
            return
        collector.record_ragged_dispatch(self.group, real, dispatched)
        self._dispatch_real += real
        self._dispatch_padded += dispatched
        self._dispatches += 1
        self._last_waste_ratio = 1.0 - real / dispatched

    # -- read side --------------------------------------------------------

    def _phase_stats(self, hist) -> dict:
        return {
            "count": hist.count,
            "p50": hist.percentile(0.50),
            "p90": hist.percentile(0.90),
            "p99": hist.percentile(0.99),
        }

    def debug_vars(self) -> dict:
        """The ``engine`` section of ``/debug/vars`` (and kvdiag)."""
        return {
            "group": self.group,
            "pool": {g: dict(s) for g, s in self._pool_stats.items()},
            "requests": {
                "active": len(self._requests),
                "finished_window": len(self.finished),
                "recent": list(self.finished)[-8:],
            },
            "phases": {
                "ttft_seconds": self._phase_stats(self.ttft),
                "itl_seconds": self._phase_stats(self.itl),
                "tpot_seconds": self._phase_stats(self.tpot),
                "step_seconds": self._phase_stats(self.step_seconds),
            },
            "steps": self._step_counter,
            "ragged": {
                "real_tokens_total": self._dispatch_real,
                "padded_tokens_total": self._dispatch_padded,
                "last_waste_ratio": self._last_waste_ratio,
                "dispatches": self._dispatches,
            },
            "last_profile": self.profiler.last,
        }

    # attach_admin (the debug provider and the profiler endpoint on the
    # admin server) waits for services/admin.py (ROADMAP A.8).

    def active_requests(self) -> List[str]:
        return list(self._requests)
