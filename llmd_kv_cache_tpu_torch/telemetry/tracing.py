"""OpenTelemetry tracing with a no-op fallback and a built-in recorder.

Copy of ``llmd_kv_cache_tpu/telemetry/tracing.py``. The OpenTelemetry arm
keeps the guarded import: where ``opentelemetry`` is missing (the card's
machine) only the recording and no-op modes exist.

Counterpart of reference ``pkg/telemetry/tracing.go``: spans are attached
unconditionally throughout the read/write paths via a thin facade and no-op
when no provider is configured (``indexer.go:90-103``). ``init_tracing``
configures an OTLP exporter from the standard ``OTEL_*`` env vars when the
optional exporter packages are importable; in library mode the host
process's global provider is used untouched.

Three operating modes, resolved per ``span()`` call in priority order:

1. **recording** — an in-process :class:`InMemorySpanExporter` installed via
   :func:`install_span_exporter`. Spans are plain Python objects with real
   trace/span ids, parentage via ``contextvars`` plus explicit W3C
   ``traceparent`` strings, and land in the exporter on exit. This needs
   only the stdlib, so cross-hop trace assertions work even on images that
   ship ``opentelemetry-api`` without the SDK.
2. **otel** — a real TracerProvider is installed on the global OTel API
   (either by :func:`init_tracing` or by the host process). Attributes are
   passed at span start; exceptions are recorded with ERROR status.
3. **noop** — neither of the above: a shared zero-allocation span that
   accepts ``set_attribute`` chains and costs one identity check per call.

W3C trace-context helpers (:func:`current_traceparent`,
:func:`parse_traceparent`) are the single source of truth for propagation
across the gRPC tokenizer hop and the ZMQ event wire.
"""

from __future__ import annotations

import contextlib
import os
import random
import re
import threading
import time
from collections import deque
from typing import Iterator, Optional

try:
    from opentelemetry import trace as _otel_trace
except Exception:  # pragma: no cover - opentelemetry is optional
    _otel_trace = None

import contextvars

from ..utils.lockdep import new_lock

_SERVICE_NAME = "llmd-kv-cache-tpu"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def format_traceparent(trace_id: int, span_id: int, sampled: bool = True) -> str:
    """Render a W3C ``traceparent`` header value (version 00)."""
    return f"00-{trace_id:032x}-{span_id:016x}-{0x01 if sampled else 0x00:02x}"


def parse_traceparent(value: Optional[str]) -> Optional[tuple[int, int, int]]:
    """Parse ``traceparent`` → ``(trace_id, span_id, flags)``; None if invalid.

    Malformed values are dropped rather than raised: a bad header from a
    remote peer must never break event ingestion or an RPC.
    """
    if not value or not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id = int(m.group(1), 16)
    span_id = int(m.group(2), 16)
    if trace_id == 0 or span_id == 0:
        return None
    return trace_id, span_id, int(m.group(3), 16)


class _NoopSpan:
    """Shared do-nothing span; every mutator chains so call sites can write
    ``span.set_attribute(...).set_attribute(...)`` without mode checks."""

    __slots__ = ()

    def set_attribute(self, *_args, **_kwargs) -> "_NoopSpan":
        return self

    def set_attributes(self, *_args, **_kwargs) -> "_NoopSpan":
        return self

    def add_event(self, *_args, **_kwargs) -> "_NoopSpan":
        return self

    def record_exception(self, *_args, **_kwargs) -> None:
        pass

    def set_status(self, *_args, **_kwargs) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class _NoopSpanCM:
    """Reusable, allocation-free context manager for the no-op path."""

    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return _NOOP_SPAN

    def __exit__(self, *_exc) -> bool:
        return False


_NOOP_CM = _NoopSpanCM()

# Logical process identity ("engine-pod-0", "shard:127.0.0.1:15920",
# "router", ...) stamped onto every exported span that does not already
# carry an explicit ``process`` attribute. The fleet collector attributes
# critical-path segments to these identities; in production each identity
# also maps to a distinct scrape endpoint.
_PROCESS_IDENTITY: Optional[str] = None


def set_process_identity(identity: Optional[str]) -> None:
    """Set (or clear, with None) this process's span attribution identity."""
    global _PROCESS_IDENTITY
    _PROCESS_IDENTITY = identity


def process_identity() -> Optional[str]:
    return _PROCESS_IDENTITY


_dropped_counter = None


def _count_dropped_span() -> None:
    """Bump ``kvtpu_trace_dropped_spans_total`` (lazy: tracing must stay
    importable without the metrics stack, e.g. under kvdiag deep-debug)."""
    global _dropped_counter
    if _dropped_counter is None:
        try:
            from ..metrics.collector import TRACE_DROPPED_SPANS

            _dropped_counter = TRACE_DROPPED_SPANS
        except Exception:  # pragma: no cover - metrics stack absent
            _dropped_counter = False
    if _dropped_counter:
        try:
            _dropped_counter.inc()
        except Exception:  # pragma: no cover  # lint: allow-swallow
            pass


class RecordedSpan:
    """A finished-or-active span in recording mode.

    Mirrors the slice of the OTel Span API the library uses (set_attribute,
    record_exception, set_status) plus the readback fields tests assert on.
    """

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_span_id",
        "attributes",
        "events",
        "status",
        "status_description",
        "start_time",
        "end_time",
        "seq",
    )

    def __init__(
        self,
        name: str,
        trace_id: int,
        span_id: int,
        parent_span_id: Optional[int],
        attributes: Optional[dict] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.attributes = dict(attributes) if attributes else {}
        self.events: list[tuple[str, dict]] = []
        self.status = "UNSET"
        self.status_description: Optional[str] = None
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        # Monotonic export sequence number, stamped by the exporter so
        # remote pullers (/debug/spans?since=seq) can resume a cursor.
        self.seq: Optional[int] = None

    def set_attribute(self, key: str, value) -> "RecordedSpan":
        self.attributes[key] = value
        return self

    def set_attributes(self, attributes: dict) -> "RecordedSpan":
        self.attributes.update(attributes)
        return self

    def add_event(self, name: str, attributes: Optional[dict] = None) -> "RecordedSpan":
        self.events.append((name, attributes or {}))
        return self

    def record_exception(self, exc: BaseException) -> None:
        self.events.append(
            ("exception", {"exception.type": type(exc).__name__, "exception.message": str(exc)})
        )

    def set_status(self, status: str, description: Optional[str] = None) -> None:
        self.status = status
        self.status_description = description

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def to_wire(self) -> dict:
        """JSON-safe dict for span export over ``/debug/spans``.

        Ids travel as hex strings (W3C casing), attribute values are
        coerced to JSON scalars so a numpy int at a span site can never
        break the export path.
        """

        def _scalar(v):
            if isinstance(v, (str, bool)) or v is None:
                return v
            if isinstance(v, (int, float)):
                return v
            try:  # numpy scalars and friends
                return v.item()
            except Exception:
                return str(v)

        return {
            "name": self.name,
            "trace_id": f"{self.trace_id:032x}",
            "span_id": f"{self.span_id:016x}",
            "parent_span_id": (
                None if self.parent_span_id is None else f"{self.parent_span_id:016x}"
            ),
            "start_time": self.start_time,
            "end_time": self.end_time,
            "status": self.status,
            "attributes": {str(k): _scalar(v) for k, v in self.attributes.items()},
            "seq": self.seq,
        }

    @classmethod
    def from_wire(cls, data: dict) -> "RecordedSpan":
        """Inverse of :meth:`to_wire` (collector side)."""
        parent = data.get("parent_span_id")
        sp = cls(
            str(data.get("name", "")),
            int(str(data.get("trace_id", "0")) or "0", 16),
            int(str(data.get("span_id", "0")) or "0", 16),
            None if parent in (None, "") else int(str(parent), 16),
            data.get("attributes") or {},
        )
        sp.start_time = float(data.get("start_time") or 0.0)
        end = data.get("end_time")
        sp.end_time = None if end is None else float(end)
        sp.status = str(data.get("status", "UNSET"))
        sp.seq = data.get("seq")
        return sp

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"RecordedSpan({self.name!r}, trace={self.trace_id:032x}, "
            f"span={self.span_id:016x}, parent="
            f"{'-' if self.parent_span_id is None else format(self.parent_span_id, '016x')})"
        )


class InMemorySpanExporter:
    """Collects finished :class:`RecordedSpan` objects for assembly/export.

    Stand-in for ``opentelemetry.sdk``'s in-memory exporter on images where
    only ``opentelemetry-api`` is installed — and the local buffer behind
    the admin ``/debug/spans?since=seq`` pull endpoint.

    The buffer is a ring: when ``max_spans`` is reached the **oldest** span
    is evicted (previously new spans were silently discarded, which meant a
    long-lived pod stopped tracing entirely once warm). Every eviction is
    counted both locally (:attr:`dropped`) and in the
    ``kvtpu_trace_dropped_spans_total`` counter so the collector can see
    export-loss on a lagging cursor.

    Spans are stamped with a monotonically increasing ``seq`` (and, when
    missing, the process identity) lazily — at pull time under the ring
    lock, not on the per-span export hot path — so :meth:`drain_since`
    lets a remote puller resume from its last cursor while ``export``
    itself stays a bare ring append (gated <1% of score p50 by
    ``bench.py --fleet-telemetry``).
    """

    __slots__ = ("_lock", "_spans", "_max_spans", "_next_seq", "dropped")

    def __init__(self, max_spans: int = 10_000):
        self._lock = new_lock()
        self._spans: deque[RecordedSpan] = deque(maxlen=max(1, int(max_spans)))
        self._max_spans = max(1, int(max_spans))
        self._next_seq = 0
        self.dropped = 0

    def export(self, span: RecordedSpan) -> None:
        # Hot path: runs inline at every span end once fleet span export
        # is on. Everything deferrable (seq + identity stamping, wire
        # encoding) happens at pull time instead.
        spans = self._spans
        with self._lock:
            if len(spans) >= self._max_spans:
                self.dropped += 1
                _count_dropped_span()
            spans.append(span)  # at capacity the deque evicts the oldest

    def _stamp_locked(self) -> None:
        """Assign ``seq`` (and process identity) to not-yet-stamped spans.

        Caller holds ``self._lock``. Spans are stamped newest-backwards
        until the first already-stamped one, so the cost is O(new spans)
        per pull, not O(ring).
        """
        fresh = []
        for span in reversed(self._spans):
            if span.seq is not None:
                break
            fresh.append(span)
        identity = _PROCESS_IDENTITY
        for span in reversed(fresh):
            span.seq = self._next_seq
            self._next_seq += 1
            if identity is not None and "process" not in span.attributes:
                span.attributes["process"] = identity

    @property
    def spans(self) -> list[RecordedSpan]:
        with self._lock:
            return list(self._spans)

    @property
    def next_seq(self) -> int:
        with self._lock:
            self._stamp_locked()
            return self._next_seq

    def drain_since(self, since: int = -1) -> tuple[list[RecordedSpan], int]:
        """Spans with ``seq > since`` (oldest first) and the next cursor.

        Non-destructive: the ring keeps its contents so several pullers
        (or a retried pull) each keep their own cursor; the collector
        dedupes by span id anyway.
        """
        with self._lock:
            self._stamp_locked()
            out = [s for s in self._spans if s.seq is not None and s.seq > since]
            return out, self._next_seq - 1

    def export_since(self, since: int = -1) -> dict:
        """JSON-safe ``/debug/spans`` payload: spans + cursor + drop count."""
        spans, cursor = self.drain_since(since)
        return {
            "spans": [s.to_wire() for s in spans if s.end_time is not None],
            "next_seq": cursor,
            "dropped": self.dropped,
        }

    def find(self, name: str) -> list[RecordedSpan]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


# Ambient current span for recording mode. contextvars gives correct
# nesting per-thread / per-async-task; cross-thread and cross-process hops
# must pass an explicit traceparent (which is what the wire formats do).
_CURRENT_SPAN: contextvars.ContextVar[Optional[RecordedSpan]] = contextvars.ContextVar(
    "kvtpu_current_span", default=None
)

# Cross-thread view of each thread's innermost active span *name*.
# contextvars are only readable from their own thread, but the sampling
# profiler (telemetry/sampling_profiler.py) walks ``sys._current_frames()``
# from a background thread and must attribute each sampled stack to the
# span the sampled thread is inside. A plain dict keyed by thread ident is
# enough: single-key int reads/writes are atomic under the GIL, so the hot
# path stays two dict stores per span (inside the <1% budget that
# ``bench.py --fleet-telemetry`` gates) and the sampler reads without a
# lock — a momentarily stale name only mis-tags one 15 ms sample.
_THREAD_SPAN_NAMES: dict[int, str] = {}


def active_span_names() -> dict[int, str]:
    """Snapshot of thread ident → innermost active span name.

    Read by the sampling profiler; copies so the caller can iterate while
    spans keep opening/closing.
    """
    return dict(_THREAD_SPAN_NAMES)

_recording_exporter: Optional[InMemorySpanExporter] = None


def _new_trace_id() -> int:
    return random.getrandbits(128) or 1


def _new_span_id() -> int:
    return random.getrandbits(64) or 1


def _otel_provider_configured() -> bool:
    """True when a real (recording) TracerProvider is installed globally.

    The api-only default providers live under ``opentelemetry.trace``; any
    real SDK (or host-supplied) provider comes from another module.
    """
    if _otel_trace is None:
        return False
    provider = _otel_trace.get_tracer_provider()
    return not type(provider).__module__.startswith("opentelemetry.trace")


class _Tracer:
    """Thin facade: recording exporter > OTel provider > no-op."""

    def __init__(self) -> None:
        self._otel_tracer = None
        if _otel_trace is not None and _otel_provider_configured():
            self._otel_tracer = _otel_trace.get_tracer(_SERVICE_NAME)

    def span(
        self,
        name: str,
        parent_traceparent: Optional[str] = None,
        **attributes,
    ):
        """Context manager yielding a span.

        ``parent_traceparent`` (a W3C header value) links this span under a
        remote parent — used on the server side of the gRPC hop and by the
        event-pool ingest loop; when omitted the ambient current span (if
        any) is the parent. Remaining kwargs become span attributes, set at
        span start. On exception exit the exception is recorded on the span
        with ERROR status and re-raised.
        """
        if _recording_exporter is not None:
            return self._recording_span(name, parent_traceparent, attributes)
        if self._otel_tracer is not None:
            return self._otel_span(name, parent_traceparent, attributes)
        return _NOOP_CM

    @contextlib.contextmanager
    def _recording_span(
        self, name: str, parent_traceparent: Optional[str], attributes: dict
    ) -> Iterator[RecordedSpan]:
        exporter = _recording_exporter
        trace_id: Optional[int] = None
        parent_id: Optional[int] = None
        parsed = parse_traceparent(parent_traceparent)
        if parsed is not None:
            trace_id, parent_id, _flags = parsed
        else:
            cur = _CURRENT_SPAN.get()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
        if trace_id is None:
            trace_id = _new_trace_id()
        sp = RecordedSpan(name, trace_id, _new_span_id(), parent_id, attributes)
        token = _CURRENT_SPAN.set(sp)
        tid = threading.get_ident()
        prev_name = _THREAD_SPAN_NAMES.get(tid)
        _THREAD_SPAN_NAMES[tid] = name
        try:
            yield sp
        except BaseException as exc:
            sp.record_exception(exc)
            sp.set_status("ERROR", str(exc))
            raise
        finally:
            if prev_name is None:
                _THREAD_SPAN_NAMES.pop(tid, None)
            else:
                _THREAD_SPAN_NAMES[tid] = prev_name
            _CURRENT_SPAN.reset(token)
            sp.end_time = time.time()
            if exporter is not None:
                exporter.export(sp)

    @contextlib.contextmanager
    def _otel_span(
        self, name: str, parent_traceparent: Optional[str], attributes: dict
    ) -> Iterator[object]:
        context = None
        parsed = parse_traceparent(parent_traceparent)
        if parsed is not None:
            trace_id, span_id, flags = parsed
            remote = _otel_trace.SpanContext(
                trace_id=trace_id,
                span_id=span_id,
                is_remote=True,
                trace_flags=_otel_trace.TraceFlags(flags),
            )
            context = _otel_trace.set_span_in_context(_otel_trace.NonRecordingSpan(remote))
        tid = threading.get_ident()
        prev_name = _THREAD_SPAN_NAMES.get(tid)
        _THREAD_SPAN_NAMES[tid] = name
        try:
            with self._otel_tracer.start_as_current_span(
                name, context=context, attributes=attributes or None, end_on_exit=True
            ) as sp:
                try:
                    yield sp
                except BaseException as exc:
                    sp.record_exception(exc)
                    try:
                        from opentelemetry.trace import Status, StatusCode

                        sp.set_status(Status(StatusCode.ERROR, str(exc)))
                    except Exception:  # pragma: no cover - api drift  # lint: allow-swallow
                        pass
                    raise
        finally:
            if prev_name is None:
                _THREAD_SPAN_NAMES.pop(tid, None)
            else:
                _THREAD_SPAN_NAMES[tid] = prev_name


_tracer: Optional[_Tracer] = None


def tracer() -> _Tracer:
    global _tracer
    if _tracer is None:
        _tracer = _Tracer()
    return _tracer


def current_traceparent() -> Optional[str]:
    """The ambient span's W3C ``traceparent``, or None when untraced.

    This is what gets injected into outbound gRPC metadata and onto the
    ZMQ event wire.
    """
    if _recording_exporter is not None:
        cur = _CURRENT_SPAN.get()
        if cur is not None:
            return cur.traceparent
        return None
    if _otel_trace is not None:
        ctx = _otel_trace.get_current_span().get_span_context()
        if ctx is not None and ctx.trace_id != 0 and ctx.span_id != 0:
            return format_traceparent(
                ctx.trace_id, ctx.span_id, bool(int(ctx.trace_flags) & 0x01)
            )
    return None


def install_span_exporter(
    exporter: Optional[InMemorySpanExporter] = None,
) -> InMemorySpanExporter:
    """Switch the facade into recording mode (tests, ``kvdiag`` deep-debug).

    Returns the active exporter (created when not supplied). Call
    :func:`uninstall_span_exporter` to restore the previous mode.
    """
    global _recording_exporter, _tracer
    if exporter is None:
        exporter = InMemorySpanExporter()
    _recording_exporter = exporter
    _tracer = None  # rebuild so mode resolution sees the exporter
    return exporter


def uninstall_span_exporter() -> None:
    global _recording_exporter, _tracer
    _recording_exporter = None
    _tracer = None


def active_span_exporter() -> Optional[InMemorySpanExporter]:
    """The currently installed recording exporter, if any (fleet wiring
    reuses an already-installed exporter instead of replacing it)."""
    return _recording_exporter


@contextlib.contextmanager
def recording_tracing(
    exporter: Optional[InMemorySpanExporter] = None,
) -> Iterator[InMemorySpanExporter]:
    """Scoped :func:`install_span_exporter` — the test-fixture form."""
    installed = install_span_exporter(exporter)
    try:
        yield installed
    finally:
        uninstall_span_exporter()


def init_tracing(service_name: Optional[str] = None) -> bool:
    """Standalone-mode init from OTEL_* env (reference tracing.go:72-141).

    Returns True when an OTLP exporter was installed; False when running in
    library mode (host provider reused) or exporters are unavailable.
    """
    global _tracer
    if _otel_trace is None:
        return False
    exporter_kind = os.environ.get("OTEL_TRACES_EXPORTER", "otlp")
    if exporter_kind in ("none", ""):
        return False
    try:
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import OTLPSpanExporter
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
        from opentelemetry.sdk.trace.sampling import ParentBasedTraceIdRatio
    except Exception:
        return False

    endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", "http://localhost:4317")
    ratio = float(os.environ.get("OTEL_TRACES_SAMPLER_ARG", "0.1"))
    provider = TracerProvider(
        resource=Resource.create(
            {"service.name": os.environ.get("OTEL_SERVICE_NAME", service_name or _SERVICE_NAME)}
        ),
        sampler=ParentBasedTraceIdRatio(ratio),
    )
    provider.add_span_processor(BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint)))
    _otel_trace.set_tracer_provider(provider)
    _tracer = None  # rebuild against the new provider
    return True
