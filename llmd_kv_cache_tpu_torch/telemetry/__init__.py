"""Tracing, the flight recorder, engine telemetry, audit and working-set
analytics (port of ``llmd_kv_cache_tpu/telemetry``).

Ported: ``tracing``, ``flight_recorder``, ``engine_telemetry`` (its
profiler on ``torch.profiler``), ``audit`` and ``workingset``. The fleet
modules (``fleet``, ``rollup``, ``slo``, ``anomaly``, ``incident``) and the
sampling profiler wait for the services they serve (ROADMAP A.8).
"""

from .engine_telemetry import (
    EngineTelemetry,
    EngineTelemetryConfig,
    ProfileInProgress,
    ProfilerCapture,
)
from .flight_recorder import (
    FlightRecorder,
    attach_failpoint_listener,
    flight_recorder,
    install_signal_dump,
    set_flight_recorder,
)
from .audit import AuditJoiner, AuditLog
from .workingset import (
    WorkingSetConfig,
    WorkingSetTracker,
    active_workingset_tracker,
    estimate_hit_ratio,
    install_workingset_tracker,
    merge_workingset_windows,
    uninstall_workingset_tracker,
    whatif_table,
)
from .tracing import (
    InMemorySpanExporter,
    RecordedSpan,
    active_span_exporter,
    active_span_names,
    current_traceparent,
    format_traceparent,
    init_tracing,
    install_span_exporter,
    parse_traceparent,
    process_identity,
    recording_tracing,
    set_process_identity,
    tracer,
    uninstall_span_exporter,
)

__all__ = [
    "AuditJoiner",
    "AuditLog",
    "EngineTelemetry",
    "EngineTelemetryConfig",
    "FlightRecorder",
    "InMemorySpanExporter",
    "ProfileInProgress",
    "ProfilerCapture",
    "RecordedSpan",
    "WorkingSetConfig",
    "WorkingSetTracker",
    "active_span_exporter",
    "active_span_names",
    "active_workingset_tracker",
    "attach_failpoint_listener",
    "current_traceparent",
    "estimate_hit_ratio",
    "flight_recorder",
    "format_traceparent",
    "init_tracing",
    "install_signal_dump",
    "install_span_exporter",
    "install_workingset_tracker",
    "merge_workingset_windows",
    "parse_traceparent",
    "process_identity",
    "recording_tracing",
    "set_flight_recorder",
    "set_process_identity",
    "tracer",
    "uninstall_span_exporter",
    "uninstall_workingset_tracker",
    "whatif_table",
]
