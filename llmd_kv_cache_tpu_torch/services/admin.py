"""Stdlib HTTP admin/debug endpoint: /metrics, /healthz, /debug/*.

Port of ``llmd_kv_cache_tpu/services/admin.py``: the indexer sidecar's and
an engine pod's "open the pod and look" surface. Serves:

- ``/metrics``   — the process's registry (``metrics.registry``) in the
  Prometheus text format; ``?format=openmetrics`` switches to OpenMetrics,
  the only text format that renders exemplars (trace-id links on
  ``BucketHistogram`` buckets)
- ``/healthz``   — liveness probe (200 + ``{"status": "ok"}``, or a
  registered health provider's payload, 503 unless its status is ok)
- ``/debug/flight-recorder`` — the in-process flight recorder ring (full
  dump; ``?since=SEQ`` switches to the cursor export: records newer than
  the puller's cursor plus ``next_seq``/``dropped``)
- ``/debug/time`` — wall + monotonic clock echo (always on with the debug
  surface), which a collector brackets between two local clock readings
  to estimate this pod's clock offset
- ``/debug/<name>`` — registered JSON providers (``lag``, ``ledger``,
  ``engine``, …), whatever the owning service wires in
- ``/debug/vars`` — every provider + the flight recorder in one JSON
  document (what ``hack/kvdiag.py`` snapshots)
- ``/debug/profile?duration_s=N`` — an on-demand ``torch.profiler``
  capture (404 unless the owner registered a capture callable via
  :meth:`AdminServer.register_profiler`; one capture at a time → 409; a
  bad duration → 400; any other failure → 500)
- ``/debug/spans``, ``/debug/pyprof``, ``/debug/workingset``,
  ``/debug/slo`` and ``/debug/audit`` (``?since=SEQ`` cursor exports) and
  ``/debug/pyprof/capture?seconds=N`` — registration points: 404 until the
  owner registers a source (``register_spans_source`` and the rest). The
  port's indexer service registers none yet, since their sources come with
  the fleet planes (ROADMAP A.8.6)
- ``POST /debug/<name>`` — guarded mutation endpoints: 404 until the owner
  registers a handler via :meth:`AdminServer.register_action`; parameters
  ride the query string

Deliberately stdlib-only (``http.server``): the endpoint must work in the
most degraded pod imaginable, and on the card's machine, which has no
``prometheus_client``. Disabled by default; the config knobs are
``metricsPort`` (metrics+health only) and ``adminPort`` (adds
``/debug/*``), both 0 = off. Binds localhost by default: the debug surface
exposes pod names and score internals.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Mapping, Optional
from urllib.parse import parse_qs

from ..metrics.registry import (
    CONTENT_TYPE_LATEST,
    OPENMETRICS_CONTENT_TYPE,
    generate_latest,
    generate_openmetrics,
)
from ..telemetry.engine_telemetry import ProfileInProgress
from ..telemetry.flight_recorder import flight_recorder
from ..utils.logging import get_logger

logger = get_logger("services.admin")


class CaptureInProgress(RuntimeError):
    """A burst capture of the sampling profiler is already running (served
    as 409 by ``/debug/pyprof/capture``). The sampling profiler itself
    comes with the fleet planes (ROADMAP A.8.6)."""


class AdminServer:
    """Small threaded HTTP server for observability endpoints.

    ``port=0`` binds an ephemeral port (tests); the *disabled-by-default*
    semantics of the ``metricsPort``/``adminPort`` config knobs live in the
    wiring (IndexerService skips construction when the knob is 0).
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        expose_debug: bool = True,
        health: Optional[Callable[[], dict]] = None,
    ):
        self._host = host
        self._requested_port = port
        self._expose_debug = expose_debug
        self._providers: dict[str, Callable[[], object]] = {}
        self._health = health
        self._profiler: Optional[Callable[[float], dict]] = None
        self._spans_source: Optional[Callable[[int], dict]] = None
        self._pyprof_source: Optional[Callable[[int], dict]] = None
        self._pyprof_capture: Optional[Callable[[float], dict]] = None
        self._workingset_source: Optional[Callable[[int], dict]] = None
        self._slo_source: Optional[Callable[[int], dict]] = None
        self._audit_source: Optional[Callable[[int], dict]] = None
        self._actions: dict[str, Callable[[Mapping[str, str]], dict]] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def register_debug(self, name: str, provider: Callable[[], object]) -> None:
        """Expose ``provider()`` (a JSON-serializable callable) as
        ``/debug/<name>`` and inside ``/debug/vars``."""
        self._providers[name] = provider

    def register_profiler(self, capture: Callable[[float], dict]) -> None:
        """Enable ``/debug/profile``: ``capture(duration_s)`` runs a
        blocking profiler capture and returns a JSON-serializable summary
        (``telemetry.engine_telemetry.ProfilerCapture.capture``). The
        endpoint stays 404 until this is called — an unconfigured pod must
        not let arbitrary HTTP clients spin up the profiler."""
        self._profiler = capture

    def register_spans_source(self, source: Callable[[int], dict]) -> None:
        """Enable ``/debug/spans``: ``source(since_seq)`` returns the
        ring exporter's ``export_since`` payload (spans + cursor + drops).
        Typically ``InMemorySpanExporter.export_since``. 404 until set —
        span export is opt-in per pod (``fleetTelemetry.spanExport``)."""
        self._spans_source = source

    def register_pyprof_source(self, source: Callable[[int], dict]) -> None:
        """Enable ``/debug/pyprof``: ``source(since_seq)`` returns the
        sampling profiler's ``export_since`` payload (sealed folded-stack
        windows + cursor + drops). 404 until set — continuous profiling
        is opt-in per pod (``fleetTelemetry.pyprof``)."""
        self._pyprof_source = source

    def register_workingset_source(
            self, source: Callable[[int], dict]) -> None:
        """Enable ``/debug/workingset``: ``source(since_seq)`` returns the
        working-set tracker's sealed reuse windows with the same cursor
        semantics as ``/debug/spans`` / ``/debug/pyprof``. 404 until
        registered — workingset is opt-in per pod
        (``fleetTelemetry.workingset``)."""
        self._workingset_source = source

    def register_slo_source(self, source: Callable[[int], dict]) -> None:
        """Enable ``/debug/slo?since=``: ``source(since_seq)`` returns the
        SLO registry's ``export_edges_since`` payload (alert fire/clear
        edges + cursor + drops), same cursor semantics as
        ``/debug/spans``. Without a query string the endpoint still falls
        through to a registered plain ``slo`` provider (level state), so
        existing consumers keep working."""
        self._slo_source = source

    def register_audit_source(self, source: Callable[[int], dict]) -> None:
        """Enable ``/debug/audit?since=``: ``source(since_seq)`` returns the
        audit ring's ``export_since`` payload (prediction/outcome records
        + cursor + drops), same cursor semantics as ``/debug/spans``.
        Typically ``telemetry.audit.AuditLog.export_since``. 404 until
        set — the audit plane is opt-in per pod
        (``fleetTelemetry.audit``). Without ``since`` the endpoint falls
        through to a plain registered ``audit`` provider (the collector's
        joined calibration view), mirroring ``/debug/slo``."""
        self._audit_source = source

    def register_action(
            self, name: str,
            handler: Callable[[Mapping[str, str]], dict]) -> None:
        """Enable ``POST /debug/<name>``: ``handler(params)`` receives the
        flattened query parameters and returns a JSON-serializable result.
        POST endpoints are guarded the same way as the profiler: 404 until
        the owning service explicitly registers a handler, so an
        unconfigured pod cannot be mutated over HTTP. ``ValueError`` from
        the handler maps to 400 (bad request), anything else to 500."""
        self._actions[name] = handler

    def register_pyprof_capture(self, capture: Callable[[float], dict]) -> None:
        """Enable ``/debug/pyprof/capture``: ``capture(seconds)`` runs a
        blocking burst capture on the sampling profiler and returns the
        folded profile. 404 until set."""
        self._pyprof_capture = capture

    def set_health_provider(self, provider: Callable[[], dict]) -> None:
        """Make ``/healthz`` report ``provider()`` instead of the static
        ok. A payload whose ``status`` is not ``"ok"`` is served with 503
        so readiness probes gate traffic (e.g. ``warming`` after a warm
        restart, recovery.manager)."""
        self._health = provider

    @property
    def port(self) -> int:
        """The bound port (0 until started)."""
        return self._httpd.server_port if self._httpd is not None else 0

    # -- request handling --------------------------------------------------

    def _metrics_payload(self, fmt: str = "") -> tuple[bytes, str]:
        if fmt == "openmetrics":
            return generate_openmetrics(), OPENMETRICS_CONTENT_TYPE
        return generate_latest(), CONTENT_TYPE_LATEST

    def _handle_spans(self, query: Mapping[str, list]) -> tuple[int, bytes, str]:
        if self._spans_source is None:
            return (404, b'{"error": "span export not configured"}',
                    "application/json")
        raw = query.get("since", ["-1"])[-1]
        try:
            since = int(raw)
        except ValueError:
            return (400, json.dumps(
                {"error": f"bad since: {raw!r}"}).encode(), "application/json")
        try:
            payload = self._spans_source(since)
        except Exception as exc:
            return 500, json.dumps({"error": str(exc)}).encode(), "application/json"
        return (200, json.dumps(payload, default=repr).encode(),
                "application/json")

    def _handle_pyprof(self, query: Mapping[str, list]) -> tuple[int, bytes, str]:
        if self._pyprof_source is None:
            return (404, b'{"error": "sampling profiler not configured"}',
                    "application/json")
        raw = query.get("since", ["-1"])[-1]
        try:
            since = int(raw)
        except ValueError:
            return (400, json.dumps(
                {"error": f"bad since: {raw!r}"}).encode(), "application/json")
        try:
            payload = self._pyprof_source(since)
        except Exception as exc:
            return 500, json.dumps({"error": str(exc)}).encode(), "application/json"
        return (200, json.dumps(payload, default=repr).encode(),
                "application/json")

    def _handle_workingset(
            self, query: Mapping[str, list]) -> tuple[int, bytes, str]:
        if self._workingset_source is None:
            return (404, b'{"error": "workingset tracking not configured"}',
                    "application/json")
        raw = query.get("since", ["-1"])[-1]
        try:
            since = int(raw)
        except ValueError:
            return (400, json.dumps(
                {"error": f"bad since: {raw!r}"}).encode(), "application/json")
        try:
            payload = self._workingset_source(since)
        except Exception as exc:
            return 500, json.dumps({"error": str(exc)}).encode(), "application/json"
        return (200, json.dumps(payload, default=repr).encode(),
                "application/json")

    def _handle_slo(self, query: Mapping[str, list]) -> tuple[int, bytes, str]:
        if self._slo_source is None:
            return (404, b'{"error": "slo edge export not configured"}',
                    "application/json")
        raw = query.get("since", ["-1"])[-1]
        try:
            since = int(raw)
        except ValueError:
            return (400, json.dumps(
                {"error": f"bad since: {raw!r}"}).encode(), "application/json")
        try:
            payload = self._slo_source(since)
        except Exception as exc:
            return 500, json.dumps({"error": str(exc)}).encode(), "application/json"
        return (200, json.dumps(payload, default=repr).encode(),
                "application/json")

    def _handle_audit(self, query: Mapping[str, list]) -> tuple[int, bytes, str]:
        if self._audit_source is None:
            return (404, b'{"error": "audit export not configured"}',
                    "application/json")
        raw = query.get("since", ["-1"])[-1]
        try:
            since = int(raw)
        except ValueError:
            return (400, json.dumps(
                {"error": f"bad since: {raw!r}"}).encode(), "application/json")
        try:
            payload = self._audit_source(since)
        except Exception as exc:
            return 500, json.dumps({"error": str(exc)}).encode(), "application/json"
        return (200, json.dumps(payload, default=repr).encode(),
                "application/json")

    def _handle_pyprof_capture(
            self, query: Mapping[str, list]) -> tuple[int, bytes, str]:
        if self._pyprof_capture is None:
            return (404, b'{"error": "sampling profiler not configured"}',
                    "application/json")
        raw = query.get("seconds", ["1.0"])[-1]
        try:
            seconds = float(raw)
        except ValueError:
            return (400, json.dumps(
                {"error": f"bad seconds: {raw!r}"}).encode(),
                "application/json")
        try:
            summary = self._pyprof_capture(seconds)
        except ValueError as exc:
            return 400, json.dumps({"error": str(exc)}).encode(), "application/json"
        except Exception as exc:
            # CaptureInProgress (a RuntimeError subclass) → 409, matching
            # the profiler endpoint; anything else → 500.
            status = 409 if isinstance(exc, CaptureInProgress) else 500
            return status, json.dumps({"error": str(exc)}).encode(), "application/json"
        return (200, json.dumps(summary, indent=2, default=repr).encode(),
                "application/json")

    def _debug_vars(self) -> dict:
        payload: dict = {
            "flight_recorder": flight_recorder().snapshot(),
        }
        for name, provider in self._providers.items():
            try:
                payload[name] = provider()
            except Exception as exc:
                payload[name] = {"error": str(exc)}
        return payload

    def _handle_profile(self, query: Mapping[str, list]) -> tuple[int, bytes, str]:
        if self._profiler is None:
            return (404, b'{"error": "profiler not configured"}',
                    "application/json")
        raw = query.get("duration_s", ["1.0"])[-1]
        try:
            duration_s = float(raw)
        except ValueError:
            return (400, json.dumps(
                {"error": f"bad duration_s: {raw!r}"}).encode(),
                "application/json")
        try:
            summary = self._profiler(duration_s)
        except ValueError as exc:
            return 400, json.dumps({"error": str(exc)}).encode(), "application/json"
        except Exception as exc:
            # ProfileInProgress (a RuntimeError subclass) → 409; any other
            # capture failure (no profile dir, profiler error) → 500.
            status = 409 if isinstance(exc, ProfileInProgress) else 500
            return status, json.dumps({"error": str(exc)}).encode(), "application/json"
        return (200, json.dumps(summary, indent=2, default=repr).encode(),
                "application/json")

    def _handle(self, path: str,
                query: Optional[Mapping[str, list]] = None) -> tuple[int, bytes, str]:
        """Route one GET; returns (status, body, content_type)."""
        if path == "/healthz":
            if self._health is None:
                return 200, b'{"status": "ok"}', "application/json"
            try:
                payload = self._health()
            except Exception as exc:  # health must answer even when broken
                return (
                    500,
                    json.dumps({"status": "error", "error": str(exc)}).encode(),
                    "application/json",
                )
            status = 200 if payload.get("status") == "ok" else 503
            return status, json.dumps(payload, default=repr).encode(), "application/json"
        if path == "/metrics":
            fmt = (query or {}).get("format", [""])[-1]
            body, ctype = self._metrics_payload(fmt)
            return 200, body, ctype
        if self._expose_debug:
            if path == "/debug/profile":
                return self._handle_profile(query or {})
            if path == "/debug/spans":
                return self._handle_spans(query or {})
            # No local sampler but a registered "pyprof" provider (the
            # collector's fleet-merged view): fall through to the generic
            # /debug/<name> dispatch below instead of 404ing.
            if path == "/debug/pyprof" and (
                    self._pyprof_source is not None
                    or "pyprof" not in self._providers):
                return self._handle_pyprof(query or {})
            if path == "/debug/pyprof/capture":
                return self._handle_pyprof_capture(query or {})
            # Same provider fall-through as pyprof: the collector exposes
            # its *merged* fleet view as a "workingset" debug provider.
            if path == "/debug/workingset" and (
                    self._workingset_source is not None
                    or "workingset" not in self._providers):
                return self._handle_workingset(query or {})
            # /debug/slo serves two shapes: with ?since= (or with no plain
            # "slo" provider) the edge-history cursor payload; otherwise it
            # falls through to the registered level-state provider, so
            # pre-cursor consumers keep working.
            if path == "/debug/slo" and self._slo_source is not None and (
                    "since" in (query or {}) or "slo" not in self._providers):
                return self._handle_slo(query or {})
            # Same dual shape as /debug/slo: with ?since= (or no plain
            # "audit" provider) the cursor record export answers; else the
            # registered provider (the collector's joined view) does. An
            # unconfigured pod 404s either way (collector pulls tolerate).
            if path == "/debug/audit" and (
                    self._audit_source is not None
                    and ("since" in (query or {})
                         or "audit" not in self._providers)
                    or self._audit_source is None
                    and "audit" not in self._providers):
                return self._handle_audit(query or {})
            if path == "/debug/time":
                # Deliberately unguarded (no registration): the echo
                # carries no pod internals and must answer even on a pod
                # nothing else was wired on — skew estimation is most
                # valuable exactly when a pod is misbehaving.
                body = json.dumps({
                    "wall": time.time(),
                    "mono": time.monotonic(),
                    "pid": os.getpid(),
                }).encode("utf-8")
                return 200, body, "application/json"
            if path == "/debug/flight-recorder":
                if "since" in (query or {}):
                    raw = (query or {}).get("since", ["-1"])[-1]
                    try:
                        since = int(raw)
                    except ValueError:
                        return (400, json.dumps(
                            {"error": f"bad since: {raw!r}"}).encode(),
                            "application/json")
                    payload = flight_recorder().export_since(since)
                    return (200, json.dumps(payload, default=repr).encode(),
                            "application/json")
                body = flight_recorder().dump_json(indent=2).encode("utf-8")
                return 200, body, "application/json"
            if path == "/debug/vars":
                body = json.dumps(self._debug_vars(), indent=2, default=repr)
                return 200, body.encode("utf-8"), "application/json"
            if path.startswith("/debug/"):
                name = path[len("/debug/"):]
                provider = self._providers.get(name)
                if provider is not None:
                    try:
                        body = json.dumps(provider(), indent=2, default=repr)
                    except Exception as exc:
                        return 500, json.dumps({"error": str(exc)}).encode(), "application/json"
                    return 200, body.encode("utf-8"), "application/json"
        return 404, b'{"error": "not found"}', "application/json"

    def _handle_post(self, path: str,
                     query: Optional[Mapping[str, list]] = None) -> tuple[int, bytes, str]:
        """Route one POST; only registered /debug/<name> actions exist."""
        if self._expose_debug and path.startswith("/debug/"):
            handler = self._actions.get(path[len("/debug/"):])
            if handler is not None:
                params = {k: v[-1] for k, v in (query or {}).items()}
                try:
                    payload = handler(params)
                except ValueError as exc:
                    return (400, json.dumps({"error": str(exc)}).encode(),
                            "application/json")
                except Exception as exc:
                    return (500, json.dumps({"error": str(exc)}).encode(),
                            "application/json")
                return (200, json.dumps(payload, default=repr).encode(),
                        "application/json")
        return 404, b'{"error": "not found"}', "application/json"

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> int:
        """Bind + serve in a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                try:
                    path, _, raw_query = self.path.partition("?")
                    status, body, ctype = outer._handle(
                        path, parse_qs(raw_query))
                except Exception as exc:  # a broken provider must not kill the server
                    status = 500
                    body = json.dumps({"error": str(exc)}).encode("utf-8")
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
                try:
                    # Drain any request body so keep-alive stays coherent;
                    # action parameters travel in the query string.
                    length = int(self.headers.get("Content-Length") or 0)
                    if length > 0:
                        self.rfile.read(length)
                    path, _, raw_query = self.path.partition("?")
                    status, body, ctype = outer._handle_post(
                        path, parse_qs(raw_query))
                except Exception as exc:  # a broken handler must not kill the server
                    status = 500
                    body = json.dumps({"error": str(exc)}).encode("utf-8")
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # route to our logger, DEBUG
                logger.debug("admin http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        # A short poll: stop() waits up to one interval for the loop to
        # see the shutdown request (http.server's default is 0.5 s).
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, args=(0.05,),
            name=f"kvtpu-admin-{self.port}",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "admin endpoint on http://%s:%d (debug=%s)",
            self._host, self.port, self._expose_debug,
        )
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd = None


def start_observability_servers(
    metrics_port: int,
    admin_port: int,
    host: str = "127.0.0.1",
    providers: Optional[dict[str, Callable[[], object]]] = None,
    health: Optional[Callable[[], dict]] = None,
) -> list[AdminServer]:
    """Start the configured endpoint(s); 0 = disabled (the default).

    When both knobs name the same port (or only ``admin_port`` is set),
    one server does both jobs; distinct ports get a metrics-only server
    plus a full admin server. ``health`` (optional) backs ``/healthz`` on
    every started server — non-ok payloads serve as 503 for readiness
    probes.
    """
    servers: list[AdminServer] = []
    if admin_port > 0:
        admin = AdminServer(port=admin_port, host=host, expose_debug=True,
                            health=health)
        for name, provider in (providers or {}).items():
            admin.register_debug(name, provider)
        admin.start()
        servers.append(admin)
    if metrics_port > 0 and metrics_port != admin_port:
        metrics = AdminServer(port=metrics_port, host=host, expose_debug=False,
                              health=health)
        metrics.start()
        servers.append(metrics)
    return servers
