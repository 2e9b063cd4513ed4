"""In-process flight recorder: a lock-light ring of decision records.

Copy of ``llmd_kv_cache_tpu/telemetry/flight_recorder.py``.

The aviation analogy is deliberate: when a scorer picks a surprising pod,
a failover flips the index, or an offload job dies, the question is always
"what were the last N decisions leading up to it?" — and by then the
moment is gone. The recorder keeps the last ``capacity`` structured
records (score outcomes with per-pod scores, ingest coalescing stats,
failover transitions, offload results, failpoint trips) in a preallocated
ring that costs well under a microsecond per record on the score hot path
(bench.py asserts < 1%).

Lock-light by construction: writers claim a monotonically increasing
sequence from ``itertools.count()`` (a single C-level call, atomic under
the GIL and safe on free-threaded builds via its internal lock) and store
an immutable tuple into ``slots[seq % capacity]`` — one list item
assignment, no lock, no allocation beyond the tuple. Readers snapshot the
slot list and sort by sequence; a reader racing a writer sees either the
old or the new tuple for a slot, never a torn record.

Dump surfaces: ``SIGUSR2`` (install via :func:`install_signal_dump`),
first trip of each failpoint (:func:`attach_failpoint_listener`), the
admin endpoint's ``/debug/flight-recorder``, and ``hack/kvdiag.py``.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import signal
import tempfile
import threading
import time
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

DEFAULT_CAPACITY = 1024

# Record kinds written by the library (a closed set keeps dashboards and
# kvdiag greppable; new subsystems add to it deliberately).
KIND_SCORE = "score"
KIND_INGEST = "ingest"
KIND_FAILOVER = "failover"
KIND_RETRY = "retry"
KIND_OFFLOAD = "offload"
KIND_FAILPOINT = "failpoint"
KIND_RECONNECT = "zmq_reconnect"
KIND_RECOVERY = "recovery"
KIND_DRAIN = "drain"
KIND_OVERFLOW = "queue_overflow"
KIND_ENGINE_REQUEST = "engine_request"
KIND_PROFILE = "profile_capture"
KIND_LOCKDEP = "lockdep"
KIND_HEDGE = "hedge"
KIND_SHED = "shed"
KIND_AUDIT = "audit"
KIND_FENCE = "fence"
KIND_ANOMALY = "anomaly"
KIND_INCIDENT = "incident"


class FlightRecorder:
    """Fixed-capacity ring of ``(seq, ts, mono, kind, data)`` tuples.

    ``ts`` is wall-clock (``time.time()``) so records from different pods
    can be merged onto one fleet timeline (after the collector's per-pod
    skew correction, telemetry/incident.py); ``mono`` is the same pod's
    ``time.monotonic()`` so records align with span start/end stamps and
    survive local wall-clock steps."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = capacity
        self._slots: list[Optional[tuple]] = [None] * capacity
        self._count = itertools.count()

    @property
    def capacity(self) -> int:
        return self._capacity

    def record(self, kind: str, data: Optional[dict] = None) -> int:
        """Append one record; returns its sequence number.

        Hot-path budget: one ``next()``, one ``time.time()``, one
        ``time.monotonic()``, one tuple build, one list store. ``data`` is
        kept by reference — treat it as frozen after handoff (callers on
        the hot path pass freshly built dicts they do not mutate
        afterwards).
        """
        seq = next(self._count)
        self._slots[seq % self._capacity] = (
            seq, time.time(), time.monotonic(), kind, data)
        return seq

    def _live(self) -> list[tuple]:
        live = [s for s in list(self._slots) if s is not None]
        live.sort(key=lambda rec: rec[0])
        return live

    def snapshot(self) -> list[dict[str, Any]]:
        """Records currently in the ring, oldest first."""
        return [
            {"seq": seq, "ts": ts, "mono": mono, "kind": kind, "data": data}
            for seq, ts, mono, kind, data in self._live()
        ]

    def export_since(self, since: int = -1) -> dict[str, Any]:
        """Records with ``seq > since`` plus the resume cursor — the
        ``/debug/flight-recorder?since=`` payload, with the same
        non-destructive per-puller cursor semantics as ``/debug/spans``:
        ``next_seq`` is the newest seq present (echo it back next pull)
        and ``dropped`` counts records evicted from the ring so far."""
        live = self._live()
        records = [
            {"seq": seq, "ts": ts, "mono": mono, "kind": kind, "data": data}
            for seq, ts, mono, kind, data in live
            if seq > since
        ]
        next_seq = live[-1][0] if live else since
        dropped = max(0, live[-1][0] + 1 - len(live)) if live else 0
        return {"records": records, "next_seq": next_seq, "dropped": dropped}

    def dump_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(
            {"capacity": self._capacity, "records": self.snapshot()},
            indent=indent,
            default=repr,
        )

    def clear(self) -> None:
        """Drop all records (tests / post-dump reset); writers may race this
        benignly — a record written during clear survives in its slot."""
        for i in range(self._capacity):
            self._slots[i] = None


_global_recorder: Optional[FlightRecorder] = None
_global_mu = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """Process-wide recorder (lazily created at :data:`DEFAULT_CAPACITY`)."""
    global _global_recorder
    rec = _global_recorder
    if rec is None:
        with _global_mu:
            rec = _global_recorder
            if rec is None:
                rec = _global_recorder = FlightRecorder()
    return rec


def set_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Swap the process-wide recorder (tests size it down; None resets)."""
    global _global_recorder
    with _global_mu:
        _global_recorder = recorder


def record(kind: str, data: Optional[dict] = None) -> int:
    """Module-level shorthand for ``flight_recorder().record(...)``."""
    return flight_recorder().record(kind, data)


def install_signal_dump(
    signum: int = signal.SIGUSR2,
    path: Optional[str] = None,
    recorder: Optional[FlightRecorder] = None,
    dump_dir: Optional[str] = None,
) -> Callable:
    """Dump the ring as JSON on ``signum`` (default ``SIGUSR2``).

    Writes to ``path`` when given. Otherwise each signal writes a fresh
    timestamped file under ``dump_dir`` (default: ``$KVTPU_DUMP_DIR``,
    falling back to the system temp dir) and logs the file path — a
    1024-record ring serialized onto a single ``logger.warning`` line
    used to be truncated by every log shipper that touched it, so the
    payload never goes to the log anymore, only its location does.
    Returns the previous handler so callers can restore it. Must be called
    from the main thread (CPython restriction on ``signal.signal``).
    """
    rec = recorder if recorder is not None else flight_recorder()

    def _handler(_signum, _frame):
        payload = rec.dump_json()
        target = path
        if not target:
            directory = (dump_dir or os.environ.get("KVTPU_DUMP_DIR")
                         or tempfile.gettempdir())
            stamp = time.strftime("%Y%m%dT%H%M%S")
            target = os.path.join(
                directory, f"kvtpu-flight-{os.getpid()}-{stamp}.json")
        try:
            with open(target, "w") as fh:
                fh.write(payload)
        except OSError as exc:
            logger.error("flight-recorder dump to %s failed: %s", target, exc)
        else:
            logger.warning(
                "flight-recorder dump (signal %d) written to %s (%d bytes)",
                _signum, target, len(payload))

    return signal.signal(signum, _handler)


# One black-box capture per failpoint name per process: chaos suites fire
# the same failpoint thousands of times and must not flood the log.
_dumped_failpoints: set[str] = set()


def attach_failpoint_listener(registry=None) -> None:
    """Record every failpoint trip; dump the ring once per failpoint name.

    ``registry`` defaults to the global one in ``resilience.failpoints``.
    Idempotent — re-attaching replaces nothing and duplicates nothing
    (the registry de-dupes listeners by identity).
    """
    if registry is None:
        from ..resilience.failpoints import failpoints as registry  # noqa: PLC0415

    registry.add_listener(_on_failpoint_fired)


def _on_failpoint_fired(name: str) -> None:
    rec = flight_recorder()
    rec.record(KIND_FAILPOINT, {"name": name})
    if name not in _dumped_failpoints:
        _dumped_failpoints.add(name)
        logger.warning(
            "failpoint '%s' fired; flight-recorder capture: %s", name, rec.dump_json()
        )
