"""Graceful drain: stop intake, flush, snapshot — under a deadline.

SIGTERM (the orchestrator's shutdown signal) should leave the process's
durable state as close to truth as the deadline allows, in strictly
decreasing order of value:

1. **stop intake** — unsubscribe/stop the ZMQ feeds so the queues only
   shrink from here;
2. **drain the event pool** — process everything already queued so the
   final snapshot includes it;
3. **flush in-flight offload jobs** — completed transfers get reported
   (and their checksums land) instead of being abandoned;
4. **final snapshot** — persist the fully-drained index + watermarks.

Every step charges against one shared ``drainDeadlineS`` budget. A step
that exceeds the remaining budget is *abandoned* (its helper thread is
daemonized), the shortfall is recorded, and the next step gets whatever
is left — crash-only design means an unfinished drain is never worse
than the crash the periodic snapshot already protects against.

Port of ``llmd_kv_cache_tpu/recovery/drain.py``.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional, Sequence

from ..metrics.collector import record_drain
from ..utils.lockdep import new_lock
from ..telemetry import flight_recorder, tracer
from ..telemetry.flight_recorder import KIND_DRAIN
from ..utils.logging import get_logger

logger = get_logger("recovery.drain")


class DrainCoordinator:
    """Runs the 4-step drain under a deadline; installable on SIGTERM."""

    def __init__(
        self,
        deadline_s: float = 10.0,
        intake_stoppers: Sequence[Callable[[], None]] = (),
        pool=None,
        offload=None,
        manager=None,
        on_complete: Optional[Callable[[], None]] = None,
    ):
        self.deadline_s = deadline_s
        self.intake_stoppers = list(intake_stoppers)
        self.pool = pool
        self.offload = offload
        self.manager = manager
        self.on_complete = on_complete
        self._mu = new_lock()
        self._drained = False
        self.last_report: Optional[dict] = None

    def _bounded(self, name: str, fn: Callable[[], None], remaining: float) -> bool:
        """Run ``fn`` but give up after ``remaining`` seconds; True if it
        finished inside the budget."""
        if remaining <= 0:
            logger.warning("drain step %s skipped: deadline exhausted", name)
            return False
        done = threading.Event()
        err: list = []

        def _run() -> None:
            try:
                fn()
            except Exception as e:
                err.append(e)
                logger.exception("drain step %s failed", name)
            finally:
                done.set()

        t = threading.Thread(target=_run, name=f"kvtpu-drain-{name}", daemon=True)
        t.start()
        finished = done.wait(remaining)
        if not finished:
            logger.warning(
                "drain step %s abandoned after %.2fs (deadline)", name, remaining
            )
        return finished and not err

    def drain(self) -> dict:
        """Execute the drain once (idempotent); returns a step report."""
        with self._mu:
            if self._drained:
                return self.last_report or {"completed": True, "steps": {}}
            self._drained = True
        start = time.monotonic()
        deadline = start + self.deadline_s
        steps: dict = {}
        if self.manager is not None:
            self.manager._transition("draining")
        with tracer().span("llm_d.kv_cache.recovery.drain", deadline_s=self.deadline_s):
            def _stop_intake() -> None:
                for stop in self.intake_stoppers:
                    stop()

            steps["stop_intake"] = self._bounded(
                "stop_intake", _stop_intake, deadline - time.monotonic()
            )
            if self.pool is not None:
                steps["drain_pool"] = self._bounded(
                    "drain_pool", self.pool.shutdown, deadline - time.monotonic()
                )
            if self.offload is not None:
                remaining = deadline - time.monotonic()
                steps["flush_offload"] = (
                    remaining > 0 and self.offload.flush(deadline_s=remaining)
                )
            if self.manager is not None:
                steps["final_snapshot"] = self._bounded(
                    "final_snapshot",
                    lambda: self.manager.stop(final_snapshot=True),
                    deadline - time.monotonic(),
                )
        seconds = time.monotonic() - start
        report = {
            "completed": all(steps.values()) if steps else True,
            "steps": steps,
            "seconds": round(seconds, 3),
            "deadline_s": self.deadline_s,
        }
        self.last_report = report
        logger.info("drain finished in %.2fs: %s", seconds, steps)
        flight_recorder().record(KIND_DRAIN, dict(report))
        record_drain(seconds)
        if self.on_complete is not None:
            try:
                self.on_complete()
            except Exception:
                logger.exception("drain on_complete callback failed")
        return report

    def install(self, signals: Sequence[int] = (signal.SIGTERM,)) -> None:
        """Install signal handlers that run the drain off-thread (signal
        handlers must return quickly). Call from the main thread."""

        def _handler(signum, frame):  # pragma: no cover - signal path
            logger.info("signal %d received; starting graceful drain", signum)
            threading.Thread(
                target=self.drain, name="kvtpu-drain", daemon=True
            ).start()

        for sig in signals:
            signal.signal(sig, _handler)
