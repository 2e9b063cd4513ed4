"""Retry/backoff policies and per-target circuit breakers.

Copy of ``llmd_kv_cache_tpu/resilience/policy.py``, with a plain
``threading.Lock`` where the JAX package takes a lockdep-witnessed lock.

These are deliberately dependency-free and clock-injectable so unit
tests can drive them without sleeping.  The defaults are tuned for the
in-cluster failure profile: short first retry (transient fs/network
blips resolve in tens of milliseconds), exponential growth with full
jitter to avoid thundering herds, and a hard deadline so callers on the
request path never wait unboundedly.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

logger = logging.getLogger(__name__)


class RetryExhausted(Exception):
    """All attempts failed; ``__cause__`` is the last underlying error."""


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with an overall deadline.

    ``delay(attempt)`` for attempt ``n`` (0-based, i.e. delay before
    retry ``n+1``) is uniform in ``[0, min(max_delay_s, base_delay_s *
    multiplier**n)]`` when ``jitter`` is set ("full jitter"), else the
    deterministic cap value.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: bool = True
    deadline_s: float | None = None

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        cap = min(self.max_delay_s, self.base_delay_s * (self.multiplier ** attempt))
        if not self.jitter:
            return cap
        return (rng.random() if rng is not None else random.random()) * cap


def call_with_retry(
    fn: Callable,
    policy: RetryPolicy,
    *,
    retryable: Callable[[BaseException], bool] | None = None,
    on_retry: Callable[[int, BaseException], None] | None = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
):
    """Invoke ``fn()`` under ``policy``; raise :class:`RetryExhausted` when spent.

    ``retryable`` filters which exceptions are worth retrying (default:
    every ``Exception``); a non-retryable error propagates immediately.
    """
    start = clock()
    last_exc: BaseException | None = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except Exception as exc:
            if retryable is not None and not retryable(exc):
                raise
            last_exc = exc
            if attempt + 1 >= policy.max_attempts:
                break
            pause = policy.delay(attempt, rng)
            if policy.deadline_s is not None and clock() - start + pause > policy.deadline_s:
                break
            if on_retry is not None:
                on_retry(attempt, exc)
            logger.debug("retry %d after %s: sleeping %.3fs", attempt + 1, exc, pause)
            sleep(pause)
    raise RetryExhausted(
        f"{policy.max_attempts} attempt(s) failed: {last_exc}"
    ) from last_exc


class CircuitOpenError(Exception):
    """The breaker is open; the protected target is being shed."""

    def __init__(self, target: str, retry_after_s: float):
        super().__init__(f"circuit for '{target}' is open (retry in {retry_after_s:.1f}s)")
        self.target = target
        self.retry_after_s = retry_after_s


_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


@dataclass
class CircuitBreaker:
    """Classic three-state breaker guarding one target.

    CLOSED → OPEN after ``failure_threshold`` consecutive failures;
    OPEN → HALF_OPEN after ``reset_timeout_s``; one probe call is then
    admitted — success closes the breaker, failure re-opens it.

    The probe slot is a *lease*, not a latch: if the prober never reports
    back (its thread died mid-call, its process was killed, an exception
    path swallowed the outcome), the lease expires after
    ``probe_timeout_s`` and the next ``allow()`` claims it. Without the
    lease a single dead prober wedges the breaker in half-open forever —
    every caller rejected, no probe ever running (a gray failure of the
    breaker itself).
    """

    target: str = "unnamed"
    failure_threshold: int = 5
    reset_timeout_s: float = 10.0
    # Probe lease: how long a claimed half-open probe slot stays reserved
    # before another caller may reclaim it. Must comfortably exceed the
    # slowest legitimate probe RPC.
    probe_timeout_s: float = 30.0
    clock: Callable[[], float] = time.monotonic

    _state: str = field(default=_CLOSED, init=False)
    _failures: int = field(default=0, init=False)
    _opened_at: float = field(default=0.0, init=False)
    _probing: bool = field(default=False, init=False)
    _probe_started_at: float = field(default=0.0, init=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, init=False, repr=False)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if self._state == _OPEN and self.clock() - self._opened_at >= self.reset_timeout_s:
            self._state = _HALF_OPEN
            self._probing = False

    def allow(self) -> bool:
        """True if a call may proceed (claims the probe slot in half-open)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == _CLOSED:
                return True
            if self._state == _HALF_OPEN:
                now = self.clock()
                if (self._probing
                        and now - self._probe_started_at >= self.probe_timeout_s):
                    # Probe lease expired: the prober went quiet without
                    # reporting an outcome. Reclaim so the breaker can
                    # still make progress (a late report from the stale
                    # prober is harmless — it just records an outcome).
                    logger.warning(
                        "circuit for '%s': probe lease expired after %.1fs; "
                        "reclaiming", self.target, self.probe_timeout_s,
                    )
                    self._probing = False
                if not self._probing:
                    self._probing = True
                    self._probe_started_at = now
                    return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = _CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == _HALF_OPEN or self._failures >= self.failure_threshold:
                if self._state != _OPEN:
                    logger.warning(
                        "circuit for '%s' opened after %d failure(s)",
                        self.target, self._failures,
                    )
                self._state = _OPEN
                self._opened_at = self.clock()
                self._probing = False

    def call(self, fn: Callable):
        """Run ``fn`` through the breaker, recording the outcome."""
        if not self.allow():
            with self._lock:
                remaining = max(0.0, self.reset_timeout_s - (self.clock() - self._opened_at))
            raise CircuitOpenError(self.target, remaining)
        try:
            result = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result
