"""End-to-end request deadlines that travel with the request.

Copy of ``llmd_kv_cache_tpu/resilience/deadline.py``.

A :class:`Deadline` is an absolute point on the *local* monotonic clock.
It crosses process boundaries as a **relative budget** (milliseconds
remaining at send time) — never as an absolute timestamp — so clock skew
between pods cannot inflate or collapse the budget; each hop re-anchors
the remaining time on its own clock. The cost is that network transit
time is invisible to the receiver (the budget is slightly optimistic by
one one-way latency), which errs on the side of doing work rather than
shedding it.

Wire conventions (all tolerant — absent means "no deadline", exactly the
``traceparent`` arrival pattern):

- ``ScoreRequest.deadline_ms`` / shard-RPC frame key ``"deadline_ms"`` —
  msgpack int, remaining budget at send time, 0/absent = none.
- gRPC metadata key ``kvtpu-deadline-ms`` — same value for surfaces that
  only speak metadata (the tokenizer sidecar).

Ambient propagation mirrors ``telemetry.current_traceparent()``: a
service handler enters :func:`deadline_scope` once at the top of the
request, and every blocking site below — router fan-out, index lookup,
tokenizer RPC, engine admission, offload restore — reads
:func:`current_deadline` without threading a parameter through every
signature.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator, Optional

GRPC_DEADLINE_KEY = "kvtpu-deadline-ms"
WIRE_DEADLINE_KEY = "deadline_ms"


class DeadlineExceeded(TimeoutError):
    """A blocking site found the request's deadline already spent."""

    def __init__(self, site: str, overrun_s: float = 0.0):
        super().__init__(
            f"deadline exceeded at {site}"
            + (f" ({overrun_s * 1e3:.1f} ms past)" if overrun_s > 0 else "")
        )
        self.site = site
        self.overrun_s = overrun_s


class Deadline:
    """An absolute monotonic expiry with skew-free wire encoding."""

    __slots__ = ("expires_at", "_clock")

    def __init__(self, expires_at: float,
                 clock: Callable[[], float] = time.monotonic):
        self.expires_at = float(expires_at)
        self._clock = clock

    @classmethod
    def after(cls, budget_s: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        if budget_s < 0:
            raise ValueError(f"deadline budget must be >= 0, got {budget_s}")
        return cls(clock() + budget_s, clock=clock)

    @classmethod
    def from_wire_ms(cls, ms, clock: Callable[[], float] = time.monotonic
                     ) -> Optional["Deadline"]:
        """Decode a relative wire budget; 0/None/absent/garbage → None
        (a peer that sends nonsense must not crash scoring)."""
        try:
            ms = int(ms)
        except (TypeError, ValueError):
            return None
        if ms <= 0:
            return None
        return cls(clock() + ms / 1e3, clock=clock)

    def remaining_s(self) -> float:
        """Seconds of budget left; negative once expired."""
        return self.expires_at - self._clock()

    def expired(self) -> bool:
        return self._clock() >= self.expires_at

    def to_wire_ms(self) -> int:
        """Remaining budget as the wire int (>= 1 while any budget is
        left, so a nearly-spent deadline never encodes as "none")."""
        remaining = self.remaining_s()
        if remaining <= 0:
            return 0
        return max(1, int(remaining * 1e3))

    def cap_timeout(self, timeout_s: Optional[float]) -> float:
        """The stricter of ``timeout_s`` and this deadline (floor 0)."""
        remaining = max(0.0, self.remaining_s())
        if timeout_s is None:
            return remaining
        return min(float(timeout_s), remaining)

    def check(self, site: str) -> None:
        """Raise :class:`DeadlineExceeded` if already spent."""
        remaining = self.remaining_s()
        if remaining <= 0:
            raise DeadlineExceeded(site, overrun_s=-remaining)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Deadline(remaining={self.remaining_s() * 1e3:.1f}ms)"


# -- ambient propagation ---------------------------------------------------

_ambient = threading.local()


def current_deadline() -> Optional[Deadline]:
    """The innermost active :func:`deadline_scope` deadline, or None."""
    return getattr(_ambient, "deadline", None)


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]) -> Iterator[Optional[Deadline]]:
    """Make ``deadline`` ambient for the current thread. ``None`` is
    accepted and simply clears the scope (callers need no branching for
    deadline-less requests). Nested scopes keep the *stricter* deadline —
    an inner hop can shrink the budget but never extend it."""
    prev = getattr(_ambient, "deadline", None)
    eff = deadline
    if prev is not None and (eff is None or prev.expires_at < eff.expires_at):
        eff = prev
    _ambient.deadline = eff
    try:
        yield eff
    finally:
        _ambient.deadline = prev


def effective_timeout(timeout_s: Optional[float],
                      deadline: Optional[Deadline] = None) -> Optional[float]:
    """Cap ``timeout_s`` by the explicit or ambient deadline. Returns
    ``timeout_s`` unchanged when no deadline is active; never negative."""
    dl = deadline if deadline is not None else current_deadline()
    if dl is None:
        return timeout_s
    return dl.cap_timeout(timeout_s)


def deadline_metadata(deadline: Optional[Deadline] = None):
    """``((kvtpu-deadline-ms, "<n>"),)`` for gRPC metadata, or ``()``."""
    dl = deadline if deadline is not None else current_deadline()
    if dl is None:
        return ()
    return ((GRPC_DEADLINE_KEY, str(dl.to_wire_ms())),)


def extract_deadline(context) -> Optional[Deadline]:
    """Read ``kvtpu-deadline-ms`` from a gRPC ServicerContext (tolerant:
    absent, unparsable, or a None context all yield None)."""
    if context is None:
        return None
    try:
        metadata = context.invocation_metadata()
    except Exception:  # lint: allow-swallow (non-gRPC test doubles)
        return None
    if not metadata:
        return None
    for key, value in metadata:
        if key == GRPC_DEADLINE_KEY:
            return Deadline.from_wire_ms(value)
    return None
