"""Adaptive overload shedding: a CoDel-style queue-delay controller.

Copy of ``llmd_kv_cache_tpu/resilience/shedding.py``, with a plain
``threading.Lock`` where the JAX package takes a lockdep-witnessed lock.

Fixed queue-length caps misfire in both directions: too small sheds
bursts a healthy server would absorb, too large lets latency build into
standing-queue collapse. CoDel (Nichols & Jacobson) controls on *delay*
instead: overload is declared only when the observed queueing/processing
delay stays above ``target_delay_s`` for a full ``interval_s`` — a burst
that clears inside one interval never sheds — and once overloaded the
shedder ramps pressure with the classic inverse-sqrt control law
(re-evaluation intervals shrink as ``interval / sqrt(n)`` while the
overload persists, so pressure grows smoothly rather than oscillating).

Pressure maps to *brownout before blackout* via request priorities:

- ``PRIORITY_LOW`` (0) — speculative/optional work (prefetch, offload
  restore extensions, background repair). Shed first.
- ``PRIORITY_NORMAL`` (1) — ordinary request-path work. Degraded
  (brownout: skip enrichment, serve a cheaper answer flagged
  ``degraded``) under moderate pressure, shed only when pressure is
  sustained.
- ``PRIORITY_CRITICAL`` (2) — never shed (health checks, drain,
  control-plane actions).

Callers ask :meth:`CoDelShedder.admit` per unit of work and feed
:meth:`observe_delay` with the measured sojourn/processing delay. All
state is one lock; the clock is injectable for tests.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

PRIORITY_LOW = 0
PRIORITY_NORMAL = 1
PRIORITY_CRITICAL = 2

# Decision outcomes (also the flight-recorder / metric label values).
ADMIT = "admit"
BROWNOUT = "brownout"
SHED = "shed"

# Consecutive shed-law firings before PRIORITY_NORMAL work sheds too
# (low-priority work sheds from the first firing; brownout starts at
# overload entry).
_NORMAL_SHED_AFTER = 4


class OverloadShedError(RuntimeError):
    """Raised by call sites that fail fast on shed (engine admission)."""

    def __init__(self, site: str, queue_delay_s: float):
        super().__init__(
            f"overload shed at {site} "
            f"(queue delay {queue_delay_s * 1e3:.1f} ms)"
        )
        self.site = site
        self.queue_delay_s = queue_delay_s


class CoDelShedder:
    """CoDel-style delay-controlled admission for one service site."""

    def __init__(
        self,
        site: str,
        target_delay_s: float = 0.005,
        interval_s: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if target_delay_s <= 0 or interval_s <= 0:
            raise ValueError("target_delay_s and interval_s must be > 0")
        self.site = site
        self.target_delay_s = target_delay_s
        self.interval_s = interval_s
        self._clock = clock
        self._mu = threading.Lock()
        # CoDel state: when delay first exceeded target (None = under
        # target), whether we are in the shedding regime, the next time
        # the control law fires, and the firing count driving sqrt decay.
        self._first_above: Optional[float] = None
        self._overloaded = False
        self._next_fire = 0.0
        self._fire_count = 0
        self._last_delay = 0.0
        # Accounting.
        self._admitted = 0
        self._brownouts = 0
        self._sheds = 0
        self._listeners: list = []

    # -- observation ------------------------------------------------------

    def observe_delay(self, delay_s: float) -> None:
        """Feed one measured queueing/processing delay."""
        now = self._clock()
        transition = None
        with self._mu:
            self._last_delay = delay_s
            if delay_s < self.target_delay_s:
                # Below target: leave overload immediately (CoDel resets
                # its decay once the standing queue drains).
                if self._overloaded:
                    transition = ("clear", delay_s)
                self._first_above = None
                self._overloaded = False
                self._fire_count = 0
            else:
                if self._first_above is None:
                    self._first_above = now
                if (not self._overloaded
                        and now - self._first_above >= self.interval_s):
                    # Sustained above target for a full interval: enter
                    # the shedding regime.
                    self._overloaded = True
                    self._fire_count = 1
                    self._next_fire = now + self.interval_s / math.sqrt(
                        self._fire_count + 1)
                    transition = ("overload", delay_s)
                elif self._overloaded and now >= self._next_fire:
                    # Still above target at the control-law cadence: ramp.
                    self._fire_count += 1
                    self._next_fire = now + self.interval_s / math.sqrt(
                        self._fire_count + 1)
        if transition is not None:
            self._notify(*transition)

    # -- admission --------------------------------------------------------

    def admit(self, priority: int = PRIORITY_NORMAL) -> str:
        """Decide for one unit of work: ADMIT, BROWNOUT, or SHED."""
        with self._mu:
            if not self._overloaded or priority >= PRIORITY_CRITICAL:
                self._admitted += 1
                return ADMIT
            if priority <= PRIORITY_LOW:
                self._sheds += 1
                return SHED
            if self._fire_count >= _NORMAL_SHED_AFTER:
                self._sheds += 1
                return SHED
            self._brownouts += 1
            return BROWNOUT

    @property
    def overloaded(self) -> bool:
        with self._mu:
            return self._overloaded

    @property
    def last_delay_s(self) -> float:
        """Most recently observed delay (for shed error messages)."""
        with self._mu:
            return self._last_delay

    @property
    def pressure(self) -> int:
        """0 = healthy; >= 1 = overloaded, growing with persistence."""
        with self._mu:
            return self._fire_count if self._overloaded else 0

    def shed_rate(self) -> float:
        """Shed decisions / total decisions (the controller signal)."""
        with self._mu:
            total = self._admitted + self._brownouts + self._sheds
            return self._sheds / total if total else 0.0

    def stats(self) -> dict:
        with self._mu:
            total = self._admitted + self._brownouts + self._sheds
            return {
                "site": self.site,
                "overloaded": self._overloaded,
                "pressure": self._fire_count if self._overloaded else 0,
                "last_delay_ms": round(self._last_delay * 1e3, 3),
                "admitted": self._admitted,
                "brownouts": self._brownouts,
                "sheds": self._sheds,
                "shed_rate": round(self._sheds / total, 4) if total else 0.0,
            }

    # -- observers --------------------------------------------------------

    def add_listener(self, fn) -> None:
        """``fn(event, delay_s)`` on overload/clear transitions (flight
        recorder, tests). Called outside the lock; a raising listener is
        ignored."""
        with self._mu:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def _notify(self, event: str, delay_s: float) -> None:
        with self._mu:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(event, delay_s)
            except Exception:  # lint: allow-swallow (observers never break shedding)
                pass
