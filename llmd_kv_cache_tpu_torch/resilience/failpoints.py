"""Named, deterministic fault-injection points.

Copy of ``llmd_kv_cache_tpu/resilience/failpoints.py``, with plain
``threading.Lock``s where the JAX package takes lockdep-witnessed locks.
The registry is this package's own: arming a failpoint of one package
does not arm the other's.

A *failpoint* is a named hook planted at an I/O boundary.  Production
code calls :meth:`FailpointRegistry.hit` (or :meth:`should_fire` for
custom corruption-style faults); when the failpoint is disarmed this is
a single dict lookup, so hooks are safe to leave in hot-ish paths.

Failpoints are armed programmatically (chaos tests) or from the
environment:

    KVTPU_FAILPOINTS="offload.load.io_error=error:p=1:times=2,index.redis.op=error"
    KVTPU_FAILPOINT_SEED=1234

Spec grammar per failpoint:
``name=mode[:p=<prob>][:times=<n>][:delay=<s>|delay_ms=<n>][:jitter=<s>|jitter_ms=<n>][:pause=<s>|pause_ms=<n>]``
with modes ``error`` (raise :class:`FaultInjected`), ``delay`` (sleep),
``custom`` (``should_fire`` returns True; the call site decides what
the fault looks like — e.g. flipping bytes to tear a file), and
``pause`` (a *virtual* stop-the-world stall: :meth:`pause_seconds`
returns the armed duration without ever sleeping, so chaos tests
simulate a GC-paused zombie by aging its lease/clock deterministically
instead of stalling the test for real). ``jitter`` adds a uniform
``[0, jitter]`` extension to each sleep — and to each virtual pause —
modeling the wandering latency of a gray-failing pod rather than a
fixed stall.

Determinism: probabilistic firing draws from a registry-owned
``random.Random`` seeded at construction (``KVTPU_FAILPOINT_SEED``,
default 0), so a chaos run replays exactly. Jitter draws come from a
*per-failpoint* RNG seeded from ``(registry seed, failpoint name)``, so
one point's delay schedule replays identically regardless of how other
points' firings interleave with it across threads.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

ENV_FAILPOINTS = "KVTPU_FAILPOINTS"
ENV_SEED = "KVTPU_FAILPOINT_SEED"

MODE_ERROR = "error"
MODE_DELAY = "delay"
MODE_CUSTOM = "custom"
MODE_PAUSE = "pause"

_MODES = (MODE_ERROR, MODE_DELAY, MODE_CUSTOM, MODE_PAUSE)


class FaultInjected(RuntimeError):
    """Raised by an armed ``error``-mode failpoint.

    Carries the failpoint name so retry policies can treat injected
    faults like the real failures they stand in for.
    """

    def __init__(self, name: str):
        super().__init__(f"fault injected at failpoint '{name}'")
        self.failpoint = name


@dataclass
class _Failpoint:
    name: str
    mode: str = MODE_ERROR
    probability: float = 1.0
    times: int | None = None  # remaining firings; None = unlimited
    delay_s: float = 0.0
    jitter_s: float = 0.0  # uniform [0, jitter_s) added to each sleep
    pause_s: float = 0.0  # virtual stall length for MODE_PAUSE (never slept)
    rng: random.Random | None = None  # per-point RNG for jitter draws
    hits: int = 0  # times the hook was reached
    fired: int = 0  # times the fault actually triggered
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)


class FailpointRegistry:
    """Thread-safe registry of named failpoints with a seeded RNG."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._points: dict[str, _Failpoint] = {}
        self._rng = random.Random(seed)
        self._seed = seed
        # Fired-failpoint observers (flight recorder, tests). Called outside
        # the registry lock with just the failpoint name; a listener that
        # raises is dropped from the notification (never breaks injection).
        self._listeners: list = []

    def add_listener(self, fn) -> None:
        """Register ``fn(name)`` to run on every fired failpoint (idempotent
        by identity)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, name: str) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(name)
            except Exception:  # pragma: no cover - observers must not break injection  # lint: allow-swallow
                pass

    # -- configuration ----------------------------------------------------

    def arm(
        self,
        name: str,
        mode: str = MODE_ERROR,
        probability: float = 1.0,
        times: int | None = None,
        delay_s: float = 0.0,
        jitter_s: float = 0.0,
        pause_s: float = 0.0,
    ) -> None:
        if mode not in _MODES:
            raise ValueError(f"unknown failpoint mode {mode!r}; expected one of {_MODES}")
        if not 0.0 <= probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got {probability}")
        if jitter_s < 0.0:
            raise ValueError(f"jitter_s must be >= 0, got {jitter_s}")
        if pause_s < 0.0:
            raise ValueError(f"pause_s must be >= 0, got {pause_s}")
        with self._lock:
            # Per-point RNG keyed off (seed, name): jitter schedules replay
            # per-point regardless of cross-point thread interleaving.
            rng = random.Random(f"{self._seed}:{name}") if jitter_s > 0 else None
            self._points[name] = _Failpoint(
                name=name, mode=mode, probability=probability,
                times=times, delay_s=delay_s, jitter_s=jitter_s,
                pause_s=pause_s, rng=rng,
            )
        logger.debug("armed failpoint %s mode=%s p=%s times=%s", name, mode, probability, times)

    def disarm(self, name: str) -> None:
        with self._lock:
            self._points.pop(name, None)

    def reset(self, seed: int | None = None) -> None:
        """Disarm everything and reseed the RNG (chaos-test fixture hook)."""
        with self._lock:
            self._points.clear()
            self._rng = random.Random(self._seed if seed is None else seed)
            if seed is not None:
                self._seed = seed

    def configure_from_env(self, env: dict[str, str] | None = None) -> None:
        env = os.environ if env is None else env
        seed = env.get(ENV_SEED)
        if seed is not None:
            self.reset(seed=int(seed))
        spec = env.get(ENV_FAILPOINTS, "")
        for part in filter(None, (p.strip() for p in spec.split(","))):
            self._arm_from_spec(part)

    def _arm_from_spec(self, spec: str) -> None:
        name, _, rest = spec.partition("=")
        mode, probability, times = MODE_ERROR, 1.0, None
        delay_s, jitter_s, pause_s = 0.0, 0.0, 0.0
        for tok in filter(None, rest.split(":")):
            if tok in _MODES:
                mode = tok
            elif tok.startswith("p="):
                probability = float(tok[2:])
            elif tok.startswith("times="):
                times = int(tok[6:])
            elif tok.startswith("delay_ms="):
                delay_s = float(tok[9:]) / 1e3
            elif tok.startswith("delay="):
                delay_s = float(tok[6:])
            elif tok.startswith("jitter_ms="):
                jitter_s = float(tok[10:]) / 1e3
            elif tok.startswith("jitter="):
                jitter_s = float(tok[7:])
            elif tok.startswith("pause_ms="):
                mode, pause_s = MODE_PAUSE, float(tok[9:]) / 1e3
            elif tok.startswith("pause="):
                # A duration implies the mode: ``name=pause=12`` and
                # ``name=pause:pause=12`` both arm a 12 s virtual stall.
                mode, pause_s = MODE_PAUSE, float(tok[6:])
            else:
                raise ValueError(f"bad failpoint spec token {tok!r} in {spec!r}")
        self.arm(name, mode=mode, probability=probability, times=times,
                 delay_s=delay_s, jitter_s=jitter_s, pause_s=pause_s)

    # -- introspection ----------------------------------------------------

    def is_armed(self, name: str) -> bool:
        with self._lock:
            return name in self._points

    def stats(self, name: str) -> tuple[int, int]:
        """Return ``(hits, fired)`` for a failpoint (0, 0 if never armed)."""
        with self._lock:
            fp = self._points.get(name)
            return (fp.hits, fp.fired) if fp is not None else (0, 0)

    # -- firing -----------------------------------------------------------

    def _roll(self, name: str) -> _Failpoint | None:
        """Decide whether the named failpoint fires; returns it if so."""
        with self._lock:
            fp = self._points.get(name)
            if fp is None:
                return None
            fp.hits += 1
            if fp.times is not None and fp.times <= 0:
                return None
            if fp.probability < 1.0 and self._rng.random() >= fp.probability:
                return None
            if fp.times is not None:
                fp.times -= 1
            fp.fired += 1
            return fp

    def should_fire(self, name: str) -> bool:
        """Custom-mode check: True when the call site should inject its fault."""
        fired = self._roll(name) is not None
        if fired:
            self._notify(name)
        return fired

    def pause_seconds(self, name: str) -> float:
        """Pause-mode check: the virtual stall to apply, 0.0 when quiet.

        Never sleeps — the call site ages its own clock (a lease's last
        renewal, a liveness stamp) by the returned seconds, exactly what a
        stop-the-world GC pause of that length would have done to it.
        Seeded jitter extends the stall the same way it extends delay-mode
        sleeps, so a chaos run's pause schedule replays identically.
        """
        fp = self._roll(name)
        if fp is None or fp.mode != MODE_PAUSE:
            return 0.0
        self._notify(name)
        logger.warning("failpoint %s fired (mode=%s, count=%d)", name, fp.mode, fp.fired)
        stall = fp.pause_s
        if fp.jitter_s > 0.0 and fp.rng is not None:
            with fp.lock:
                stall += fp.rng.uniform(0.0, fp.jitter_s)
        return stall

    def hit(self, name: str) -> None:
        """Standard hook: raise/sleep per the armed mode, no-op otherwise."""
        fp = self._roll(name)
        if fp is None:
            return
        self._notify(name)
        logger.warning("failpoint %s fired (mode=%s, count=%d)", name, fp.mode, fp.fired)
        sleep_s = fp.delay_s
        if fp.jitter_s > 0.0 and fp.rng is not None:
            with fp.lock:
                sleep_s += fp.rng.uniform(0.0, fp.jitter_s)
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if fp.mode == MODE_ERROR:
            raise FaultInjected(name)


# Process-wide registry; chaos tests arm/reset it, prod leaves it empty.
failpoints = FailpointRegistry(seed=int(os.environ.get(ENV_SEED, "0")))
if os.environ.get(ENV_FAILPOINTS):
    failpoints.configure_from_env()
