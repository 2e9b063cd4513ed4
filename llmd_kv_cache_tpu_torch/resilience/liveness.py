"""Pod liveness tracking for degraded-mode scoring.

Copy of ``llmd_kv_cache_tpu/resilience/liveness.py``.

The event :class:`~llmd_kv_cache_tpu_torch.events.pool.Pool` touches a pod
every time it processes one of its events; scorers multiply each pod's
score by :meth:`PodLivenessTracker.factor`.  A pod that stops emitting
events (crashed, partitioned, wedged publisher) decays linearly from
full weight at ``stale_after_s`` to zero at ``drop_after_s``, so the
router shifts traffic away gradually and finally falls back to
round-robin rather than routing to a corpse with a stale index view.

Gray failures — a pod that is *slow* rather than dead — never trip the
staleness decay (its events keep flowing). When serving-latency samples
are fed via :meth:`observe_latency`, a second, independent demotion
kicks in: each pod keeps a latency EMA, and a pod whose EMA exceeds
``latency_demote_after_s`` decays linearly to ``latency_floor`` at
``latency_drop_after_s`` — demoted, never fully zeroed, because a slow
pod still serves (unlike a dead one) and zero-weighting the whole fleet
during a global slowdown would leave nothing to route to. The two
factors multiply. Latency demotion is off (factor 1.0) until
``latency_demote_after_s > 0`` and at least ``_MIN_LATENCY_SAMPLES``
samples arrived, so existing deployments see no behavior change.

Pods the tracker has never seen score at full weight: a fresh indexer
(or one tracking pods discovered out-of-band) must not zero the fleet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

from ..utils.lockdep import new_lock

# EMA smoothing for latency samples (~20-sample memory) and the minimum
# evidence before a pod can be demoted for slowness.
_LATENCY_ALPHA = 0.1
_MIN_LATENCY_SAMPLES = 5


class PodLivenessTracker:
    def __init__(
        self,
        stale_after_s: float = 30.0,
        drop_after_s: float = 120.0,
        latency_demote_after_s: float = 0.0,
        latency_drop_after_s: float = 0.0,
        latency_floor: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if drop_after_s <= stale_after_s:
            raise ValueError(
                f"drop_after_s ({drop_after_s}) must exceed stale_after_s ({stale_after_s})"
            )
        if latency_demote_after_s > 0:
            if latency_drop_after_s <= latency_demote_after_s:
                raise ValueError(
                    f"latency_drop_after_s ({latency_drop_after_s}) must "
                    f"exceed latency_demote_after_s ({latency_demote_after_s})"
                )
            if not 0.0 <= latency_floor <= 1.0:
                raise ValueError(
                    f"latency_floor must be in [0, 1], got {latency_floor}"
                )
        self.stale_after_s = stale_after_s
        self.drop_after_s = drop_after_s
        self.latency_demote_after_s = latency_demote_after_s
        self.latency_drop_after_s = latency_drop_after_s
        self.latency_floor = latency_floor
        self._clock = clock
        self._lock = new_lock()
        self._last_seen: Dict[str, float] = {}
        # pod -> (ema_seconds, sample_count)
        self._latency: Dict[str, tuple[float, int]] = {}

    def touch(self, pod: str) -> None:
        with self._lock:
            self._last_seen[pod] = self._clock()

    def observe_latency(self, pod: str, seconds: float) -> None:
        """Feed one serving-latency sample (e.g. a shard RPC or a pod's
        TTFT) for gray-failure demotion. Cheap: one lock, two floats."""
        seconds = max(0.0, seconds)
        with self._lock:
            prev = self._latency.get(pod)
            if prev is None:
                self._latency[pod] = (seconds, 1)
            else:
                ema, n = prev
                self._latency[pod] = (
                    ema + _LATENCY_ALPHA * (seconds - ema), n + 1
                )

    def mark_removed(self, pod: str) -> None:
        with self._lock:
            self._last_seen.pop(pod, None)
            self._latency.pop(pod, None)

    def last_seen(self, pod: str) -> float | None:
        with self._lock:
            return self._last_seen.get(pod)

    def staleness(self, pod: str) -> float | None:
        """Seconds since the pod's last event, or None if never seen."""
        with self._lock:
            ts = self._last_seen.get(pod)
        return None if ts is None else max(0.0, self._clock() - ts)

    def latency_ema(self, pod: str) -> float | None:
        """Current latency EMA in seconds, or None without samples."""
        with self._lock:
            entry = self._latency.get(pod)
            return entry[0] if entry is not None else None

    def _latency_factor_locked(self, pod: str) -> float:
        if self.latency_demote_after_s <= 0:
            return 1.0
        entry = self._latency.get(pod)
        if entry is None or entry[1] < _MIN_LATENCY_SAMPLES:
            return 1.0
        ema = entry[0]
        if ema <= self.latency_demote_after_s:
            return 1.0
        if ema >= self.latency_drop_after_s:
            return self.latency_floor
        span = self.latency_drop_after_s - self.latency_demote_after_s
        frac = (ema - self.latency_demote_after_s) / span
        return 1.0 - (1.0 - self.latency_floor) * frac

    def latency_factor(self, pod: str) -> float:
        """Gray-failure multiplier in [latency_floor, 1]."""
        with self._lock:
            return self._latency_factor_locked(pod)

    def factor(self, pod: str) -> float:
        """Score multiplier in [0, 1]: staleness decay x latency demotion."""
        age = self.staleness(pod)
        if age is None or age <= self.stale_after_s:
            staleness_factor = 1.0
        elif age >= self.drop_after_s:
            return 0.0
        else:
            span = self.drop_after_s - self.stale_after_s
            staleness_factor = 1.0 - (age - self.stale_after_s) / span
        return staleness_factor * self.latency_factor(pod)

    def snapshot(self) -> Dict[str, float]:
        """Current factor per tracked pod (observability hook)."""
        with self._lock:
            pods = set(self._last_seen) | set(self._latency)
        return {p: self.factor(p) for p in pods}
