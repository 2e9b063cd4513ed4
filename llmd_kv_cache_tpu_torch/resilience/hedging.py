"""Tail-tolerant hedging primitives: latency quantiles + a hedge budget.

Copy of ``llmd_kv_cache_tpu/resilience/hedging.py``.

Gray failures — a pod that is *slow* rather than dead — defeat breakers
(calls succeed) and liveness (events keep flowing). The classic answer
("The Tail at Scale") is a *hedged request*: if the primary hasn't
answered by the p-th latency percentile, issue the same request to a
replica and take the first response. Two pieces make that safe:

- :class:`LatencyQuantileTracker` — a per-target streaming quantile
  estimate (EMA-stepped stochastic approximation, O(1) memory per
  target) that adapts the hedge trigger to each shard's *current*
  latency distribution, so a uniformly slow fleet doesn't hedge at all
  while one slow shard trips hedges immediately.
- :class:`HedgeBudget` — a token bucket refilled by primary-request
  volume, capping hedges at a configured fraction of real traffic so a
  melting-down fleet cannot double its own load (hedge-storm).

Both are lock-protected (lockdep factories), clock-injectable, and
dependency-free, like the rest of ``resilience``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..utils.lockdep import new_lock


class _QuantileEstimate:
    """Streaming quantile via stochastic approximation.

    Classic Robbins-Monro update: the estimate moves up by ``step * q``
    on a sample above it and down by ``step * (1 - q)`` on one below, so
    it converges where the exceed-rate is ``1 - q``. The step adapts to
    the value scale through an EMA of |sample - estimate| — no window,
    no histogram, a handful of floats per target.

    Samples are winsorized at ``3x`` the current estimate (once warmed):
    at high quantiles the up/down steps are deliberately asymmetric
    (``q`` vs ``1 - q``), so a single wild outlier would otherwise
    ratchet the estimate up and take hundreds of samples to decay — a
    hedge trigger stuck high is a hedge that never fires. A genuinely
    shifted distribution still grows the estimate exponentially (3x per
    sample), just not in one jump.
    """

    __slots__ = ("q", "estimate", "scale", "count")

    WINSOR_FACTOR = 3.0
    WINSOR_AFTER = 8  # leave the first samples unclamped to find scale

    def __init__(self, q: float):
        self.q = q
        self.estimate = 0.0
        self.scale = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if self.count == 0:
            self.estimate = value
            self.scale = max(abs(value), 1e-9)
            self.count = 1
            return
        self.count += 1
        if (self.count > self.WINSOR_AFTER and self.estimate > 0.0
                and value > self.WINSOR_FACTOR * self.estimate):
            value = self.WINSOR_FACTOR * self.estimate
        # Scale EMA first so early, wildly-off estimates correct fast.
        self.scale += 0.05 * (abs(value - self.estimate) - self.scale)
        step = max(self.scale, 1e-9) * 0.2
        if value > self.estimate:
            self.estimate += step * self.q
        else:
            self.estimate -= step * (1.0 - self.q)
        if self.estimate < 0.0:
            self.estimate = 0.0


class LatencyQuantileTracker:
    """Per-target latency quantile estimates for hedge triggering."""

    def __init__(self, quantile: float = 0.95, min_samples: int = 8):
        if not 0.5 <= quantile < 1.0:
            raise ValueError(f"quantile must be in [0.5, 1), got {quantile}")
        self.quantile = quantile
        self.min_samples = min_samples
        self._mu = new_lock()
        self._targets: Dict[str, _QuantileEstimate] = {}

    def observe(self, target: str, seconds: float) -> None:
        with self._mu:
            est = self._targets.get(target)
            if est is None:
                est = self._targets[target] = _QuantileEstimate(self.quantile)
            est.observe(max(0.0, seconds))

    def value(self, target: str) -> Optional[float]:
        """Current quantile estimate, or None until ``min_samples`` have
        been observed (hedging on a cold estimate is worse than waiting)."""
        with self._mu:
            est = self._targets.get(target)
            if est is None or est.count < self.min_samples:
                return None
            return est.estimate

    def snapshot(self) -> Dict[str, float]:
        with self._mu:
            return {
                t: est.estimate for t, est in self._targets.items()
                if est.count >= self.min_samples
            }


class HedgeBudget:
    """Token bucket capping hedges at a fraction of primary traffic.

    Every primary attempt deposits ``rate`` tokens (so budget is a
    *fraction of real load*, self-scaling with traffic); a hedge spends
    one token. ``burst`` bounds the accumulated credit so an idle hour
    cannot bankroll a hedge storm. ``spend()`` is the only consumer-facing
    call: True = hedge admitted.
    """

    def __init__(self, rate: float = 0.1, burst: float = 8.0,
                 clock: Callable[[], float] = time.monotonic):
        if rate < 0:
            raise ValueError(f"hedge budget rate must be >= 0, got {rate}")
        self.rate = rate
        self.burst = max(1.0, burst)
        self._clock = clock  # retained for debug views / future decay
        self._mu = new_lock()
        self._tokens = min(1.0, self.burst)
        self._primaries = 0
        self._hedges = 0
        self._denied = 0

    def on_primary(self, n: int = 1) -> None:
        with self._mu:
            self._primaries += n
            self._tokens = min(self.burst, self._tokens + self.rate * n)

    def spend(self) -> bool:
        with self._mu:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self._hedges += 1
                return True
            self._denied += 1
            return False

    def hedge_rate(self) -> float:
        """Hedges issued per primary attempt (the bench/SLO signal)."""
        with self._mu:
            return self._hedges / self._primaries if self._primaries else 0.0

    def stats(self) -> dict:
        with self._mu:
            return {
                "primaries": self._primaries,
                "hedges": self._hedges,
                "denied": self._denied,
                "tokens": round(self._tokens, 3),
                "rate": self.rate,
            }
