"""SLO tracking with multi-window burn-rate alerts (fleet collector).

Implements the Google-SRE multiwindow, multi-burn-rate pattern over
threshold SLIs ("TTFT ≤ 2s", "scrape target reachable"): each
:class:`SLOTracker` ingests (good, bad) event counts, maintains sliding
windows, and converts the windowed bad fraction into a **burn rate** —
the multiple of the error budget being consumed:

    burn = bad_fraction(window) / (1 - objective)

Two alert severities:

- **fast_burn** — the short window AND its confirmation window both
  exceed ``fast_threshold`` (default 14.4× ≈ 2% of a 30-day budget in
  1h). The confirmation window suppresses blips; the short window makes
  reset fast once the incident ends.
- **slow_burn** — the long window exceeds ``slow_threshold`` (default
  6× ≈ 5% of a 30-day budget in 6h): a simmering regression.

Everything is clock-injectable and window lengths are constructor
arguments, so unit tests (and the toy-cluster chaos test) drive hours of
"budget history" in milliseconds. Alert state is exported both through
:meth:`debug_view` (the collector's ``/debug/slo``) and the
``kvtpu_slo_*`` metric families.

Port of ``llmd_kv_cache_tpu/telemetry/slo.py``. Its families live on
the port's registry (``metrics.registry``), not on a process-wide
``prometheus_client`` one.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..metrics.registry import Counter, Gauge

from ..utils.lockdep import new_lock

SLO_BURN_RATE = Gauge(
    "kvtpu_slo_burn_rate",
    "Error-budget burn rate per SLO and window",
    ["slo", "window"],
)
SLO_ALERT_ACTIVE = Gauge(
    "kvtpu_slo_alert_active",
    "1 while the SLO's burn-rate alert is firing (by severity)",
    ["slo", "severity"],  # severity: fast_burn|slow_burn
)
SLO_ALERTS = Counter(
    "kvtpu_slo_alerts_total",
    "Burn-rate alert transitions (fired only, not clears)",
    ["slo", "severity"],
)
SLO_BUDGET_REMAINING = Gauge(
    "kvtpu_slo_error_budget_remaining",
    "Fraction of the error budget left over the slow window (1 = untouched)",
    ["slo"],
)


@dataclass(frozen=True)
class SLOConfig:
    """One service-level objective over a threshold SLI."""

    name: str
    objective: float = 0.99  # target good fraction, e.g. 0.99 = 1% budget
    description: str = ""
    # Window lengths in seconds: (short, confirmation) for the fast alert,
    # one long window for the slow alert. Defaults: 5m/1h fast, 6h slow.
    fast_windows: tuple = (300.0, 3600.0)
    slow_window: float = 21600.0
    fast_threshold: float = 14.4
    slow_threshold: float = 6.0

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


@dataclass
class _AlertState:
    severity: Optional[str] = None  # None|fast_burn|slow_burn
    fired_at: Optional[float] = None
    fires: int = 0


class SLOTracker:
    """Sliding-window burn-rate evaluation for one SLO."""

    def __init__(
        self,
        config: SLOConfig,
        clock: Callable[[], float] = time.monotonic,
        on_edge: Optional[Callable[[dict], None]] = None,
    ):
        self.config = config
        self._clock = clock
        self._lock = new_lock()
        # (ts, good, bad) event-count samples, pruned past the slow window.
        self._samples: deque = deque()
        self._alert = _AlertState()
        # Called once per alert transition (fire/clear/severity change)
        # with an edge record — the registry's edge history feed, and the
        # fleet controller's trigger.
        self._on_edge = on_edge

    # -- ingestion ---------------------------------------------------------

    def record(self, good: int, bad: int) -> None:
        """Ingest an SLI observation batch (e.g. one scrape round's delta)."""
        if good <= 0 and bad <= 0:
            return
        now = self._clock()
        with self._lock:
            self._samples.append((now, max(good, 0), max(bad, 0)))
            self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - max(self.config.slow_window, *self.config.fast_windows)
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    # -- readback ----------------------------------------------------------

    def _window_counts(self, window_s: float, now: float) -> tuple:
        lo = now - window_s
        good = bad = 0
        for ts, g, b in self._samples:
            if ts >= lo:
                good += g
                bad += b
        return good, bad

    def burn_rate(self, window_s: float) -> float:
        """bad_fraction(window) / error_budget; 0.0 with no traffic."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            good, bad = self._window_counts(window_s, now)
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / self.config.error_budget

    def evaluate(self) -> dict:
        """Re-evaluate alert state; returns :meth:`debug_view`.

        Fires/clears are edge-triggered: ``kvtpu_slo_alerts_total`` counts
        transitions into an alert, ``kvtpu_slo_alert_active`` mirrors the
        level. fast_burn outranks slow_burn when both conditions hold.
        """
        cfg = self.config
        short, confirm = cfg.fast_windows
        burns = {
            "short": self.burn_rate(short),
            "confirm": self.burn_rate(confirm),
            "slow": self.burn_rate(cfg.slow_window),
        }
        severity: Optional[str] = None
        if burns["short"] >= cfg.fast_threshold and burns["confirm"] >= cfg.fast_threshold:
            severity = "fast_burn"
        elif burns["slow"] >= cfg.slow_threshold:
            severity = "slow_burn"
        edge: Optional[dict] = None
        with self._lock:
            prev = self._alert.severity
            if severity != prev:
                if severity is not None:
                    self._alert.fires += 1
                    self._alert.fired_at = self._clock()
                    SLO_ALERTS.labels(cfg.name, severity).inc()
                self._alert.severity = severity
                if severity is None:
                    self._alert.fired_at = None
                edge = {
                    "ts": self._clock(),
                    "slo": cfg.name,
                    "edge": "fire" if severity is not None else "clear",
                    "severity": severity if severity is not None else prev,
                    "prev_severity": prev,
                    "burns": {k: round(v, 3) for k, v in burns.items()},
                }
        if edge is not None and self._on_edge is not None:
            # Outside the lock: the sink may re-enter tracker readbacks.
            self._on_edge(edge)
        for sev in ("fast_burn", "slow_burn"):
            SLO_ALERT_ACTIVE.labels(cfg.name, sev).set(1.0 if severity == sev else 0.0)
        SLO_BURN_RATE.labels(cfg.name, f"{int(short)}s").set(burns["short"])
        SLO_BURN_RATE.labels(cfg.name, f"{int(confirm)}s").set(burns["confirm"])
        SLO_BURN_RATE.labels(cfg.name, f"{int(cfg.slow_window)}s").set(burns["slow"])
        budget_left = max(0.0, 1.0 - self._budget_spent_fraction())
        SLO_BUDGET_REMAINING.labels(cfg.name).set(budget_left)
        return self.debug_view(burns=burns, budget_remaining=budget_left)

    def _budget_spent_fraction(self) -> float:
        """Fraction of the slow-window error budget already consumed."""
        now = self._clock()
        with self._lock:
            good, bad = self._window_counts(self.config.slow_window, now)
        total = good + bad
        if total <= 0:
            return 0.0
        return min(1.0, (bad / total) / self.config.error_budget)

    @property
    def alert_severity(self) -> Optional[str]:
        with self._lock:
            return self._alert.severity

    def debug_view(
        self, burns: Optional[dict] = None, budget_remaining: Optional[float] = None
    ) -> dict:
        cfg = self.config
        if burns is None:
            short, confirm = cfg.fast_windows
            burns = {
                "short": self.burn_rate(short),
                "confirm": self.burn_rate(confirm),
                "slow": self.burn_rate(cfg.slow_window),
            }
        if budget_remaining is None:
            budget_remaining = max(0.0, 1.0 - self._budget_spent_fraction())
        with self._lock:
            alert = {
                "severity": self._alert.severity,
                "fired_at": self._alert.fired_at,
                "fires": self._alert.fires,
            }
        return {
            "slo": cfg.name,
            "objective": cfg.objective,
            "description": cfg.description,
            "burn_rates": {
                f"{int(cfg.fast_windows[0])}s": round(burns["short"], 3),
                f"{int(cfg.fast_windows[1])}s": round(burns["confirm"], 3),
                f"{int(cfg.slow_window)}s": round(burns["slow"], 3),
            },
            "thresholds": {
                "fast": cfg.fast_threshold,
                "slow": cfg.slow_threshold,
            },
            "error_budget_remaining": round(budget_remaining, 4),
            "alert": alert,
        }


@dataclass
class SLORegistry:
    """The collector's set of trackers, evaluated as one unit.

    Besides level state (:meth:`debug_view`), the registry keeps a
    bounded, seq-stamped **edge history** of alert transitions so remote
    consumers — the fleet controller, ``/debug/slo?since=`` pullers —
    can react to each fire/clear exactly once, with the same cursor
    semantics as ``/debug/spans`` (``seq > since``; ``next_seq`` is the
    last stamped seq; ring-bounded with a drop counter).
    """

    clock: Callable[[], float] = time.monotonic
    trackers: Dict[str, SLOTracker] = field(default_factory=dict)
    max_edges: int = 512
    _edges: deque = field(default_factory=deque, repr=False)
    _edge_lock: threading.Lock = field(
        default_factory=lambda: new_lock(), repr=False)
    _edge_seq: int = field(default=0, repr=False)
    edges_dropped: int = 0

    def add(self, config: SLOConfig) -> SLOTracker:
        tracker = SLOTracker(
            config, clock=self.clock, on_edge=self._record_edge)
        self.trackers[config.name] = tracker
        return tracker

    def get(self, name: str) -> Optional[SLOTracker]:
        return self.trackers.get(name)

    def evaluate_all(self) -> dict:
        return {name: t.evaluate() for name, t in self.trackers.items()}

    def debug_view(self) -> dict:
        return {name: t.debug_view() for name, t in self.trackers.items()}

    # -- alert edge history ------------------------------------------------

    def _record_edge(self, edge: dict) -> None:
        with self._edge_lock:
            edge = dict(edge)
            edge["seq"] = self._edge_seq
            self._edge_seq += 1
            self._edges.append(edge)
            while len(self._edges) > self.max_edges:
                self._edges.popleft()
                self.edges_dropped += 1

    def export_edges_since(self, since: int = -1) -> dict:
        """Alert edges with ``seq > since`` plus the resume cursor
        (``/debug/slo?since=`` payload; non-destructive, per-puller)."""
        with self._edge_lock:
            edges = [dict(e) for e in self._edges if e["seq"] > since]
            return {
                "edges": edges,
                "next_seq": self._edge_seq - 1,
                "dropped": self.edges_dropped,
            }
