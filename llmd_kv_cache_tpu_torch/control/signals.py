"""Fleet signal snapshot: everything the policy reads, in one struct.

The controller is deliberately *pull*-shaped: each reconcile round takes
one immutable :class:`FleetSignals` snapshot and decides from it alone,
so a decision is always attributable to a concrete, journalable signal
state (the acceptance criterion: every action's span carries the alert/
signal that caused it).

Sources:

- **SLO state + alert edges** — ``telemetry/slo.py``'s registry; edges
  (fire/clear transitions) rather than level state, so the policy can
  react to a fire exactly once and the journal names the alert.
- **critical-path dominant segment** — the collector's retained traces:
  *where* the request time goes steers *which* actuator helps (score
  fan-out dominant → shard scale-up; decode/admission dominant →
  re-role).
- **handoff residency/starvation stats** — the coordinator's traffic-mix
  EMA + transfer-pressure counters name the starved side.
- **what-if capacity table** — the working-set plane; journaled with
  scale decisions so capacity actions are auditable against the MRC.
- **topology** — current shard membership and pod→role map (what the
  actions mutate; also how a restarted controller verifies in-flight
  actions against reality).

Port of ``llmd_kv_cache_tpu/control/signals.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class FleetSignals:
    """One reconcile round's immutable input snapshot."""

    ts: float = 0.0
    # slo name -> {"severity": None|fast_burn|slow_burn, "burn_slow": x}
    slo: Dict[str, dict] = field(default_factory=dict)
    # New alert edges since the previous round:
    # {"slo", "severity", "edge": fire|clear, "ts", "seq"}
    alert_edges: Tuple[dict, ...] = ()
    # Dominant critical-path segment across retained traces
    # ({"name", "process", "self_time_s"}) or {}.
    dominant_segment: dict = field(default_factory=dict)
    # Handoff coordinator starvation/residency stats (see
    # offload.handoff.HandoffCoordinator.starvation()).
    handoff: dict = field(default_factory=dict)
    # Working-set what-if capacity rows ({"factor", "est_hit_ratio", ...}).
    whatif: Tuple[dict, ...] = ()
    # Overload-shed state per site ({"indexer.score": {"shed_rate": x,
    # "overloaded": bool, "pressure": n}, ...}): a sustained shed rate is
    # the earliest capacity signal the controller gets — requests are
    # already being turned away before any SLO window fills.
    shed: Dict[str, dict] = field(default_factory=dict)
    # Ground-truth audit plane (collector.audit_view()): per-pod
    # phantom/ghost divergence now, calibration error, and the
    # routing-regret rate — lets the policy distinguish "the index is
    # lying about pod X" (divergence → reconcile/demote) from "capacity
    # is short" (shed/SLO burn → scale).
    audit: dict = field(default_factory=dict)
    # Anomaly sentinel level state (telemetry/anomaly.py:
    # AnomalyRegistry.active()): sentinel name -> {"firing", "last_z",
    # "last_value"}. Robust-z detectors over SLI *shape* fire well
    # before a burn-rate window fills, so they are the policy's earliest
    # gray-failure signal (and each fire edge also opens an incident
    # black-box capture).
    anomalies: Dict[str, dict] = field(default_factory=dict)
    # Topology.
    shards: Tuple[str, ...] = ()
    roles: Dict[str, str] = field(default_factory=dict)
    # Highest committed topology epoch observed across the fleet
    # (cluster.membership). 0 when the deployment predates the epoch
    # plane. The controller fences its own proposals against this: a
    # proposal whose epoch the fleet already reached lost the race.
    epoch: int = 0

    def burn(self, slo_name: str) -> float:
        return float((self.slo.get(slo_name) or {}).get("burn_slow", 0.0))

    def severity(self, slo_name: str) -> Optional[str]:
        sev = (self.slo.get(slo_name) or {}).get("severity")
        return str(sev) if sev else None

    def firing(self, slo_name: str) -> bool:
        return self.severity(slo_name) is not None

    def pods_with_role(self, role: str) -> List[str]:
        return sorted(p for p, r in self.roles.items() if r == role)

    def shed_rate(self, site: str) -> float:
        return float((self.shed.get(site) or {}).get("shed_rate", 0.0))

    def anomaly_firing(self, sentinel: str) -> bool:
        return bool((self.anomalies.get(sentinel) or {}).get("firing"))

    def firing_anomalies(self) -> List[str]:
        return sorted(name for name, st in self.anomalies.items()
                      if st.get("firing"))

    def divergent_pods(self) -> List[str]:
        """Pods the divergence audit currently finds out of sync
        (advertising phantom blocks or hiding ghost ones)."""
        return sorted((self.audit.get("divergence") or {}).keys())

    def regret_rate(self) -> float:
        return float(self.audit.get("regret_rate", 0.0))

    def describe(self) -> dict:
        """Compact JSON-able summary (journal/span payloads)."""
        return {
            "ts": self.ts,
            "slo": {
                name: {"severity": st.get("severity"),
                       "burn_slow": round(float(st.get("burn_slow", 0.0)), 3)}
                for name, st in self.slo.items()
            },
            "alert_edges": list(self.alert_edges),
            "dominant_segment": dict(self.dominant_segment),
            "handoff": dict(self.handoff),
            "shed": {site: dict(st) for site, st in self.shed.items()},
            "anomalies": {
                name: dict(st) for name, st in self.anomalies.items()},
            "audit": {
                "divergence": dict(self.audit.get("divergence") or {}),
                "regret_rate": round(self.regret_rate(), 4),
                "mean_abs_error_blocks": round(float(
                    self.audit.get("mean_abs_error_blocks", 0.0)), 3),
            } if self.audit else {},
            "shards": list(self.shards),
            "roles": dict(self.roles),
            "epoch": int(self.epoch),
        }


class CollectorSignalSource:
    """In-process signal source: a live :class:`TelemetryCollector` plus
    topology/handoff hooks (the bench and single-process deployments; the
    HTTP counterpart lives in ``services/fleet_controller.py``).

    The collector is duck-typed (``slos``, ``assembler.retained()``,
    ``workingset_view()``, ``audit_view()``, ``anomalies``): the port has
    no telemetry collector yet (ROADMAP A.8.6), and an ``slo_registry``
    alone is enough."""

    def __init__(
        self,
        collector=None,
        slo_registry=None,
        handoff=None,
        shards: Optional[Callable[[], List[str]]] = None,
        roles: Optional[Callable[[], Dict[str, str]]] = None,
        shedders: Optional[Callable[[], Dict[str, dict]]] = None,
        membership=None,
        clock: Callable[[], float] = time.time,
    ):
        if collector is None and slo_registry is None:
            raise ValueError(
                "CollectorSignalSource needs a collector or an SLO registry")
        self._collector = collector
        self._slos = slo_registry if slo_registry is not None else collector.slos
        self._handoff = handoff
        self._shards = shards or (lambda: [])
        self._roles = roles or (lambda: {})
        # site -> CoDelShedder.stats() dict; typically
        # ``lambda: {s.site: s.stats() for s in shedders}``.
        self._shedders = shedders or (lambda: {})
        # Optional cluster.membership.MembershipTable (the local fleet
        # epoch authority) so polls carry the committed topology epoch.
        self._membership = membership
        self._clock = clock
        self._edge_cursor = -1

    def poll(self) -> FleetSignals:
        slo_state: Dict[str, dict] = {}
        for name, tracker in self._slos.trackers.items():
            cfg = tracker.config
            slo_state[name] = {
                "severity": tracker.alert_severity,
                "burn_slow": tracker.burn_rate(cfg.slow_window),
            }
        edges_payload = self._slos.export_edges_since(self._edge_cursor)
        self._edge_cursor = int(edges_payload.get("next_seq",
                                                  self._edge_cursor))
        dominant: dict = {}
        whatif: Tuple[dict, ...] = ()
        audit: dict = {}
        anomalies: Dict[str, dict] = {}
        if self._collector is not None:
            best = 0.0
            for summary in self._collector.assembler.retained():
                for seg in summary.get("critical_path") or ():
                    if seg.get("self_time_s", 0.0) > best:
                        best = seg["self_time_s"]
                        dominant = {
                            "name": seg.get("name"),
                            "process": seg.get("process"),
                            "self_time_s": seg.get("self_time_s"),
                            "trace_id": summary.get("trace_id"),
                        }
            try:
                whatif = tuple(
                    self._collector.workingset_view().get("whatif") or ())
            except Exception:  # enrichment, never round-fatal  # lint: allow-swallow
                whatif = ()
            try:
                audit = dict(self._collector.audit_view())
            except Exception:  # enrichment, never round-fatal  # lint: allow-swallow
                audit = {}
            registry = getattr(self._collector, "anomalies", None)
            if registry is not None:
                try:
                    anomalies = dict(registry.active())
                except Exception:  # enrichment, never round-fatal  # lint: allow-swallow
                    anomalies = {}
        handoff = {}
        if self._handoff is not None:
            handoff = self._handoff.starvation()
        try:
            shed = dict(self._shedders())
        except Exception:  # enrichment, never round-fatal  # lint: allow-swallow
            shed = {}
        return FleetSignals(
            ts=self._clock(),
            slo=slo_state,
            alert_edges=tuple(edges_payload.get("edges") or ()),
            dominant_segment=dominant,
            handoff=handoff,
            whatif=whatif,
            shed=shed,
            audit=audit,
            anomalies=anomalies,
            shards=tuple(self._shards()),
            roles=dict(self._roles()),
            epoch=(int(self._membership.epoch)
                   if self._membership is not None else 0),
        )
