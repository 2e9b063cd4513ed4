"""Fleet controller service: the control loop as a deployable sidecar.

Wires the ``control/`` subsystem to *remote* planes over HTTP:

- **senses** — :class:`RemoteSignalSource` polls the telemetry
  collector's admin endpoints (``/debug/slo`` level + ``?since=`` edge
  cursor, ``/debug/traces`` critical paths, ``/debug/workingset``
  what-if table) and each engine pod's ``/debug/role``.
- **hands** — :class:`~..control.actions.AdminPlaneActuator` POSTs
  ``/debug/role?set=`` and ``/debug/drain`` to pod admin planes; shard
  membership changes go through injected deployment hooks (the ring is
  rebuilt from the membership list).
- **its own admin plane** — ``/debug/controller`` (the controller's
  debug view: last actions with causing signals, cooldown state, dry-run
  would-have-acted records) for ``kvdiag --fleet``.

Every remote read degrades to an empty signal rather than killing the
round: a controller that cannot see must hold still, not crash — the
cooldowns and hysteresis make "no signal" a safe no-op.

Port of ``llmd_kv_cache_tpu/services/fleet_controller.py`` (stdlib
``urllib`` only).
"""

from __future__ import annotations

import json
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..control.actions import AdminPlaneActuator
from ..control.config import ControllerConfig
from ..control.controller import FleetController
from ..control.signals import FleetSignals
from ..utils.logging import get_logger
from .admin import AdminServer

logger = get_logger("services.fleet_controller")


@dataclass(frozen=True)
class FleetControllerServiceConfig:
    """Service-level knobs around the ``controllerConfig`` policy block."""

    # host:port of the telemetry collector's admin plane.
    collector_address: str = ""
    # pod id -> host:port of that pod's admin plane (role reads + POSTs).
    pod_admin: Dict[str, str] = field(default_factory=dict)
    # This service's own admin endpoint (0 = off).
    admin_port: int = 0
    host: str = "127.0.0.1"
    http_timeout_s: float = 5.0
    controller: ControllerConfig = field(default_factory=ControllerConfig)

    @classmethod
    def from_dict(cls, data: Optional[dict]) -> "FleetControllerServiceConfig":
        if not data:
            return cls()

        def k(camel: str, snake: str, default):
            if camel in data:
                return data[camel]
            if snake in data:
                return data[snake]
            return default

        d = cls()
        return cls(
            collector_address=str(
                k("collectorAddress", "collector_address",
                  d.collector_address)),
            pod_admin=dict(k("podAdmin", "pod_admin", {})),
            admin_port=int(k("adminPort", "admin_port", d.admin_port)),
            host=str(k("host", "host", d.host)),
            http_timeout_s=float(
                k("httpTimeoutS", "http_timeout_s", d.http_timeout_s)),
            controller=ControllerConfig.from_dict(
                k("controllerConfig", "controller", None)),
        )


def _get_json(address: str, path: str, timeout_s: float) -> Optional[dict]:
    try:
        with urllib.request.urlopen(
                f"http://{address}{path}", timeout=timeout_s) as resp:
            payload = json.loads(resp.read() or b"{}")
        return payload if isinstance(payload, dict) else None
    except Exception as exc:  # degraded sense, not a crash  # lint: allow-swallow
        logger.debug("fleet controller: GET %s%s failed: %r",
                     address, path, exc)
        return None


class RemoteSignalSource:
    """HTTP counterpart of :class:`~..control.signals.CollectorSignalSource`."""

    def __init__(
        self,
        collector_address: str,
        pod_admin: Optional[Dict[str, str]] = None,
        shards: Optional[Callable[[], List[str]]] = None,
        timeout_s: float = 5.0,
        clock: Callable[[], float] = time.time,
    ):
        self.collector_address = collector_address
        self.pod_admin = dict(pod_admin or {})
        self._shards = shards or (lambda: [])
        self.timeout_s = timeout_s
        self._clock = clock
        self._edge_cursor = -1
        self.fetch_errors = 0

    def _get(self, address: str, path: str) -> Optional[dict]:
        payload = _get_json(address, path, self.timeout_s)
        if payload is None:
            self.fetch_errors += 1
        return payload

    def poll(self) -> FleetSignals:
        slo_state: Dict[str, dict] = {}
        edges: tuple = ()
        dominant: dict = {}
        whatif: tuple = ()
        audit: dict = {}
        if self.collector_address:
            level = self._get(self.collector_address, "/debug/slo") or {}
            for name, st in level.items():
                if not isinstance(st, dict):
                    continue
                burns = st.get("burn_rates") or {}
                # Insertion order is short, confirm, slow (slo.debug_view).
                slow = list(burns.values())[-1] if burns else 0.0
                slo_state[name] = {
                    "severity": (st.get("alert") or {}).get("severity"),
                    "burn_slow": float(slow),
                }
            edge_payload = self._get(
                self.collector_address,
                f"/debug/slo?since={self._edge_cursor}") or {}
            edges = tuple(edge_payload.get("edges") or ())
            self._edge_cursor = int(
                edge_payload.get("next_seq", self._edge_cursor))
            traces = self._get(self.collector_address, "/debug/traces") or {}
            best = 0.0
            for summary in traces.get("retained") or ():
                for seg in summary.get("critical_path") or ():
                    if float(seg.get("self_time_s", 0.0)) > best:
                        best = float(seg["self_time_s"])
                        dominant = {
                            "name": seg.get("name"),
                            "process": seg.get("process"),
                            "self_time_s": seg.get("self_time_s"),
                            "trace_id": summary.get("trace_id"),
                        }
            ws = self._get(self.collector_address, "/debug/workingset") or {}
            whatif = tuple(ws.get("whatif") or ())
            # The collector's /debug/audit is the joined score-vs-reality
            # view (pods serve their raw rings under the same path); an
            # older collector without it degrades to no audit signal.
            audit = self._get(self.collector_address, "/debug/audit") or {}
        roles: Dict[str, str] = {}
        handoff: dict = {}
        epoch = 0
        for pod, address in self.pod_admin.items():
            # Per-pod membership view: the max committed epoch across the
            # fleet is the controller's fence source — a warm-restarted
            # controller learns where topology actually is before acting.
            mem = self._get(address, "/debug/membership")
            if mem:
                try:
                    epoch = max(epoch, int(mem.get("epoch", 0) or 0))
                except (TypeError, ValueError):  # lint: allow-swallow (malformed epoch from one pod degrades to unstamped, not a dead poll)
                    pass
            view = self._get(address, "/debug/role")
            if not view:
                continue
            roles[pod] = str(view.get("role", ""))
            starve = view.get("starvation")
            if isinstance(starve, dict):
                # Merge per-pod mixes sample-weighted into one fleet EMA.
                mix = starve.get("mix") or {}
                frac, n = mix.get("prefill_fraction"), int(
                    mix.get("samples") or 0)
                if frac is not None and n > 0:
                    agg = handoff.setdefault(
                        "mix", {"prefill_fraction": 0.0, "samples": 0})
                    total = agg["samples"] + n
                    agg["prefill_fraction"] = (
                        agg["prefill_fraction"] * agg["samples"]
                        + float(frac) * n) / total
                    agg["samples"] = total
                for key in ("transfer_queue_depth", "in_flight_jobs"):
                    handoff[key] = handoff.get(key, 0) + int(
                        starve.get(key) or 0)
                if starve.get("starved_side"):
                    handoff["starved_side"] = starve["starved_side"]
        return FleetSignals(
            ts=self._clock(),
            slo=slo_state,
            alert_edges=edges,
            dominant_segment=dominant,
            handoff=handoff,
            whatif=whatif,
            audit=audit,
            shards=tuple(self._shards()),
            roles=roles,
            epoch=epoch,
        )


class FleetControllerService:
    """The deployable bundle: remote source + actuator + loop + admin."""

    def __init__(
        self,
        cfg: FleetControllerServiceConfig,
        shards: Optional[Callable[[], List[str]]] = None,
        add_shard: Optional[Callable[[str], object]] = None,
        remove_shard: Optional[Callable[[str], object]] = None,
        clock: Callable[[], float] = time.time,
        membership=None,
    ):
        self.cfg = cfg
        self.source = RemoteSignalSource(
            collector_address=cfg.collector_address,
            pod_admin=cfg.pod_admin,
            shards=shards,
            timeout_s=cfg.http_timeout_s,
            clock=clock,
        )
        self.actuator = AdminPlaneActuator(
            pod_addresses=cfg.pod_admin,
            add_shard=add_shard,
            remove_shard=remove_shard,
            timeout_s=cfg.http_timeout_s,
        )
        self.controller = FleetController(
            self.source, self.actuator, config=cfg.controller, clock=clock,
            membership=membership)
        self._admin: Optional[AdminServer] = None

    def start(self) -> None:
        if self.cfg.admin_port > 0 and self._admin is None:
            self._admin = AdminServer(
                port=self.cfg.admin_port, host=self.cfg.host,
                expose_debug=True)
            self._admin.register_debug(
                "controller", self.controller.debug_view)
            self._admin.start()
        self.controller.start()

    def stop(self) -> None:
        self.controller.stop()
        if self._admin is not None:
            self._admin.stop()
            self._admin = None

    @property
    def admin_port(self) -> int:
        return self._admin.port if self._admin is not None else 0
