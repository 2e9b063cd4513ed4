"""Controller actions and the pluggable actuator interface.

An :class:`Action` is a *concrete, idempotent* topology mutation — the
policy's output and the journal's subject. Actuators turn actions into
effects; two ship in-tree:

- :class:`InProcessActuator` — callables wired at construction (the
  bench's simulated fleet, single-process deployments, tests).
- :class:`AdminPlaneActuator` — drives *remote* pods over the stdlib
  admin plane: POST ``/debug/role?set=`` re-roles an engine pod, POST
  ``/debug/drain`` triggers the graceful drain (``recovery/drain.py``). Shard membership
  changes stay with the deployment layer (the ring is rebuilt from the
  membership list), so add/remove-shard calls go through an injected
  callback there too.

Actuators raise on failure; the controller journals the failure and the
cooldown prevents an immediate retry storm.

Port of ``llmd_kv_cache_tpu/control/actions.py`` (stdlib ``urllib``
only).
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..utils.logging import get_logger

logger = get_logger("control.actions")

ACTION_ADD_SHARD = "add_shard"
ACTION_REMOVE_SHARD = "remove_shard"
ACTION_SET_ROLE = "set_role"
ACTION_DRAIN_POD = "drain_pod"

ACTION_KINDS = (
    ACTION_ADD_SHARD,
    ACTION_REMOVE_SHARD,
    ACTION_SET_ROLE,
    ACTION_DRAIN_POD,
)

# Kinds that change ring membership and therefore mint a new topology
# epoch (two-phase propose→commit in the controller). Re-roles and
# drains ride the *current* epoch — they do not move partitions.
TOPOLOGY_KINDS = (
    ACTION_ADD_SHARD,
    ACTION_REMOVE_SHARD,
)


@dataclass(frozen=True)
class Action:
    """One concrete topology mutation, with its causing signal attached."""

    kind: str  # one of ACTION_KINDS
    target: str  # shard id / pod id
    params: dict = field(default_factory=dict)  # e.g. {"role": "decode"}
    reason: str = ""  # one-line operator-readable cause
    signal: dict = field(default_factory=dict)  # alert/stat snapshot

    def action_id(self, seq: int) -> str:
        return f"{self.kind}:{self.target}:{seq}"

    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "target": self.target,
            "params": dict(self.params),
            "reason": self.reason,
            "signal": dict(self.signal),
        }


class Actuator:
    """The controller's hands. ``apply`` returns a JSON-able result dict
    and raises on failure."""

    def apply(self, action: Action) -> dict:
        raise NotImplementedError


class InProcessActuator(Actuator):
    """Callable-backed actuator (tests, bench sim, single-process runs)."""

    def __init__(
        self,
        add_shard: Optional[Callable[[str], object]] = None,
        remove_shard: Optional[Callable[[str], object]] = None,
        set_role: Optional[Callable[[str, str], object]] = None,
        drain_pod: Optional[Callable[[str], object]] = None,
    ):
        self._add_shard = add_shard
        self._remove_shard = remove_shard
        self._set_role = set_role
        self._drain_pod = drain_pod
        self.applied: list = []  # (kind, target, params) audit trail

    def apply(self, action: Action) -> dict:
        handler = {
            ACTION_ADD_SHARD: self._add_shard,
            ACTION_REMOVE_SHARD: self._remove_shard,
            ACTION_SET_ROLE: self._set_role,
            ACTION_DRAIN_POD: self._drain_pod,
        }.get(action.kind)
        if handler is None:
            raise ValueError(f"no handler wired for action {action.kind!r}")
        if action.kind == ACTION_SET_ROLE:
            result = handler(action.target, str(action.params.get("role", "")))
        else:
            result = handler(action.target)
        self.applied.append((action.kind, action.target, dict(action.params)))
        if isinstance(result, dict):
            return result
        return {"ok": True, "result": repr(result) if result is not None else ""}


class AdminPlaneActuator(Actuator):
    """Acts on remote pods through their admin endpoints.

    ``pod_addresses`` maps pod/target id → ``host:port`` of the pod's
    admin server. Re-role and drain go over HTTP POST (the guarded
    endpoints of ``services/admin.py``); shard membership changes call
    the injected deployment hooks — the controller cannot conjure a new
    shard process itself, but it *can* tell the deployment layer to.
    """

    def __init__(
        self,
        pod_addresses: Dict[str, str],
        add_shard: Optional[Callable[[str], object]] = None,
        remove_shard: Optional[Callable[[str], object]] = None,
        timeout_s: float = 5.0,
    ):
        self.pod_addresses = dict(pod_addresses)
        self._add_shard = add_shard
        self._remove_shard = remove_shard
        self.timeout_s = timeout_s

    def _post(self, address: str, path: str, params: dict) -> dict:
        query = urllib.parse.urlencode(params)
        url = f"http://{address}{path}"
        if query:
            url += f"?{query}"
        req = urllib.request.Request(url, data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            payload = json.loads(resp.read() or b"{}")
        return payload if isinstance(payload, dict) else {"result": payload}

    def apply(self, action: Action) -> dict:
        if action.kind == ACTION_SET_ROLE:
            address = self.pod_addresses.get(action.target)
            if not address:
                raise ValueError(f"no admin address for pod {action.target!r}")
            return self._post(address, "/debug/role",
                              {"set": str(action.params.get("role", ""))})
        if action.kind == ACTION_DRAIN_POD:
            address = self.pod_addresses.get(action.target)
            if not address:
                raise ValueError(f"no admin address for pod {action.target!r}")
            return self._post(address, "/debug/drain", {})
        if action.kind == ACTION_ADD_SHARD:
            if self._add_shard is None:
                raise ValueError("add_shard deployment hook not wired")
            result = self._add_shard(action.target)
            return result if isinstance(result, dict) else {"ok": True}
        if action.kind == ACTION_REMOVE_SHARD:
            if self._remove_shard is None:
                raise ValueError("remove_shard deployment hook not wired")
            result = self._remove_shard(action.target)
            return result if isinstance(result, dict) else {"ok": True}
        raise ValueError(f"unknown action kind {action.kind!r}")
