"""Decision policy: hysteresis bands, cooldown timers, starved-side math.

The policy is a pure-ish function of one :class:`FleetSignals` snapshot
plus its own small anti-flap state. Three rules:

- **indexer shard scale-up/down** — driven by the ``score_latency``
  SLO's slow-window burn rate (and its firing alert). The up band
  (``score_burn_scale_up``) and down band (``score_burn_scale_down``)
  form the hysteresis gap: between them the policy holds still, so a
  burn rate oscillating around one threshold cannot flap the ring.
  Scale-down emits a graceful drain of the victim *before* the
  membership change (drain, then ring leave, < 2/N key movement).
- **engine re-role** — the handoff coordinator's traffic-mix EMA
  (prefill-token fraction) vs the provisioned role split. When offered
  mix diverges from capacity past ``role_imbalance_act``, one pod flips
  from the over-provisioned role to the starved one; the rule re-arms
  only once the imbalance falls under ``role_imbalance_rearm``.
- **confirmation + cooldown** — every rule must hold for
  ``confirm_rounds`` consecutive polls and respect a per-action-kind
  cooldown. The *global* action budget is the controller's job (it also
  covers actuator failures and restarts), not the policy's.

All state is reconstructible: the controller replays journal timestamps
into :meth:`notify_action` after a restart so cooldowns survive crashes.

Port of ``llmd_kv_cache_tpu/control/policy.py``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from .actions import (
    ACTION_ADD_SHARD,
    ACTION_DRAIN_POD,
    ACTION_REMOVE_SHARD,
    ACTION_SET_ROLE,
    Action,
)
from .config import ControllerConfig
from .signals import FleetSignals

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


class Hysteresis:
    """Two-band trigger with consecutive-round confirmation.

    ``direction="above"``: fires once ``value >= act`` held for
    ``confirm_rounds`` polls; stays disarmed until ``value <= rearm``.
    ``direction="below"`` mirrors it (fires at/under ``act``, re-arms
    at/over ``rearm``). The gap between the bands is the no-flap zone.
    """

    def __init__(self, act: float, rearm: float, confirm_rounds: int = 1,
                 direction: str = "above"):
        if direction not in ("above", "below"):
            raise ValueError(f"bad hysteresis direction {direction!r}")
        if direction == "above" and rearm > act:
            raise ValueError("above-band hysteresis needs rearm <= act")
        if direction == "below" and rearm < act:
            raise ValueError("below-band hysteresis needs rearm >= act")
        self.act = act
        self.rearm = rearm
        self.confirm_rounds = max(1, confirm_rounds)
        self.direction = direction
        self.armed = True
        self.streak = 0

    def _past_act(self, value: float) -> bool:
        return value >= self.act if self.direction == "above" \
            else value <= self.act

    def _past_rearm(self, value: float) -> bool:
        return value <= self.rearm if self.direction == "above" \
            else value >= self.rearm

    def update(self, value: float) -> bool:
        """Feed one poll's value; True exactly when the trigger fires."""
        if not self.armed:
            if self._past_rearm(value):
                self.armed = True
                self.streak = 0
            return False
        if self._past_act(value):
            self.streak += 1
            if self.streak >= self.confirm_rounds:
                self.armed = False
                self.streak = 0
                return True
            return False
        self.streak = 0
        return False

    def debug(self) -> dict:
        return {
            "act": self.act,
            "rearm": self.rearm,
            "direction": self.direction,
            "armed": self.armed,
            "streak": self.streak,
            "confirm_rounds": self.confirm_rounds,
        }


class Cooldown:
    """Per-key minimum spacing between actions."""

    def __init__(self, period_s: float,
                 clock: Callable[[], float] = time.time):
        self.period_s = period_s
        self._clock = clock
        self._last: Dict[str, float] = {}

    def ready(self, key: str = "") -> bool:
        return self.remaining(key) <= 0.0

    def remaining(self, key: str = "") -> float:
        last = self._last.get(key)
        if last is None:
            return 0.0
        return max(0.0, self.period_s - (self._clock() - last))

    def stamp(self, key: str = "", ts: Optional[float] = None) -> None:
        ts = self._clock() if ts is None else ts
        self._last[key] = max(self._last.get(key, 0.0), ts)

    def debug(self) -> dict:
        return {
            "period_s": self.period_s,
            "remaining_s": {k: round(self.remaining(k), 2)
                            for k in self._last},
        }


def next_shard_name(shards) -> str:
    """Deterministic fresh shard id: numeric-suffix max + 1."""
    best = -1
    for shard in shards:
        tail = shard.rsplit("-", 1)[-1]
        if tail.isdigit():
            best = max(best, int(tail))
    return f"shard-{best + 1 if best >= 0 else len(list(shards))}"


class ControlPolicy:
    """Signals → zero or more actions, with anti-flap state."""

    def __init__(self, config: ControllerConfig,
                 clock: Callable[[], float] = time.time):
        self.cfg = config
        self._clock = clock
        self._scale_up = Hysteresis(
            act=config.score_burn_scale_up,
            rearm=config.score_burn_scale_down,
            confirm_rounds=config.confirm_rounds,
            direction="above",
        )
        self._scale_down = Hysteresis(
            act=config.score_burn_scale_down,
            rearm=config.score_burn_scale_up,
            confirm_rounds=max(config.confirm_rounds, 2),
            direction="below",
        )
        # Directional re-role triggers on the signed mix-vs-capacity
        # imbalance: positive = prefill starved, negative = decode starved.
        self._role_prefill = Hysteresis(
            act=config.role_imbalance_act,
            rearm=config.role_imbalance_rearm,
            confirm_rounds=config.confirm_rounds,
            direction="above",
        )
        self._role_decode = Hysteresis(
            act=-config.role_imbalance_act,
            rearm=-config.role_imbalance_rearm,
            confirm_rounds=config.confirm_rounds,
            direction="below",
        )
        self._cooldowns = {
            ACTION_ADD_SHARD: Cooldown(config.shard_cooldown_s, clock),
            ACTION_REMOVE_SHARD: Cooldown(config.shard_cooldown_s, clock),
            ACTION_SET_ROLE: Cooldown(config.role_cooldown_s, clock),
            ACTION_DRAIN_POD: Cooldown(config.drain_cooldown_s, clock),
        }

    # -- state restoration -------------------------------------------------

    def notify_action(self, kind: str, ts: Optional[float] = None) -> None:
        """Stamp a cooldown (at decision time, and from journal replay)."""
        cd = self._cooldowns.get(kind)
        if cd is not None:
            cd.stamp("", ts)

    def cooldown_ready(self, kind: str) -> bool:
        cd = self._cooldowns.get(kind)
        return cd is None or cd.ready()

    # -- the decision ------------------------------------------------------

    def decide(self, signals: FleetSignals) -> List[Action]:
        actions: List[Action] = []
        actions.extend(self._decide_shards(signals))
        actions.extend(self._decide_roles(signals))
        return actions

    def _score_signal(self, signals: FleetSignals) -> dict:
        return {
            "slo": "score_latency",
            "severity": signals.severity("score_latency"),
            "burn_slow": round(signals.burn("score_latency"), 3),
            "alert_edges": [e for e in signals.alert_edges
                            if e.get("slo") == "score_latency"],
            "dominant_segment": dict(signals.dominant_segment),
            "whatif": list(signals.whatif),
        }

    def _decide_shards(self, signals: FleetSignals) -> List[Action]:
        burn = signals.burn("score_latency")
        # A firing alert counts as a saturated burn signal even when the
        # slow window hasn't caught up yet (fast_burn fires first).
        effective = burn
        if signals.firing("score_latency"):
            effective = max(effective, self.cfg.score_burn_scale_up)
        out: List[Action] = []
        up = self._scale_up.update(effective)
        down = self._scale_down.update(effective)
        n = len(signals.shards)
        if up and n and n < self.cfg.max_shards \
                and self.cooldown_ready(ACTION_ADD_SHARD):
            target = next_shard_name(signals.shards)
            self.notify_action(ACTION_ADD_SHARD)
            out.append(Action(
                kind=ACTION_ADD_SHARD,
                target=target,
                params={"bootstrap": "snapshot"},
                reason=(f"score_latency burn {burn:.2f} >= "
                        f"{self.cfg.score_burn_scale_up:.2f} "
                        f"({n} -> {n + 1} shards)"),
                signal=self._score_signal(signals),
            ))
        elif down and n > self.cfg.min_shards \
                and not signals.firing("score_latency") \
                and self.cooldown_ready(ACTION_REMOVE_SHARD):
            victim = sorted(signals.shards)[-1]
            self.notify_action(ACTION_REMOVE_SHARD)
            self.notify_action(ACTION_DRAIN_POD)
            signal = self._score_signal(signals)
            out.append(Action(
                kind=ACTION_DRAIN_POD,
                target=victim,
                params={"deadline_s": self.cfg.drain_deadline_s},
                reason=(f"drain ahead of scale-down: score_latency burn "
                        f"{burn:.2f} <= {self.cfg.score_burn_scale_down:.2f}"),
                signal=signal,
            ))
            out.append(Action(
                kind=ACTION_REMOVE_SHARD,
                target=victim,
                reason=(f"score_latency burn {burn:.2f} <= "
                        f"{self.cfg.score_burn_scale_down:.2f} "
                        f"({n} -> {n - 1} shards)"),
                signal=signal,
            ))
        return out

    def _decide_roles(self, signals: FleetSignals) -> List[Action]:
        mix = (signals.handoff.get("mix") or {})
        offered = mix.get("prefill_fraction")
        prefill = signals.pods_with_role(ROLE_PREFILL)
        decode = signals.pods_with_role(ROLE_DECODE)
        total = len(prefill) + len(decode)
        if offered is None or total == 0:
            return []
        provisioned = len(prefill) / total
        imbalance = float(offered) - provisioned
        prefill_starved = self._role_prefill.update(imbalance)
        decode_starved = self._role_decode.update(imbalance)
        if not self.cooldown_ready(ACTION_SET_ROLE):
            return []
        signal = {
            "slo": "ttft",
            "severity": signals.severity("ttft"),
            "burn_slow": round(signals.burn("ttft"), 3),
            "alert_edges": [e for e in signals.alert_edges
                            if e.get("slo") == "ttft"],
            "handoff": dict(signals.handoff),
            "offered_prefill_fraction": round(float(offered), 3),
            "provisioned_prefill_fraction": round(provisioned, 3),
            "imbalance": round(imbalance, 3),
        }
        if prefill_starved and len(decode) > self.cfg.min_decode_pods:
            donor = decode[-1]
            self.notify_action(ACTION_SET_ROLE)
            return [Action(
                kind=ACTION_SET_ROLE,
                target=donor,
                params={"role": ROLE_PREFILL},
                reason=(f"prefill starved: offered mix {offered:.2f} vs "
                        f"provisioned {provisioned:.2f} "
                        f"(imbalance {imbalance:+.2f})"),
                signal=signal,
            )]
        if decode_starved and len(prefill) > self.cfg.min_prefill_pods:
            donor = prefill[-1]
            self.notify_action(ACTION_SET_ROLE)
            return [Action(
                kind=ACTION_SET_ROLE,
                target=donor,
                params={"role": ROLE_DECODE},
                reason=(f"decode starved: offered mix {offered:.2f} vs "
                        f"provisioned {provisioned:.2f} "
                        f"(imbalance {imbalance:+.2f})"),
                signal=signal,
            )]
        return []

    # -- introspection -----------------------------------------------------

    def debug_view(self) -> dict:
        return {
            "hysteresis": {
                "shard_scale_up": self._scale_up.debug(),
                "shard_scale_down": self._scale_down.debug(),
                "role_prefill_starved": self._role_prefill.debug(),
                "role_decode_starved": self._role_decode.debug(),
            },
            "cooldowns": {
                kind: cd.debug() for kind, cd in self._cooldowns.items()
            },
        }
