"""``controllerConfig`` block: the fleet controller's knobs.

Every threshold here is a *pair* (act / re-arm) or a timer, because the
controller's contract is "never flap": a signal must cross the act band,
stay there for ``confirmRounds`` consecutive reconcile rounds, survive
the per-action cooldown, and fit inside the global action budget before
anything touches the cluster. Crossing back matters too — hysteresis
only re-arms once the signal falls through the (lower) re-arm band, so a
value oscillating around one threshold produces exactly one action.

Port of ``llmd_kv_cache_tpu/control/config.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ControllerConfig:
    """Fleet-controller policy + loop knobs (camelCase in config files)."""

    # Reconcile loop.
    loop_interval_s: float = 5.0
    # Emit would-have-acted journal records instead of touching the
    # cluster (safe-rollout mode; kvdiag shows the records).
    dry_run: bool = False
    # Append-only action journal (the recovery journal's framed format). Empty = no
    # persistence (the controller still works, but a restart forgets
    # cooldowns/in-flight actions).
    journal_path: str = ""
    # Global action budget: at most this many *executed* actions per
    # budget window, across every action kind. The last backstop against
    # a confused policy thrashing the fleet.
    action_budget: int = 8
    budget_window_s: float = 600.0
    # A decision must hold for this many consecutive reconcile rounds
    # before the action fires (blip suppression ahead of hysteresis).
    confirm_rounds: int = 2

    # -- indexer shard scaling (HashRing join/leave) ----------------------
    # Act when the score_latency SLO's slow-window burn rate crosses
    # scale_up; re-arm / scale down only once it falls under scale_down.
    score_burn_scale_up: float = 1.0
    score_burn_scale_down: float = 0.25
    min_shards: int = 1
    max_shards: int = 16
    shard_cooldown_s: float = 120.0

    # -- engine pod re-roling (prefill <-> decode) ------------------------
    # Act when the offered traffic mix (handoff coordinator's EMA of the
    # prefill-token fraction) diverges from the provisioned role split by
    # more than role_imbalance_act; re-arm under role_imbalance_rearm.
    role_imbalance_act: float = 0.20
    role_imbalance_rearm: float = 0.10
    min_prefill_pods: int = 1
    min_decode_pods: int = 1
    role_cooldown_s: float = 60.0

    # -- scale-down safety ------------------------------------------------
    # Pods are drained (``recovery/drain.py``) before shard removal; the
    # drain itself is also cooldown-guarded.
    drain_cooldown_s: float = 120.0
    drain_deadline_s: float = 10.0

    # Bound on remembered dry-run / executed action history (kvdiag).
    history: int = 64

    @classmethod
    def from_dict(cls, data: Optional[dict]) -> "ControllerConfig":
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
            loop_interval_s=float(
                k("loopIntervalS", "loop_interval_s", d.loop_interval_s)),
            dry_run=bool(k("dryRun", "dry_run", d.dry_run)),
            journal_path=str(k("journalPath", "journal_path", d.journal_path)),
            action_budget=int(
                k("actionBudget", "action_budget", d.action_budget)),
            budget_window_s=float(
                k("budgetWindowS", "budget_window_s", d.budget_window_s)),
            confirm_rounds=int(
                k("confirmRounds", "confirm_rounds", d.confirm_rounds)),
            score_burn_scale_up=float(
                k("scoreBurnScaleUp", "score_burn_scale_up",
                  d.score_burn_scale_up)),
            score_burn_scale_down=float(
                k("scoreBurnScaleDown", "score_burn_scale_down",
                  d.score_burn_scale_down)),
            min_shards=int(k("minShards", "min_shards", d.min_shards)),
            max_shards=int(k("maxShards", "max_shards", d.max_shards)),
            shard_cooldown_s=float(
                k("shardCooldownS", "shard_cooldown_s", d.shard_cooldown_s)),
            role_imbalance_act=float(
                k("roleImbalanceAct", "role_imbalance_act",
                  d.role_imbalance_act)),
            role_imbalance_rearm=float(
                k("roleImbalanceRearm", "role_imbalance_rearm",
                  d.role_imbalance_rearm)),
            min_prefill_pods=int(
                k("minPrefillPods", "min_prefill_pods", d.min_prefill_pods)),
            min_decode_pods=int(
                k("minDecodePods", "min_decode_pods", d.min_decode_pods)),
            role_cooldown_s=float(
                k("roleCooldownS", "role_cooldown_s", d.role_cooldown_s)),
            drain_cooldown_s=float(
                k("drainCooldownS", "drain_cooldown_s", d.drain_cooldown_s)),
            drain_deadline_s=float(
                k("drainDeadlineS", "drain_deadline_s", d.drain_deadline_s)),
            history=int(k("history", "history", d.history)),
        )
