"""The reconciliation loop: sense → decide → act, journaled and traced.

Each round takes one :class:`FleetSignals` snapshot, first *resolves*
any in-flight actions a predecessor journaled but never settled (verify
against observed topology; only re-execute when the world does not
already reflect the action — never repeat, never reverse), then asks the
policy for new actions and pushes them through the actuator under the
global action budget.

Crash safety is the journal's write ordering: ``planned`` lands on disk
*before* the actuator runs, ``executed``/``failed`` after it settles, so
every controller state is reconstructible from the journal alone. Every
executed (or dry-run) action gets a ``llm_d.kv_cache.control.action``
span whose attributes carry the causing alert/signal snapshot — the
audit trail from "SLO burned" to "topology changed" is one trace query.

Port of ``llmd_kv_cache_tpu/control/controller.py``: the same signals
give the same actions and journal records in both packages. Its
families live on the port's registry (``metrics.registry``).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..metrics.registry import Counter, Gauge

from ..metrics.collector import record_fence_rejection
from ..resilience.failpoints import failpoints
from ..telemetry.flight_recorder import KIND_FENCE
from ..telemetry.flight_recorder import record as fr_record
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from ..telemetry.tracing import tracer
from .actions import (
    ACTION_ADD_SHARD,
    ACTION_DRAIN_POD,
    ACTION_REMOVE_SHARD,
    ACTION_SET_ROLE,
    TOPOLOGY_KINDS,
    Action,
    Actuator,
)
from .config import ControllerConfig
from .journal import (
    PHASE_EXECUTED,
    PHASE_FAILED,
    PHASE_FENCED,
    PHASE_PLANNED,
    PHASE_WOULD_ACT,
    ActionJournal,
    ActionRecord,
    last_settlement_ts,
    unresolved_actions,
)
from .policy import ControlPolicy
from .signals import FleetSignals

logger = get_logger("control.controller")

CTRL_ROUNDS = Counter(
    "kvtpu_ctrl_reconcile_rounds_total",
    "Fleet-controller reconcile rounds completed",
)
CTRL_ACTIONS = Counter(
    "kvtpu_ctrl_actions_total",
    "Fleet-controller actions by kind and settlement phase",
    ["kind", "phase"],
)
CTRL_BUDGET_DEFERRED = Counter(
    "kvtpu_ctrl_budget_deferred_total",
    "Actions the policy wanted but the global budget deferred",
)
CTRL_INFLIGHT = Gauge(
    "kvtpu_ctrl_inflight_actions",
    "Journaled planned actions not yet settled",
)

SPAN_RECONCILE = "llm_d.kv_cache.control.reconcile"
SPAN_ACTION = "llm_d.kv_cache.control.action"

# Failpoint fired between a topology action's propose (``planned``
# journal record) and its commit fence check — ``pause`` mode here
# simulates a controller that stalled mid-mutation while a rival
# committed the contested epoch (the split-brain chaos suite's seam).
FP_COMMIT_PREFIX = "controller.commit."


class FleetController:
    """Sense → decide → act loop over a signal source and an actuator."""

    def __init__(
        self,
        signal_source,
        actuator: Actuator,
        config: Optional[ControllerConfig] = None,
        journal: Optional[ActionJournal] = None,
        clock: Callable[[], float] = time.time,
        membership=None,
    ):
        self.cfg = config or ControllerConfig()
        self.source = signal_source
        self.actuator = actuator
        # Optional cluster.membership.MembershipTable — the fleet epoch
        # authority topology commits publish to (and fence against).
        self.membership = membership
        # Wall clock on purpose: journal timestamps must stay comparable
        # across restarts for cooldown/budget restoration.
        self._clock = clock
        self.policy = ControlPolicy(self.cfg, clock)
        if journal is None and self.cfg.journal_path:
            journal = ActionJournal(self.cfg.journal_path)
        self.journal = journal
        self._mu = new_lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rounds = 0
        self.budget_deferred = 0
        # Executed-action timestamps inside the sliding budget window.
        self._budget_ts: deque = deque()
        # Bounded histories for kvdiag / /debug/controller.
        self._history: deque = deque(maxlen=self.cfg.history)
        self._would_act: deque = deque(maxlen=self.cfg.history)
        # In-flight (planned, unsettled) records to resolve next round.
        self._pending: List[ActionRecord] = []
        # Monotonic action-id counter, assigned BEFORE the planned record
        # is journaled so the on-disk planned and settled records carry
        # the same action_id (unresolved_actions matches by id).
        self._action_counter = 0
        # Highest topology epoch this controller has committed or
        # observed (journal replay + signal polls + membership). Topology
        # mutations propose epoch+1 and fence the commit against it.
        self._epoch = 0
        self._signals_epoch = 0
        # Latched once this controller loses an epoch race: a fenced
        # controller stops mutating and defers to the winner until it is
        # restarted (re-admission re-reads the committed fleet epoch).
        self.fenced = False
        self.fence_events = 0
        self.resumed_records = 0
        if self.journal is not None:
            self._restore()

    # -- warm restart ------------------------------------------------------

    def _restore(self) -> None:
        records = list(self.journal.replay())
        self.resumed_records = len(records)
        if not records:
            return
        # Resume past the highest journal seq: action ids embed the
        # counter, so reuse across restarts would alias distinct actions.
        self._action_counter = max(r.seq for r in records)
        # Resume at the highest epoch the journal ever saw — committed or
        # merely proposed. A proposed-but-unsettled epoch must not be
        # re-minted blindly: _resolve_pending fences it if the fleet
        # moved past it while this controller was down.
        self._epoch = max(self._epoch, max(r.epoch for r in records))
        for kind, ts in last_settlement_ts(records).items():
            self.policy.notify_action(kind, ts)
        now = self._clock()
        for rec in records:
            if rec.phase == PHASE_EXECUTED \
                    and now - rec.ts <= self.cfg.budget_window_s:
                self._budget_ts.append(rec.ts)
            if rec.phase in (PHASE_EXECUTED, PHASE_FAILED):
                self._history.append(rec.to_wire())
            elif rec.phase == PHASE_WOULD_ACT:
                self._would_act.append(rec.to_wire())
        self._pending = unresolved_actions(records)
        CTRL_INFLIGHT.set(len(self._pending))
        if self._pending:
            logger.info(
                "restored %d journal records, %d in-flight action(s) to "
                "re-verify: %s", len(records), len(self._pending),
                [r.action_id for r in self._pending])
        else:
            logger.info("restored %d journal records, no in-flight actions",
                        len(records))

    # -- budget ------------------------------------------------------------

    def _budget_ok(self) -> bool:
        now = self._clock()
        while self._budget_ts and now - self._budget_ts[0] > self.cfg.budget_window_s:
            self._budget_ts.popleft()
        return len(self._budget_ts) < self.cfg.action_budget

    def _charge_budget(self) -> None:
        self._budget_ts.append(self._clock())

    # -- journaling helpers ------------------------------------------------

    def _journal(self, record: ActionRecord) -> ActionRecord:
        if self.journal is not None:
            return self.journal.append(record)
        # No persistence configured: still assign seqs so action ids and
        # histories stay well-formed.
        self._seq = getattr(self, "_seq", 0) + 1
        record.seq = self._seq
        return record

    def _record(self, action: Action, phase: str,
                result: Optional[dict] = None,
                epoch: Optional[int] = None) -> ActionRecord:
        self._action_counter += 1
        rec = ActionRecord(
            action_id=action.action_id(self._action_counter),
            seq=0,
            ts=self._clock(),
            phase=phase,
            kind=action.kind,
            target=action.target,
            params=dict(action.params),
            reason=action.reason,
            signal=dict(action.signal),
            result=dict(result or {}),
            epoch=int(self._epoch if epoch is None else epoch),
        )
        return self._journal(rec)

    # -- epoch fencing -----------------------------------------------------

    def _fleet_epoch(self) -> int:
        """Highest committed topology epoch this controller can see:
        its own commits, the membership table, the last signal poll."""
        epoch = max(self._epoch, self._signals_epoch)
        if self.membership is not None:
            epoch = max(epoch, int(self.membership.epoch))
        return epoch

    def _fence(self, planned: ActionRecord, action: Action,
               fleet_epoch: int) -> ActionRecord:
        """Journal the loss of an epoch race and latch self-fencing."""
        self.fenced = True
        self.fence_events += 1
        self._epoch = max(self._epoch, fleet_epoch)
        fenced = ActionRecord(
            action_id=planned.action_id, seq=0, ts=self._clock(),
            phase=PHASE_FENCED, kind=action.kind, target=action.target,
            params=dict(action.params), reason=action.reason,
            signal=dict(action.signal),
            result={"ok": False, "fenced": True,
                    "proposed_epoch": int(planned.epoch),
                    "fleet_epoch": int(fleet_epoch)},
            epoch=planned.epoch,
        )
        fenced = self._journal(fenced)
        CTRL_ACTIONS.labels(action.kind, PHASE_FENCED).inc()
        record_fence_rejection("controller.commit", "stale_epoch")
        fr_record(KIND_FENCE, {
            "site": "controller.commit", "reason": "stale_epoch",
            "action_id": planned.action_id,
            "proposed_epoch": int(planned.epoch),
            "fleet_epoch": int(fleet_epoch),
        })
        self._pending = [p for p in self._pending
                         if p.action_id != planned.action_id]
        CTRL_INFLIGHT.set(len(self._pending))
        self._history.append(fenced.to_wire())
        logger.warning(
            "action %s fenced: proposed epoch %d but fleet already "
            "committed %d — another controller won the race; this "
            "controller self-fences until restart",
            planned.action_id, planned.epoch, fleet_epoch)
        return fenced

    # -- action execution --------------------------------------------------

    def _execute(self, action: Action) -> ActionRecord:
        """planned → actuate → executed/failed, traced and journaled.

        Topology mutations are two-phase: *propose* journals ``planned``
        with epoch ``fleet+1``; *commit* re-reads the fleet epoch right
        before actuating and abandons the action (``fenced`` record,
        self-fence latch) if a rival controller committed the contested
        epoch in between — at most one controller's mutation lands per
        epoch, no matter how many believe they are the leader.
        """
        topology = action.kind in TOPOLOGY_KINDS
        proposed = self._fleet_epoch() + 1 if topology else None
        planned = self._record(action, PHASE_PLANNED, epoch=proposed)
        CTRL_ACTIONS.labels(action.kind, PHASE_PLANNED).inc()
        self._pending.append(planned)
        CTRL_INFLIGHT.set(len(self._pending))
        if topology:
            stall = failpoints.pause_seconds(FP_COMMIT_PREFIX + action.target)
            if stall:
                logger.warning(
                    "action %s stalled %.3fs between propose and commit "
                    "(failpoint)", planned.action_id, stall)
            fleet = max(self._signals_epoch,
                        int(self.membership.epoch)
                        if self.membership is not None else 0)
            if fleet >= proposed:
                return self._fence(planned, action, fleet)
        try:
            with tracer().span(
                SPAN_ACTION,
                action_id=planned.action_id,
                action_kind=action.kind,
                action_target=action.target,
                reason=action.reason,
                signal=json.dumps(action.signal, sort_keys=True,
                                  default=repr),
                dry_run=False,
            ):
                result = self.actuator.apply(action)
            phase, payload = PHASE_EXECUTED, {"ok": True, **(result or {})}
            self._charge_budget()
            if topology:
                # Commit: the new epoch becomes the fleet's, and every
                # peer learns it by piggyback on the next RPC it sees.
                self._epoch = proposed
                if self.membership is not None:
                    self.membership.observe_epoch(
                        proposed, source="controller.commit")
        except Exception as exc:
            phase, payload = PHASE_FAILED, {"ok": False, "error": repr(exc)}
            logger.warning("action %s failed: %r", planned.action_id, exc)
        settled = ActionRecord(
            action_id=planned.action_id,
            seq=0,
            ts=self._clock(),
            phase=phase,
            kind=action.kind,
            target=action.target,
            params=dict(action.params),
            reason=action.reason,
            signal=dict(action.signal),
            result=payload,
            epoch=planned.epoch,
        )
        settled = self._journal(settled)
        CTRL_ACTIONS.labels(action.kind, phase).inc()
        self._pending = [p for p in self._pending
                         if p.action_id != planned.action_id]
        CTRL_INFLIGHT.set(len(self._pending))
        self._history.append(settled.to_wire())
        return settled

    def _dry_run(self, action: Action) -> ActionRecord:
        with tracer().span(
            SPAN_ACTION,
            action_kind=action.kind,
            action_target=action.target,
            reason=action.reason,
            signal=json.dumps(action.signal, sort_keys=True, default=repr),
            dry_run=True,
        ):
            rec = self._record(action, PHASE_WOULD_ACT,
                               result={"dry_run": True})
        CTRL_ACTIONS.labels(action.kind, PHASE_WOULD_ACT).inc()
        self._would_act.append(rec.to_wire())
        return rec

    # -- in-flight resolution ----------------------------------------------

    def _world_reflects(self, rec: ActionRecord,
                        signals: FleetSignals) -> bool:
        """Does observed topology already show this action's effect?"""
        if rec.kind == ACTION_SET_ROLE:
            return signals.roles.get(rec.target) == rec.params.get("role")
        if rec.kind == ACTION_ADD_SHARD:
            return rec.target in signals.shards
        if rec.kind == ACTION_REMOVE_SHARD:
            return rec.target not in signals.shards
        if rec.kind == ACTION_DRAIN_POD:
            # Drain leaves no durable topology mark; once its pod is gone
            # from the ring the paired scale-down clearly went through.
            return rec.target not in signals.shards
        return False

    def _resolve_pending(self, signals: FleetSignals) -> None:
        pending, self._pending = self._pending, []
        for rec in pending:
            if self.fenced:
                # Lost an epoch race earlier in this resolution pass:
                # keep the rest in-flight for the winner (or a restart)
                # to verify — a fenced controller executes nothing.
                self._pending.append(rec)
                continue
            action = Action(kind=rec.kind, target=rec.target,
                            params=dict(rec.params),
                            reason=f"resume in-flight: {rec.reason}",
                            signal=dict(rec.signal))
            if self._world_reflects(rec, signals):
                settled = ActionRecord(
                    action_id=rec.action_id, seq=0, ts=self._clock(),
                    phase=PHASE_EXECUTED, kind=rec.kind, target=rec.target,
                    params=dict(rec.params), reason=rec.reason,
                    signal=dict(rec.signal),
                    result={"ok": True, "resumed": True,
                            "already_applied": True},
                    epoch=rec.epoch,
                )
                settled = self._journal(settled)
                CTRL_ACTIONS.labels(rec.kind, PHASE_EXECUTED).inc()
                self._history.append(settled.to_wire())
                logger.info("in-flight action %s already applied; settled "
                            "without re-executing", rec.action_id)
                continue
            if rec.kind in TOPOLOGY_KINDS and rec.epoch:
                # Warm-restart split-brain check: this controller died
                # between propose and commit. If the fleet meanwhile
                # committed the proposed epoch (or beyond) — and the
                # world does *not* reflect our plan — a rival won it;
                # re-executing now would mutate topology under a stale
                # epoch. Fence instead.
                fleet = max(self._signals_epoch,
                            int(self.membership.epoch)
                            if self.membership is not None else 0)
                if fleet >= rec.epoch:
                    self._fence(rec, Action(
                        kind=rec.kind, target=rec.target,
                        params=dict(rec.params), reason=rec.reason,
                        signal=dict(rec.signal)), fleet)
                    continue
            if self.cfg.dry_run:
                self._dry_run(action)
                continue
            if not self._budget_ok():
                self.budget_deferred += 1
                CTRL_BUDGET_DEFERRED.inc()
                self._pending.append(rec)
                continue
            logger.info("re-executing in-flight action %s", rec.action_id)
            self._execute(action)
        CTRL_INFLIGHT.set(len(self._pending))

    # -- the loop ----------------------------------------------------------

    def reconcile_once(self) -> Dict[str, object]:
        """One sense→decide→act round; returns a round summary."""
        with self._mu:
            with tracer().span(SPAN_RECONCILE, dry_run=self.cfg.dry_run):
                signals = self.source.poll()
                self._signals_epoch = max(self._signals_epoch,
                                          int(getattr(signals, "epoch", 0)))
                if self.membership is not None and self._signals_epoch:
                    self.membership.observe_epoch(
                        self._signals_epoch, source="controller.poll")
                if self.fenced:
                    # A fenced controller observes but never mutates: the
                    # epoch race proved a rival is actuating, and two
                    # hands on the same topology is the failure mode this
                    # plane exists to prevent. Restart to re-admit.
                    self.rounds += 1
                    CTRL_ROUNDS.inc()
                    return {
                        "ts": signals.ts,
                        "proposed": 0,
                        "settled": [],
                        "budget_deferred": 0,
                        "pending": [r.action_id for r in self._pending],
                        "dry_run": self.cfg.dry_run,
                        "fenced": True,
                    }
                self._resolve_pending(signals)
                proposed = self.policy.decide(signals)
                executed: List[str] = []
                deferred = 0
                for action in proposed:
                    if self.fenced:
                        break
                    if self.cfg.dry_run:
                        rec = self._dry_run(action)
                        executed.append(rec.action_id)
                        continue
                    if not self._budget_ok():
                        self.budget_deferred += 1
                        deferred += 1
                        CTRL_BUDGET_DEFERRED.inc()
                        logger.warning(
                            "budget exhausted (%d actions in %.0fs window); "
                            "deferring %s", self.cfg.action_budget,
                            self.cfg.budget_window_s, action.describe())
                        continue
                    rec = self._execute(action)
                    if rec.phase != PHASE_FENCED:
                        # A fenced action never landed — it lost the epoch
                        # race, so it is settled in the journal but not a
                        # mutation this round performed.
                        executed.append(rec.action_id)
                self.rounds += 1
                CTRL_ROUNDS.inc()
                return {
                    "ts": signals.ts,
                    "proposed": len(proposed),
                    "settled": executed,
                    "budget_deferred": deferred,
                    "pending": [r.action_id for r in self._pending],
                    "dry_run": self.cfg.dry_run,
                    "fenced": self.fenced,
                }

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-controller", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.reconcile_once()
            except Exception:  # loop survives a bad round  # lint: allow-swallow
                logger.exception("reconcile round failed")
            self._stop.wait(self.cfg.loop_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.journal is not None:
            self.journal.close()

    # -- introspection -----------------------------------------------------

    def debug_view(self) -> dict:
        with self._mu:
            now = self._clock()
            window = [t for t in self._budget_ts
                      if now - t <= self.cfg.budget_window_s]
            return {
                "dry_run": self.cfg.dry_run,
                "rounds": self.rounds,
                "resumed_records": self.resumed_records,
                "epoch": {
                    "current": self._epoch,
                    "fleet": self._fleet_epoch(),
                    "fenced": self.fenced,
                    "fence_events": self.fence_events,
                },
                "budget": {
                    "limit": self.cfg.action_budget,
                    "window_s": self.cfg.budget_window_s,
                    "used": len(window),
                    "deferred_total": self.budget_deferred,
                },
                "policy": self.policy.debug_view(),
                "pending": [r.to_wire() for r in self._pending],
                "actions": list(self._history),
                "would_act": list(self._would_act),
            }
