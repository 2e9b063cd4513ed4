"""The control plane of the port (``llmd_kv_cache_tpu_torch/control``,
``telemetry/slo.py``, ``services/fleet_controller.py``) against the JAX
package's.

First the JAX package's own cases (``tests/test_controller.py``: the
policy's hysteresis bands and cooldowns, the action journal's framing and
torn tails, the reconcile loop's journal order, budget, dry run and
action spans, warm restart, the SLO alert-edge cursor, the admin plane's
guarded POSTs, ``MiniEngine.set_role``, kvdiag's controller section and
the epoch fence) run on the port. Then the port against the JAX package
under injected clocks: an ``SLORegistry`` fed the same records gives the
same ``evaluate_all`` output and edges, and scripted ``FleetSignals`` give
the same actions and journal records, byte for byte.
"""

import importlib.util
import json
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from llmd_kv_cache_tpu_torch.control import (
    ACTION_ADD_SHARD,
    ACTION_DRAIN_POD,
    ACTION_REMOVE_SHARD,
    ACTION_SET_ROLE,
    Action,
    ActionJournal,
    ActionRecord,
    AdminPlaneActuator,
    ControllerConfig,
    ControlPolicy,
    Cooldown,
    FleetController,
    FleetSignals,
    Hysteresis,
    InProcessActuator,
    last_settlement_ts,
    next_shard_name,
    unresolved_actions,
)
from llmd_kv_cache_tpu_torch.control.journal import (
    PHASE_EXECUTED,
    PHASE_FAILED,
    PHASE_PLANNED,
    PHASE_WOULD_ACT,
)
from llmd_kv_cache_tpu_torch.telemetry import recording_tracing
from llmd_kv_cache_tpu_torch.telemetry.slo import SLOConfig, SLORegistry


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def signals(shards=("shard-0",), roles=None, burn=0.0, severity=None,
            mix=None, ts=0.0, edges=()):
    slo = {"score_latency": {"severity": severity, "burn_slow": burn}}
    handoff = {}
    if mix is not None:
        handoff["mix"] = {"prefill_fraction": mix, "samples": 100}
    return FleetSignals(ts=ts, slo=slo, alert_edges=tuple(edges),
                        handoff=handoff, shards=tuple(shards),
                        roles=dict(roles or {}))


class QueueSource:
    """Signal source returning a queued snapshot per poll (last repeats)."""

    def __init__(self, *snapshots):
        self.snapshots = list(snapshots)

    def poll(self):
        if len(self.snapshots) > 1:
            return self.snapshots.pop(0)
        return self.snapshots[0]


# -- policy primitives --------------------------------------------------------


class TestHysteresis:
    def test_fires_once_after_confirm_rounds(self):
        h = Hysteresis(act=1.0, rearm=0.25, confirm_rounds=2)
        assert h.update(1.5) is False  # round 1 of 2
        assert h.update(1.5) is True  # confirmed
        # Disarmed: staying above act cannot re-fire.
        assert not any(h.update(2.0) for _ in range(10))

    def test_oscillation_around_act_never_refires(self):
        """The no-flap core: a value bouncing across the act band (but
        never reaching the re-arm band) produces exactly one trigger."""
        h = Hysteresis(act=1.0, rearm=0.25, confirm_rounds=1)
        fires = sum(h.update(v) for v in [1.5, 0.8, 1.5, 0.8] * 10)
        assert fires == 1

    def test_rearm_then_fire_again(self):
        h = Hysteresis(act=1.0, rearm=0.25, confirm_rounds=1)
        assert h.update(1.2) is True
        assert h.update(0.5) is False  # above rearm: still disarmed
        assert h.update(1.2) is False
        assert h.update(0.1) is False  # re-arms
        assert h.update(1.2) is True

    def test_blip_resets_confirm_streak(self):
        h = Hysteresis(act=1.0, rearm=0.25, confirm_rounds=3)
        assert h.update(1.5) is False
        assert h.update(1.5) is False
        assert h.update(0.9) is False  # streak broken
        assert h.update(1.5) is False
        assert h.update(1.5) is False
        assert h.update(1.5) is True

    def test_below_direction_mirrors(self):
        h = Hysteresis(act=0.25, rearm=1.0, confirm_rounds=1,
                       direction="below")
        assert h.update(0.5) is False
        assert h.update(0.2) is True
        assert h.update(0.1) is False  # disarmed
        assert h.update(1.5) is False  # re-arms at/over rearm
        assert h.update(0.2) is True

    def test_band_validation(self):
        with pytest.raises(ValueError):
            Hysteresis(act=1.0, rearm=2.0)  # above needs rearm <= act
        with pytest.raises(ValueError):
            Hysteresis(act=1.0, rearm=0.5, direction="below")
        with pytest.raises(ValueError):
            Hysteresis(act=1.0, rearm=0.5, direction="sideways")


class TestCooldown:
    def test_ready_until_stamped_then_waits_period(self):
        clock = FakeClock(100.0)
        cd = Cooldown(60.0, clock)
        assert cd.ready()
        cd.stamp()
        assert not cd.ready()
        assert cd.remaining() == pytest.approx(60.0)
        clock.now = 159.9
        assert not cd.ready()
        clock.now = 160.0
        assert cd.ready()

    def test_stamp_takes_max_of_existing_and_new(self):
        """Journal replay stamps out of order; an older record must not
        shorten a cooldown a newer record already set."""
        clock = FakeClock(100.0)
        cd = Cooldown(60.0, clock)
        cd.stamp(ts=90.0)
        cd.stamp(ts=50.0)  # older: ignored
        assert cd.remaining() == pytest.approx(50.0)


class TestNextShardName:
    def test_numeric_suffix_max_plus_one(self):
        assert next_shard_name(["shard-0", "shard-2"]) == "shard-3"
        assert next_shard_name(["a-7", "b-1"]) == "shard-8"
        assert next_shard_name(["alpha", "beta"]) == "shard-2"


# -- decision policy ----------------------------------------------------------


def make_policy(clock=None, **overrides):
    defaults = dict(confirm_rounds=1, shard_cooldown_s=60.0,
                    role_cooldown_s=60.0, drain_cooldown_s=60.0)
    defaults.update(overrides)
    cfg = ControllerConfig(**defaults)
    return ControlPolicy(cfg, clock or FakeClock()), cfg


class TestControlPolicy:
    def test_scale_up_on_burn_with_causing_signal(self):
        policy, cfg = make_policy()
        out = policy.decide(signals(burn=2.0, shards=("shard-0",)))
        assert [a.kind for a in out] == [ACTION_ADD_SHARD]
        assert out[0].target == "shard-1"
        assert out[0].signal["slo"] == "score_latency"
        assert out[0].signal["burn_slow"] == 2.0
        assert "score_latency" in out[0].reason

    def test_firing_alert_counts_as_saturated_burn(self):
        policy, _ = make_policy()
        out = policy.decide(signals(burn=0.0, severity="fast_burn"))
        assert [a.kind for a in out] == [ACTION_ADD_SHARD]

    def test_scale_up_respects_max_shards_and_cooldown(self):
        clock = FakeClock()
        policy, _ = make_policy(clock, max_shards=2)
        assert policy.decide(signals(burn=2.0, shards=("s-0", "s-1"))) == []
        policy2, _ = make_policy(clock)
        assert policy2.decide(signals(burn=2.0))  # fires, stamps cooldown
        # Re-arm then burn again inside the cooldown window: suppressed.
        policy2.decide(signals(burn=0.0))
        assert policy2.decide(signals(burn=2.0)) == []

    def test_scale_down_drains_before_removing(self):
        clock = FakeClock()
        policy, cfg = make_policy(clock, confirm_rounds=2)
        shards = ("shard-0", "shard-1", "shard-2")
        # The below-band trigger needs max(confirm_rounds, 2) quiet rounds.
        assert policy.decide(signals(burn=0.1, shards=shards)) == []
        out = policy.decide(signals(burn=0.1, shards=shards))
        assert [a.kind for a in out] == [ACTION_DRAIN_POD,
                                         ACTION_REMOVE_SHARD]
        assert out[0].target == out[1].target == "shard-2"
        assert out[0].params["deadline_s"] == cfg.drain_deadline_s

    def test_scale_down_blocked_while_alert_fires(self):
        """A low slow-window burn with the alert still firing means the
        fast window is screaming: the policy must never shrink (the
        firing alert even counts as a saturated scale-up signal)."""
        policy, _ = make_policy(confirm_rounds=2)
        shards = ("shard-0", "shard-1")
        kinds = []
        for _ in range(4):
            low_but_firing = signals(burn=0.1, severity="fast_burn",
                                     shards=shards)
            kinds += [a.kind for a in policy.decide(low_but_firing)]
        assert ACTION_REMOVE_SHARD not in kinds
        assert ACTION_DRAIN_POD not in kinds

    def test_scale_down_respects_min_shards(self):
        policy, _ = make_policy(confirm_rounds=2, min_shards=1)
        for _ in range(4):
            assert policy.decide(signals(burn=0.0, shards=("s-0",))) == []

    def test_reroles_decode_donor_when_prefill_starved(self):
        policy, _ = make_policy()
        roles = {"p-0": "prefill", "d-0": "decode", "d-1": "decode"}
        # offered 0.85 vs provisioned 1/3: imbalance +0.52 > act 0.20.
        out = policy.decide(signals(mix=0.85, roles=roles))
        assert [a.kind for a in out] == [ACTION_SET_ROLE]
        assert out[0].target == "d-1"  # last sorted decode pod donates
        assert out[0].params == {"role": "prefill"}
        assert out[0].signal["imbalance"] == pytest.approx(0.517, abs=1e-3)

    def test_reroles_prefill_donor_when_decode_starved(self):
        policy, _ = make_policy()
        roles = {"p-0": "prefill", "p-1": "prefill", "d-0": "decode"}
        out = policy.decide(signals(mix=0.1, roles=roles))
        assert [(a.kind, a.target) for a in out] == [(ACTION_SET_ROLE, "p-1")]
        assert out[0].params == {"role": "decode"}

    def test_rerole_respects_min_pods(self):
        policy, _ = make_policy(min_decode_pods=1)
        roles = {"p-0": "prefill", "d-0": "decode"}
        assert policy.decide(signals(mix=0.95, roles=roles)) == []

    def test_no_mix_signal_is_a_safe_noop(self):
        policy, _ = make_policy()
        assert policy.decide(
            signals(roles={"p-0": "prefill", "d-0": "decode"})) == []


# -- the action journal -------------------------------------------------------


def make_record(action_id="add_shard:shard-1:1", phase=PHASE_PLANNED,
                kind=ACTION_ADD_SHARD, target="shard-1", ts=10.0, **kw):
    return ActionRecord(action_id=action_id, seq=0, ts=ts, phase=phase,
                        kind=kind, target=target, **kw)


class TestActionJournal:
    def test_append_replay_round_trip(self, tmp_path):
        path = str(tmp_path / "actions.journal")
        j = ActionJournal(path)
        j.append(make_record(signal={"slo": "score_latency", "burn": 2.0},
                             params={"bootstrap": "snapshot"}))
        j.append(make_record(phase=PHASE_EXECUTED,
                             result={"ok": True}))
        j.close()
        back = list(ActionJournal(path).replay())
        assert [r.seq for r in back] == [1, 2]
        assert back[0].signal == {"slo": "score_latency", "burn": 2.0}
        assert back[0].params == {"bootstrap": "snapshot"}
        assert back[1].result == {"ok": True}

    def test_seq_resumes_past_existing_records(self, tmp_path):
        path = str(tmp_path / "actions.journal")
        j = ActionJournal(path)
        j.append(make_record())
        j.close()
        j2 = ActionJournal(path)
        rec = j2.append(make_record())
        assert rec.seq == 2
        j2.close()

    def test_torn_tail_stops_replay_cleanly(self, tmp_path):
        path = str(tmp_path / "actions.journal")
        j = ActionJournal(path)
        j.append(make_record())
        j.append(make_record(phase=PHASE_EXECUTED))
        j.close()
        with open(path, "ab") as f:
            f.write(b"\x40\x00\x00\x00partial")  # length says 64, body short
        assert len(list(ActionJournal(path).replay())) == 2

    def test_corrupt_crc_stops_replay(self, tmp_path):
        path = str(tmp_path / "actions.journal")
        j = ActionJournal(path)
        j.append(make_record())
        j.append(make_record(phase=PHASE_EXECUTED))
        j.close()
        data = bytearray(Path(path).read_bytes())
        data[-1] ^= 0xFF  # flip a body byte of the last record
        Path(path).write_bytes(bytes(data))
        assert len(list(ActionJournal(path).replay())) == 1

    def test_unresolved_actions_and_settlement(self):
        records = [
            make_record("a:1", PHASE_PLANNED, ts=10.0),
            make_record("a:1", PHASE_EXECUTED, ts=11.0),
            make_record("b:3", PHASE_PLANNED, kind=ACTION_SET_ROLE,
                        target="pod-1", ts=12.0),
            make_record("c:4", PHASE_PLANNED, ts=13.0),
            make_record("c:4", PHASE_FAILED, ts=14.0),
            make_record("d:6", PHASE_WOULD_ACT, ts=15.0),
        ]
        pending = unresolved_actions(records)
        assert [r.action_id for r in pending] == ["b:3"]
        ts = last_settlement_ts(records)
        assert ts[ACTION_ADD_SHARD] == 13.0  # latest planned/executed
        assert ts[ACTION_SET_ROLE] == 12.0


# -- the reconcile loop -------------------------------------------------------


def make_controller(tmp_path=None, clock=None, source=None, dry_run=False,
                    **overrides):
    clock = clock or FakeClock()
    defaults = dict(confirm_rounds=1, shard_cooldown_s=60.0,
                    role_cooldown_s=60.0, drain_cooldown_s=60.0,
                    dry_run=dry_run)
    if tmp_path is not None:
        defaults["journal_path"] = str(tmp_path / "actions.journal")
    defaults.update(overrides)
    cfg = ControllerConfig(**defaults)
    actuator = InProcessActuator(
        add_shard=lambda t: {"ok": True, "shard": t},
        remove_shard=lambda t: {"ok": True},
        set_role=lambda t, r: {"ok": True, "role": r},
        drain_pod=lambda t: {"drained": True},
    )
    source = source or QueueSource(signals(burn=2.0))
    return FleetController(source, actuator, config=cfg, clock=clock)


class TestFleetController:
    def test_executes_and_journals_planned_before_executed(self, tmp_path):
        ctrl = make_controller(tmp_path)
        summary = ctrl.reconcile_once()
        assert summary["settled"] == ["add_shard:shard-1:1"]
        assert ctrl.actuator.applied == [
            (ACTION_ADD_SHARD, "shard-1", {"bootstrap": "snapshot"})]
        ctrl.stop()
        phases = [(r.phase, r.action_id)
                  for r in ActionJournal(ctrl.cfg.journal_path).replay()]
        assert phases == [(PHASE_PLANNED, "add_shard:shard-1:1"),
                          (PHASE_EXECUTED, "add_shard:shard-1:1")]

    def test_budget_defers_excess_actions(self):
        clock = FakeClock()
        # Burn + starved mix every round; budget of 1 lets only the first
        # of the two proposed actions through.
        src = QueueSource(signals(
            burn=2.0, mix=0.9,
            roles={"p-0": "prefill", "d-0": "decode", "d-1": "decode"}))
        ctrl = make_controller(clock=clock, source=src, action_budget=1,
                               budget_window_s=600.0)
        summary = ctrl.reconcile_once()
        assert len(summary["settled"]) == 1
        assert summary["budget_deferred"] == 1
        assert ctrl.budget_deferred == 1
        # Window slides: capacity returns.
        clock.now += 601.0
        assert ctrl._budget_ok()

    def test_dry_run_records_would_act_without_touching_cluster(self):
        ctrl = make_controller(dry_run=True)
        summary = ctrl.reconcile_once()
        assert summary["dry_run"] is True
        assert ctrl.actuator.applied == []
        view = ctrl.debug_view()
        assert view["actions"] == []
        assert [r["phase"] for r in view["would_act"]] == [PHASE_WOULD_ACT]
        assert view["would_act"][0]["kind"] == ACTION_ADD_SHARD

    def test_actuator_failure_is_journaled_not_fatal(self, tmp_path):
        clock = FakeClock()
        cfg = ControllerConfig(
            confirm_rounds=1, journal_path=str(tmp_path / "a.journal"))
        def boom(_):
            raise ConnectionError("deployment hook down")
        ctrl = FleetController(
            QueueSource(signals(burn=2.0)),
            InProcessActuator(add_shard=boom), config=cfg, clock=clock)
        ctrl.reconcile_once()
        ctrl.stop()
        records = list(ActionJournal(cfg.journal_path).replay())
        assert [r.phase for r in records] == [PHASE_PLANNED, PHASE_FAILED]
        assert "ConnectionError" in records[1].result["error"]

    def test_action_span_carries_causing_signal(self):
        with recording_tracing() as exporter:
            ctrl = make_controller()
            ctrl.reconcile_once()
            assert exporter.find("llm_d.kv_cache.control.reconcile")
            rec = exporter.find("llm_d.kv_cache.control.action")[0]
            assert rec.attributes["action_kind"] == ACTION_ADD_SHARD
            assert rec.attributes["dry_run"] is False
            signal = json.loads(rec.attributes["signal"])
            assert signal["slo"] == "score_latency"
            assert signal["burn_slow"] == 2.0


class TestWarmRestart:
    def test_restart_does_not_repeat_applied_inflight_action(self, tmp_path):
        """Predecessor journaled `planned add_shard shard-1` and crashed
        after the actuator ran: the successor sees shard-1 in the ring and
        settles the record without re-executing."""
        path = str(tmp_path / "a.journal")
        j = ActionJournal(path)
        j.append(make_record("add_shard:shard-1:1", PHASE_PLANNED, ts=10.0))
        j.close()
        src = QueueSource(signals(burn=0.0, shards=("shard-0", "shard-1")))
        ctrl = make_controller(source=src, journal_path=path)
        assert ctrl.resumed_records == 1
        assert [r.action_id for r in ctrl._pending] == ["add_shard:shard-1:1"]
        ctrl.reconcile_once()
        assert ctrl.actuator.applied == []  # never repeated
        assert ctrl._pending == []
        ctrl.stop()
        records = list(ActionJournal(path).replay())
        assert records[-1].phase == PHASE_EXECUTED
        assert records[-1].result["already_applied"] is True

    def test_restart_reexecutes_unapplied_inflight_action(self, tmp_path):
        """Crash landed between journal append and the actuator: the
        world does not reflect the action, so the successor re-executes
        it (exactly once) instead of dropping it."""
        path = str(tmp_path / "a.journal")
        j = ActionJournal(path)
        j.append(make_record(
            "set_role:d-1:1", PHASE_PLANNED, kind=ACTION_SET_ROLE,
            target="d-1", params={"role": "prefill"}, ts=10.0))
        j.close()
        src = QueueSource(signals(
            burn=0.0, roles={"p-0": "prefill", "d-1": "decode"}))
        ctrl = make_controller(source=src, journal_path=path)
        ctrl.reconcile_once()
        assert ctrl.actuator.applied == [
            (ACTION_SET_ROLE, "d-1", {"role": "prefill"})]
        assert ctrl._pending == []
        ctrl.stop()

    def test_restart_restores_cooldowns_so_no_reversal(self, tmp_path):
        """An executed re-role must keep its cooldown across restart:
        the successor seeing the (now inverted) imbalance cannot
        immediately flip the pod back."""
        clock = FakeClock(1000.0)
        path = str(tmp_path / "a.journal")
        src1 = QueueSource(signals(
            mix=0.9, roles={"p-0": "prefill", "d-0": "decode",
                            "d-1": "decode"}))
        ctrl1 = make_controller(clock=clock, source=src1, journal_path=path)
        ctrl1.reconcile_once()
        assert ctrl1.actuator.applied  # the re-role executed
        ctrl1.stop()

        clock.now += 5.0  # restart well inside role_cooldown_s=60
        src2 = QueueSource(signals(
            mix=0.1, roles={"p-0": "prefill", "d-1": "prefill",
                            "d-0": "decode"}))
        ctrl2 = make_controller(clock=clock, source=src2, journal_path=path)
        assert not ctrl2.policy.cooldown_ready(ACTION_SET_ROLE)
        summary = ctrl2.reconcile_once()
        assert summary["settled"] == []  # no reversal inside the cooldown
        assert ctrl2.actuator.applied == []
        ctrl2.stop()

    def test_restart_restores_budget_and_histories(self, tmp_path):
        clock = FakeClock(1000.0)
        ctrl1 = make_controller(tmp_path, clock=clock)
        ctrl1.reconcile_once()
        ctrl1.stop()
        clock.now += 10.0
        ctrl2 = make_controller(tmp_path, clock=clock,
                                source=QueueSource(signals(burn=0.0)))
        view = ctrl2.debug_view()
        assert view["budget"]["used"] == 1  # executed record in window
        assert [r["phase"] for r in view["actions"]] == [PHASE_EXECUTED]
        ctrl2.stop()


# -- SLO alert-edge feed ------------------------------------------------------


class TestSLOEdgeFeed:
    def _burning_registry(self, clock):
        reg = SLORegistry(clock=clock)
        reg.add(SLOConfig(name="score_latency", fast_windows=(60.0, 300.0),
                          slow_window=900.0))
        return reg

    def test_fire_and_clear_edges_with_cursor(self):
        clock = FakeClock(1000.0)
        reg = self._burning_registry(clock)
        t = reg.get("score_latency")
        t.record(good=0, bad=100)
        reg.evaluate_all()
        payload = reg.export_edges_since(-1)
        assert [e["edge"] for e in payload["edges"]] == ["fire"]
        edge = payload["edges"][0]
        assert edge["slo"] == "score_latency"
        assert edge["severity"] == "fast_burn"
        assert edge["burns"]["short"] > 0
        cursor = payload["next_seq"]
        # No transition since: the cursor read is empty (react-once).
        reg.evaluate_all()
        assert reg.export_edges_since(cursor)["edges"] == []
        # Recovery produces the clear edge past the same cursor.
        clock.now += 1000.0
        t.record(good=100, bad=0)
        reg.evaluate_all()
        cleared = reg.export_edges_since(cursor)["edges"]
        assert [e["edge"] for e in cleared] == ["clear"]
        assert cleared[0]["prev_severity"] == "fast_burn"

    def test_edge_ring_bounds_with_drop_counter(self):
        clock = FakeClock(1000.0)
        reg = SLORegistry(clock=clock, max_edges=4)
        reg.add(SLOConfig(name="s", fast_windows=(10.0, 10.0),
                          slow_window=20.0))
        t = reg.get("s")
        for _ in range(4):  # fire/clear cycles → 8 edges
            t.record(good=0, bad=50)
            reg.evaluate_all()
            clock.now += 100.0
            t.record(good=50, bad=0)
            reg.evaluate_all()
            clock.now += 100.0
        payload = reg.export_edges_since(-1)
        assert len(payload["edges"]) == 4
        assert payload["dropped"] == 4


# -- admin plane: /debug/slo cursor + guarded POST actions --------------------


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return resp.status, json.loads(resp.read())


def _post(port, path):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.status, json.loads(resp.read())


class TestAdminPlane:
    def test_slo_since_endpoint_and_level_fallthrough(self):
        from llmd_kv_cache_tpu_torch.services.admin import AdminServer

        clock = FakeClock(1000.0)
        reg = SLORegistry(clock=clock)
        reg.add(SLOConfig(name="ttft"))
        reg.get("ttft").record(good=0, bad=100)
        reg.evaluate_all()
        server = AdminServer(port=0)
        server.register_debug("slo", reg.debug_view)
        server.register_slo_source(reg.export_edges_since)
        try:
            port = server.start()
            # Plain GET keeps serving the level view (back-compat).
            status, level = _get(port, "/debug/slo")
            assert status == 200 and "ttft" in level
            # ?since= serves the edge cursor payload.
            status, edges = _get(port, "/debug/slo?since=-1")
            assert status == 200
            assert [e["edge"] for e in edges["edges"]] == ["fire"]
            assert edges["next_seq"] == 0
            status, empty = _get(port, f"/debug/slo?since={edges['next_seq']}")
            assert empty["edges"] == []
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(port, "/debug/slo?since=bogus")
            assert err.value.code == 400
        finally:
            server.stop()

    def test_post_actions_guarded_until_registered(self):
        from llmd_kv_cache_tpu_torch.services.admin import AdminServer

        server = AdminServer(port=0)
        try:
            port = server.start()
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, "/debug/role?set=prefill")
            assert err.value.code == 404

            role = ["decode"]

            def set_role(params):
                want = params.get("set", "")
                if want not in ("prefill", "decode", "both"):
                    raise ValueError(f"bad role {want!r}")
                role[0] = want
                return {"ok": True, "role": want}

            server.register_action("role", set_role)
            status, payload = _post(port, "/debug/role?set=prefill")
            assert status == 200 and payload["role"] == "prefill"
            assert role == ["prefill"]
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, "/debug/role?set=bogus")
            assert err.value.code == 400  # ValueError maps to bad request
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, "/debug/drain")  # unregistered action stays 404
            assert err.value.code == 404
        finally:
            server.stop()


# -- remote source + actuator end-to-end --------------------------------------


class TestRemoteControlPlane:
    def test_remote_source_polls_and_actuator_posts(self):
        from llmd_kv_cache_tpu_torch.services.admin import AdminServer
        from llmd_kv_cache_tpu_torch.services.fleet_controller import (
            RemoteSignalSource,
        )

        clock = FakeClock(1000.0)
        reg = SLORegistry(clock=clock)
        reg.add(SLOConfig(name="score_latency"))
        reg.get("score_latency").record(good=0, bad=100)
        reg.evaluate_all()

        collector = AdminServer(port=0)
        collector.register_debug("slo", reg.debug_view)
        collector.register_slo_source(reg.export_edges_since)

        pod_role = ["decode"]
        pod = AdminServer(port=0)
        pod.register_debug("role", lambda: {
            "pod": "d-0", "role": pod_role[0],
            "starvation": {
                "mix": {"prefill_fraction": 0.8, "samples": 50,
                        "alpha": 0.2},
                "outcomes": {}, "transfer_queue_depth": 3,
                "in_flight_jobs": 1, "last_handoff_latency_s": None,
                "starved_side": "prefill",
            }})

        def set_role(params):
            pod_role[0] = params.get("set", "")
            return {"ok": True, "role": pod_role[0]}

        pod.register_action("role", set_role)
        try:
            cport = collector.start()
            pport = pod.start()
            source = RemoteSignalSource(
                collector_address=f"127.0.0.1:{cport}",
                pod_admin={"d-0": f"127.0.0.1:{pport}"},
                shards=lambda: ["shard-0"], clock=clock)
            snap = source.poll()
            assert snap.roles == {"d-0": "decode"}
            assert snap.handoff["mix"]["prefill_fraction"] == \
                pytest.approx(0.8)
            assert snap.handoff["starved_side"] == "prefill"
            assert [e["edge"] for e in snap.alert_edges] == ["fire"]
            assert snap.burn("score_latency") > 0
            # The cursor advanced: the next poll sees no stale edges.
            assert source.poll().alert_edges == ()

            actuator = AdminPlaneActuator(
                pod_addresses={"d-0": f"127.0.0.1:{pport}"})
            result = actuator.apply(Action(
                kind=ACTION_SET_ROLE, target="d-0",
                params={"role": "prefill"}))
            assert result["role"] == "prefill"
            assert source.poll().roles == {"d-0": "prefill"}
            with pytest.raises(ValueError):
                actuator.apply(Action(kind=ACTION_SET_ROLE, target="ghost"))
        finally:
            collector.stop()
            pod.stop()

    def test_unreachable_planes_degrade_to_empty_signals(self):
        from llmd_kv_cache_tpu_torch.services.fleet_controller import (
            RemoteSignalSource,
        )

        source = RemoteSignalSource(
            collector_address="127.0.0.1:1",  # nothing listens there
            pod_admin={"p": "127.0.0.1:1"}, timeout_s=0.2)
        snap = source.poll()
        assert snap.slo == {} and snap.roles == {}
        assert source.fetch_errors > 0


# -- engine re-role -----------------------------------------------------------


class TestEngineSetRole:
    def _engine(self, tmp_path=None):
        from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
        from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig

        kwargs = {}
        if tmp_path is not None:
            from llmd_kv_cache_tpu_torch.offload.spec import SharedStorageOffloadSpec

            tiny = LlamaConfig.tiny()
            kwargs["offload_spec"] = SharedStorageOffloadSpec(
                root=str(tmp_path), model_name="tiny",
                page_size=tiny.page_size, num_layers=tiny.num_layers,
                kv_heads=tiny.num_kv_heads, head_dim=tiny.head_dim,
                io_threads=2, parallel_agnostic=True)
        return MiniEngine(EngineConfig(
            model=LlamaConfig.tiny(), num_pages=16, max_pages_per_seq=8,
            model_name="tiny", pod_identifier="p"), device="cpu", **kwargs)

    def test_set_role_flips_and_returns_previous(self, tmp_path):
        engine = self._engine(tmp_path)
        assert engine.set_role("prefill") == "both"
        assert engine.cfg.role == "prefill"
        assert engine.set_role("decode") == "prefill"
        assert engine.cfg.role == "decode"

    def test_set_role_validates_like_the_constructor(self, tmp_path):
        engine = self._engine(tmp_path)
        with pytest.raises(ValueError, match="role"):
            engine.set_role("mixed")
        plain = self._engine()
        with pytest.raises(ValueError, match="offload"):
            plain.set_role("prefill")
        assert plain.cfg.role == "both"  # failed flip left config alone


# -- kvdiag controller section ------------------------------------------------


def _load_kvdiag():
    spec = importlib.util.spec_from_file_location(
        "kvdiag", Path(__file__).resolve().parents[1] / "hack" / "kvdiag.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestKvdiagControllerSection:
    def test_summary_decodes_signals_and_trims_history(self):
        kvdiag = _load_kvdiag()
        ctrl = make_controller()
        ctrl.reconcile_once()
        summary = kvdiag.controller_summary(ctrl.debug_view())
        assert summary["rounds"] == 1
        assert summary["budget"]["used"] == 1
        act = summary["last_actions"][-1]
        assert act["kind"] == ACTION_ADD_SHARD
        assert act["signal"]["slo"] == "score_latency"
        assert ACTION_ADD_SHARD in summary["cooldowns"]
        assert summary["hysteresis_armed"]["shard_scale_up"] is False
        assert summary["pending"] == []

    def test_snapshot_includes_controller_section(self):
        from llmd_kv_cache_tpu_torch.services.admin import AdminServer

        kvdiag = _load_kvdiag()
        ctrl = make_controller(dry_run=True)
        ctrl.reconcile_once()
        server = AdminServer(port=0)
        server.register_debug("controller", ctrl.debug_view)
        try:
            port = server.start()
            report = kvdiag.snapshot("127.0.0.1", port)
            assert report["controller"]["dry_run"] is True
            assert [r["kind"] for r in report["controller"]["would_act"]] \
                == [ACTION_ADD_SHARD]
        finally:
            server.stop()


class TestSplitBrainController:
    """Split-brain: two controllers both believe they lead the fleet and
    race the same topology mutation. The two-phase epoch discipline
    (propose journals ``planned`` at fleet+1; commit re-reads the fleet
    epoch) guarantees exactly one commits — the loser journals a
    ``fenced`` record and latches self-fencing until restart. The race
    window is opened deterministically: a ``controller.commit.<target>``
    pause failpoint stalls the loser between propose and commit while a
    one-shot listener lets the winner run to completion."""

    def _controller(self, tmp_path, name, table, clock):
        from llmd_kv_cache_tpu_torch.control.controller import FleetController

        cfg = ControllerConfig(
            confirm_rounds=1, journal_path=str(tmp_path / f"{name}.journal"))
        actuator = InProcessActuator(
            add_shard=lambda t: {"ok": True, "shard": t},
            remove_shard=lambda t: {"ok": True},
        )
        return FleetController(
            QueueSource(signals(burn=2.0)), actuator, config=cfg,
            clock=clock, membership=table)

    def test_exactly_one_controller_commits(self, tmp_path):
        from llmd_kv_cache_tpu_torch.cluster.membership import MembershipTable
        from llmd_kv_cache_tpu_torch.control.controller import FP_COMMIT_PREFIX
        from llmd_kv_cache_tpu_torch.control.journal import PHASE_FENCED
        from llmd_kv_cache_tpu_torch.resilience.failpoints import failpoints

        clock = FakeClock()
        # One shared membership table = the fleet's ground truth both
        # controllers gossip through (epoch starts at genesis 1).
        table = MembershipTable(clock=clock)
        winner = self._controller(tmp_path, "winner", table, clock)
        loser = self._controller(tmp_path, "loser", table, clock)

        # Stall the loser between propose and commit, exactly once; while
        # it is stalled, the winner runs its whole round (the one-shot
        # ``times=1`` arm keeps the winner's own commit stall-free, so
        # the listener cannot recurse).
        failpoints.reset(seed=7)
        failpoints.arm(FP_COMMIT_PREFIX + "shard-1", mode="pause",
                       pause_s=5.0, times=1)
        outcome = {}

        def interleave(fp_name):
            if fp_name.startswith(FP_COMMIT_PREFIX) and "winner" not in outcome:
                outcome["winner"] = winner.reconcile_once()

        failpoints.add_listener(interleave)
        try:
            outcome["loser"] = loser.reconcile_once()
        finally:
            failpoints.remove_listener(interleave)
            failpoints.reset()
        winner.stop()
        loser.stop()

        # Exactly one mutation landed, and it is the winner's.
        assert winner.actuator.applied == [
            (ACTION_ADD_SHARD, "shard-1", {"bootstrap": "snapshot"})]
        assert loser.actuator.applied == []
        assert outcome["winner"]["settled"] == ["add_shard:shard-1:1"]
        assert outcome["winner"]["fenced"] is False
        assert outcome["loser"]["settled"] == []
        assert outcome["loser"]["fenced"] is True

        # The fleet epoch advanced exactly once: genesis 1 → 2.
        assert table.epoch == 2
        assert loser.fenced is True and loser.fence_events == 1
        assert winner.fenced is False

        # Journals tell the story: both proposed epoch 2; the winner
        # committed it, the loser's same action_id settled ``fenced``.
        win_recs = list(ActionJournal(
            str(tmp_path / "winner.journal")).replay())
        assert [r.phase for r in win_recs] == [PHASE_PLANNED, PHASE_EXECUTED]
        assert [r.epoch for r in win_recs] == [2, 2]
        lose_recs = list(ActionJournal(
            str(tmp_path / "loser.journal")).replay())
        assert [r.phase for r in lose_recs] == [PHASE_PLANNED, PHASE_FENCED]
        assert lose_recs[1].action_id == lose_recs[0].action_id
        assert lose_recs[1].result == {
            "ok": False, "fenced": True, "proposed_epoch": 2,
            "fleet_epoch": 2}
        # A fenced record SETTLES the planned one — restart replay must
        # not treat the lost action as in-flight.
        assert unresolved_actions(lose_recs) == []

    def test_fenced_controller_holds_still_until_restart(self, tmp_path):
        from llmd_kv_cache_tpu_torch.cluster.membership import MembershipTable
        from llmd_kv_cache_tpu_torch.control.controller import FP_COMMIT_PREFIX
        from llmd_kv_cache_tpu_torch.resilience.failpoints import failpoints

        clock = FakeClock()
        table = MembershipTable(clock=clock)
        winner = self._controller(tmp_path, "w2", table, clock)
        loser = self._controller(tmp_path, "l2", table, clock)
        failpoints.reset(seed=7)
        failpoints.arm(FP_COMMIT_PREFIX + "shard-1", mode="pause",
                       pause_s=5.0, times=1)
        done = {}

        def interleave(fp_name):
            if fp_name.startswith(FP_COMMIT_PREFIX) and not done:
                done["w"] = winner.reconcile_once()

        failpoints.add_listener(interleave)
        try:
            loser.reconcile_once()
        finally:
            failpoints.remove_listener(interleave)
            failpoints.reset()
        assert loser.fenced is True

        # Latched: every further round observes, proposes nothing, acts
        # on nothing — even though the burn signal still demands action.
        again = loser.reconcile_once()
        assert again == {
            "ts": 0.0, "proposed": 0, "settled": [], "budget_deferred": 0,
            "pending": [], "dry_run": False, "fenced": True}
        assert loser.actuator.applied == []
        assert loser.debug_view()["epoch"]["fenced"] is True
        winner.stop()
        loser.stop()

        # Restart is the re-admission path: the successor replays a
        # journal whose lost action is settled (planned+fenced), comes up
        # un-fenced at the fleet's epoch, and can win the NEXT round —
        # its commit mints epoch 3 on top of the rival's 2.
        reborn = self._controller(tmp_path, "l2", table, clock)
        assert reborn.fenced is False
        clock.now += 3600.0  # clear cooldowns
        summary = reborn.reconcile_once()
        assert summary["fenced"] is False
        (settled,) = summary["settled"]
        assert settled.startswith("add_shard:shard-1:")
        assert reborn.actuator.applied == [
            (ACTION_ADD_SHARD, "shard-1", {"bootstrap": "snapshot"})]
        assert table.epoch == 3
        reborn.stop()


# -- the port against the JAX package -----------------------------------------

JAX, PORT = "llmd_kv_cache_tpu", "llmd_kv_cache_tpu_torch"
PKGS = (JAX, PORT)


def mod(pkg: str, name: str):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _private_families(monkeypatch, module, metric_type, registry, bounds) -> None:
    for name, metric in list(vars(module).items()):
        if isinstance(metric, metric_type):
            kw = {"buckets": bounds(metric)} if hasattr(metric, "observe") else {}
            monkeypatch.setattr(module, name, type(metric)(
                metric._name, metric._documentation, metric._labelnames,
                registry=registry, **kw))


@pytest.fixture(autouse=True)
def private_metrics(monkeypatch):
    """The controller's and the SLO registry's families, and the collector's
    (the fence), of both packages on registries of the test's own: the JAX
    package's fleet tests read the process-wide ones."""
    from prometheus_client import CollectorRegistry
    from prometheus_client.metrics import MetricWrapperBase

    from llmd_kv_cache_tpu_torch.metrics.registry import Registry, _Metric
    from torch_telemetry_helpers import private_jax_metrics, private_port_metrics

    private_jax_metrics(monkeypatch)
    private_port_metrics(monkeypatch)
    jax_reg, port_reg = CollectorRegistry(), Registry()
    for name in ("control.controller", "telemetry.slo"):
        _private_families(monkeypatch, mod(JAX, name), MetricWrapperBase, jax_reg,
                          lambda m: m._upper_bounds)
        _private_families(monkeypatch, mod(PORT, name), _Metric, port_reg,
                          lambda m: m._bounds)


def slo_schedule(seed: int, rounds: int = 60) -> list:
    """(clock step, {slo: (good, bad)}) per round: quiet stretches and bad
    bursts, so alerts fire, change severity and clear."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(rounds):
        burst = (i // 10) % 3 == 1
        counts = {}
        for name in ("ttft", "score_latency"):
            good = int(rng.integers(50, 200))
            bad = int(rng.integers(20, 120)) if burst and rng.random() < 0.8 \
                else int(rng.integers(0, 2))
            counts[name] = (good, bad)
        out.append((float(rng.integers(5, 40)), counts))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_registry_matches_jax(seed):
    """The same records under the same injected clock: every round's
    ``evaluate_all``, the edges read through the cursor, and the level
    view equal the JAX package's."""
    got = {}
    for pkg in PKGS:
        slo = mod(pkg, "telemetry.slo")
        clock = FakeClock(5000.0)
        reg = slo.SLORegistry(clock=clock, max_edges=6)
        for name in ("ttft", "score_latency"):
            reg.add(slo.SLOConfig(name=name, objective=0.99, fast_windows=(60.0, 300.0),
                                  slow_window=400.0))
        rounds, cursor, pulled = [], -1, []
        for step, counts in slo_schedule(seed):
            clock.now += step
            for name, (good, bad) in counts.items():
                reg.get(name).record(good, bad)
            rounds.append(reg.evaluate_all())
            page = reg.export_edges_since(cursor)
            pulled.append(page)
            cursor = page["next_seq"]
        got[pkg] = (rounds, pulled, reg.export_edges_since(-1), reg.debug_view(),
                    {n: t.alert_severity for n, t in reg.trackers.items()})
    assert got[PORT] == got[JAX]
    edges = [e for page in got[PORT][1] for e in page["edges"]]
    assert {e["edge"] for e in edges} >= {"fire", "clear"}
    assert got[PORT][2]["dropped"] > 0  # the ring bound was reached


def scripted_signals(pkg: str, seed: int, rounds: int = 40) -> list:
    """FleetSignals of one package from a numpy seed: score burns rising
    and falling, an offered mix swinging between decode- and prefill-heavy,
    alert edges, and the topology the actuator's effects would give."""
    signals_cls = mod(pkg, "control.signals").FleetSignals
    rng = np.random.default_rng(seed)
    out = []
    for i in range(rounds):
        phase = (i // 8) % 4
        burn = float(rng.uniform(1.2, 3.0) if phase == 1 else rng.uniform(0.0, 0.2))
        sev = "fast_burn" if phase == 1 and rng.random() < 0.5 else None
        mix = float(rng.uniform(0.75, 0.95) if phase == 2 else rng.uniform(0.05, 0.3))
        edges = ({"slo": "ttft", "severity": "slow_burn", "edge": "fire", "ts": float(i),
                  "seq": i},) if phase == 2 and i % 8 == 0 else ()
        out.append(dict(ts=1000.0 + 30.0 * i,
                        slo={"score_latency": {"severity": sev, "burn_slow": burn},
                             "ttft": {"severity": None, "burn_slow": mix}},
                        alert_edges=edges,
                        handoff={"mix": {"prefill_fraction": mix, "samples": 10 + i}},
                        epoch=0))
    return [(signals_cls, kw) for kw in out]


class WorldSource:
    """Signals whose topology follows what the actuator did (so in-flight
    actions resolve against a world that reflects them)."""

    def __init__(self, scripted, world):
        self.scripted = list(scripted)
        self.world = world
        self.i = 0

    def poll(self):
        cls, kw = self.scripted[min(self.i, len(self.scripted) - 1)]
        self.i += 1
        return cls(shards=tuple(self.world["shards"]), roles=dict(self.world["roles"]), **kw)


def world_actuator(pkg: str, world: dict, log: list):
    def add_shard(target):
        world["shards"].append(target)
        log.append(("add_shard", target))
        return {"ok": True, "shard": target}

    def remove_shard(target):
        world["shards"].remove(target)
        log.append(("remove_shard", target))
        return {"ok": True}

    def set_role(target, role):
        world["roles"][target] = role
        log.append(("set_role", target, role))
        return {"ok": True, "role": role}

    def drain_pod(target):
        log.append(("drain_pod", target))
        return {"drained": True}

    return mod(pkg, "control.actions").InProcessActuator(
        add_shard=add_shard, remove_shard=remove_shard, set_role=set_role,
        drain_pod=drain_pod)


@pytest.mark.parametrize("seed,dry_run", [(3, False), (4, False), (5, True)])
def test_controller_matches_jax_on_scripted_signals(tmp_path, seed, dry_run):
    """The same scripted signals under the same injected clock give the
    same round summaries, actuator calls, journal bytes and views in both
    packages; a successor controller on each journal resumes alike and
    repeats nothing."""
    got, journals = {}, {}
    for pkg in PKGS:
        clock = FakeClock(1000.0)
        world = {"shards": ["shard-0", "shard-1"],
                 "roles": {"p-0": "prefill", "d-0": "decode", "d-1": "decode"}}
        log = []
        path = tmp_path / pkg / "actions.journal"
        path.parent.mkdir()
        cfg = mod(pkg, "control.config").ControllerConfig(
            journal_path=str(path), confirm_rounds=2, shard_cooldown_s=120.0,
            role_cooldown_s=90.0, drain_cooldown_s=120.0, action_budget=4,
            budget_window_s=400.0, dry_run=dry_run)
        controller_cls = mod(pkg, "control.controller").FleetController
        ctrl = controller_cls(WorldSource(scripted_signals(pkg, seed), world),
                              world_actuator(pkg, world, log), config=cfg, clock=clock)
        rounds = []
        for _ in range(40):
            clock.now += 30.0
            rounds.append(ctrl.reconcile_once())
        view = ctrl.debug_view()
        ctrl.stop()
        journals[pkg] = path.read_bytes()
        records = [r.to_wire() for r in mod(pkg, "control.journal").ActionJournal(
            str(path)).replay()]
        successor = controller_cls(WorldSource(scripted_signals(pkg, seed)[-1:], world),
                                   world_actuator(pkg, world, log), config=cfg, clock=clock)
        clock.now += 30.0
        after = successor.reconcile_once()
        got[pkg] = (rounds, log, view, records, successor.debug_view(), after)
        successor.stop()
    assert journals[PORT] == journals[JAX]
    assert got[PORT] == got[JAX]
    rounds, log, _view, records, resumed, after = got[PORT]
    assert records and resumed["resumed_records"] == len(records)
    assert after["settled"] == [] and after["pending"] == []
    if dry_run:
        assert log == [] and {r["phase"] for r in records} == {"would_act"}
    else:
        assert {entry[0] for entry in log} >= {"add_shard", "set_role"}
