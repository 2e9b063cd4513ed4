"""The port's admission control against the JAX package's.

- ``resilience.deadline``: ``Deadline``, ``deadline_scope``,
  ``effective_timeout`` and the wire helpers, driven with injected clocks
  through the cases of ``tests/test_resilience.py`` on both packages, with
  the same answers;
- ``resilience.shedding``: both packages' ``CoDelShedder`` fed the same
  delay sequences, priorities and fake clock give the same verdict at
  every ``admit``, the same transitions and the same ``stats()``;
- ``MiniEngine.enqueue`` with the shedder tripped, on a port engine and a
  JAX engine: ``OverloadShedError`` on a shed, a brownout admitted without
  its restore; and ``step()`` feeding the admission delay, read on the
  port engine's injected clock;
- the deferred restore's deadline gate under ``deadline_s=0``, under a
  budget below the restore-latency EMA and under an ambient
  ``deadline_scope``: the restore is skipped and counted, and the tokens
  equal the JAX engine's (fp32 models, weights carried by
  ``params_from_jax``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.offload import spec as jax_spec
from llmd_kv_cache_tpu.resilience import deadline as jax_deadline
from llmd_kv_cache_tpu.resilience import shedding as jax_shedding
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload import spec
from llmd_kv_cache_tpu_torch.resilience import deadline, shedding

GQA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)

PACKAGES = {"jax": (jax_deadline, jax_shedding), "port": (deadline, shedding)}


class Clock:
    def __init__(self, now=0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


# --------------------------------------------------------------------------
# deadlines
# --------------------------------------------------------------------------

def dl_remaining_and_expiry(dm, log):
    clock = Clock()
    dl = dm.Deadline.after(1.0, clock=clock)
    log.append((dl.remaining_s(), dl.expired()))
    clock.now = 1.5
    log.append((dl.remaining_s(), dl.expired()))
    with pytest.raises(ValueError):
        dm.Deadline.after(-1.0, clock=clock)


def dl_wire_round_trip_is_relative(dm, log):
    dl = dm.Deadline.after(0.25, clock=Clock(100.0))
    ms = dl.to_wire_ms()
    peer = dm.Deadline.from_wire_ms(ms, clock=Clock(5.0))
    log.append((ms, peer.remaining_s()))


def dl_wire_decode_tolerates_garbage(dm, log):
    for ms in (None, 0, -5, "nonsense", "40", 3.9):
        got = dm.Deadline.from_wire_ms(ms, clock=Clock())
        log.append(None if got is None else got.remaining_s())


def dl_nearly_spent_budget_never_encodes_as_none(dm, log):
    clock = Clock()
    dl = dm.Deadline.after(0.0004, clock=clock)
    log.append(dl.to_wire_ms())
    clock.now = 1.0
    log.append(dl.to_wire_ms())


def dl_cap_timeout_takes_the_stricter(dm, log):
    clock = Clock()
    dl = dm.Deadline.after(0.5, clock=clock)
    log.append((dl.cap_timeout(2.0), dl.cap_timeout(0.1), dl.cap_timeout(None)))
    clock.now = 1.0
    log.append(dl.cap_timeout(2.0))


def dl_check_raises_with_site_and_overrun(dm, log):
    clock = Clock()
    dl = dm.Deadline.after(0.1, clock=clock)
    dl.check("early")
    clock.now = 0.35
    with pytest.raises(dm.DeadlineExceeded) as ei:
        dl.check("scoring.index_lookup")
    assert isinstance(ei.value, TimeoutError)
    log.append((ei.value.site, round(ei.value.overrun_s, 12), str(ei.value)))


def dl_ambient_scope_keeps_stricter_deadline(dm, log):
    clock = Clock()
    outer = dm.Deadline.after(1.0, clock=clock)
    inner_late = dm.Deadline.after(5.0, clock=clock)
    inner_early = dm.Deadline.after(0.2, clock=clock)
    names = {id(outer): "outer", id(inner_late): "late", id(inner_early): "early",
             id(None): None}
    log.append(names[id(dm.current_deadline())])
    with dm.deadline_scope(outer):
        log.append(names[id(dm.current_deadline())])
        with dm.deadline_scope(inner_late) as eff:
            log.append((names[id(dm.current_deadline())], names[id(eff)]))
        with dm.deadline_scope(inner_early):
            log.append(names[id(dm.current_deadline())])
        with dm.deadline_scope(None):
            log.append(names[id(dm.current_deadline())])
    log.append(names[id(dm.current_deadline())])


def dl_effective_timeout_and_metadata(dm, log):
    clock = Clock()
    log.append((dm.effective_timeout(3.0), dm.deadline_metadata()))
    with dm.deadline_scope(dm.Deadline.after(0.5, clock=clock)):
        log.append((dm.effective_timeout(3.0), dm.deadline_metadata()))
        log.append(dm.effective_timeout(None))
    log.append(dm.effective_timeout(2.0, dm.Deadline.after(0.25, clock=clock)))


def dl_extract_deadline_from_grpc_metadata(dm, log):
    class FakeContext:
        def invocation_metadata(self):
            return ((dm.GRPC_DEADLINE_KEY, "120"), ("traceparent", "x"))

    class EmptyContext:
        def invocation_metadata(self):
            return ()

    class BrokenContext:
        def invocation_metadata(self):
            raise RuntimeError("not a real context")

    dl = dm.extract_deadline(FakeContext())
    assert dl is not None and 0.0 < dl.remaining_s() <= 0.12
    log.append([dm.extract_deadline(c) for c in (None, EmptyContext(), BrokenContext())])
    log.append((dm.GRPC_DEADLINE_KEY, dm.WIRE_DEADLINE_KEY))


DEADLINE_CASES = [dl_remaining_and_expiry, dl_wire_round_trip_is_relative,
                  dl_wire_decode_tolerates_garbage, dl_nearly_spent_budget_never_encodes_as_none,
                  dl_cap_timeout_takes_the_stricter, dl_check_raises_with_site_and_overrun,
                  dl_ambient_scope_keeps_stricter_deadline, dl_effective_timeout_and_metadata,
                  dl_extract_deadline_from_grpc_metadata]


@pytest.mark.parametrize("case", DEADLINE_CASES, ids=lambda c: c.__name__[3:])
def test_deadline_matches_jax(case):
    logs = {}
    for name, (dm, _sm) in PACKAGES.items():
        logs[name] = []
        case(dm, logs[name])
    assert logs["port"] == logs["jax"]


# --------------------------------------------------------------------------
# CoDel shedding
# --------------------------------------------------------------------------

def drive(sm, script, target=0.005, interval=0.1):
    """Run ``script`` — (dt, delay or None, priorities) steps: advance the
    fake clock by dt, observe the delay, then admit each priority — on one
    package's shedder; returns every verdict, transition and stats()."""
    clock = Clock()
    s = sm.CoDelShedder("t", target_delay_s=target, interval_s=interval, clock=clock)
    events = []
    s.add_listener(lambda event, delay: events.append((event, delay)))
    s.add_listener(lambda event, delay: 1 / 0)  # a raising listener is ignored
    log = []
    for dt, delay, priorities in script:
        clock.now += dt
        if delay is not None:
            s.observe_delay(delay)
        log.append(([s.admit(p) for p in priorities], s.overloaded, s.pressure,
                    s.last_delay_s, s.shed_rate()))
    return log, events, s.stats()


LOW, NORMAL, CRITICAL = 0, 1, 2
SCRIPTS = {
    # A burst above target for less than an interval never sheds.
    "burst-below-an-interval": [(0.0, 0.05, [NORMAL]), (0.05, 0.05, [NORMAL, LOW])],
    # Sustained delay browns out, then the control law ramps to shedding.
    "sustained-ramps-to-shed": [(0.0, 0.05, [NORMAL]), (0.11, 0.05, [NORMAL, LOW, CRITICAL])]
    + [(0.2, 0.05, [NORMAL, LOW, CRITICAL]) for _ in range(6)],
    # The control law fires only at its inverse-sqrt cadence.
    "cadence": [(0.0, 0.01, []), (0.1, 0.01, [NORMAL])]
    + [(0.03, 0.01, [NORMAL]) for _ in range(20)],
    # A drained queue clears overload at once; a new burst starts over.
    "recovery-clears": [(0.0, 0.05, []), (0.11, 0.05, [NORMAL]), (0.0, 0.001, [NORMAL, LOW]),
                        (0.05, 0.05, [LOW]), (0.2, 0.05, [LOW, NORMAL])],
    # Admits with no observation in between keep the verdict.
    "no-observation": [(0.0, 0.02, []), (0.2, 0.02, []), (1.0, None, [LOW, NORMAL, NORMAL])],
}


@pytest.mark.parametrize("script", SCRIPTS.values(), ids=SCRIPTS.keys())
def test_codel_matches_jax(script):
    got = {name: drive(sm, script) for name, (_dm, sm) in PACKAGES.items()}
    assert got["port"] == got["jax"]


def test_codel_ramp_sheds_normal_after_the_same_firings():
    log, events, stats = drive(shedding, SCRIPTS["sustained-ramps-to-shed"])
    assert log[1][0] == [shedding.BROWNOUT, shedding.SHED, shedding.ADMIT]
    assert log[-1][0] == [shedding.SHED, shedding.SHED, shedding.ADMIT]
    assert log[-1][2] >= shedding._NORMAL_SHED_AFTER == jax_shedding._NORMAL_SHED_AFTER
    assert [e for e, _ in events] == ["overload"] and stats["site"] == "t"


def test_codel_invalid_config_matches_jax():
    for sm in (shedding, jax_shedding):
        with pytest.raises(ValueError):
            sm.CoDelShedder("t", target_delay_s=0.0)
        with pytest.raises(ValueError):
            sm.CoDelShedder("t", interval_s=-1.0)
    errs = [str(sm.OverloadShedError("engine.admission", 0.25)) for sm in (shedding, jax_shedding)]
    assert errs[0] == errs[1]


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------

def spec_kw():
    return dict(model_name="tiny", page_size=4, num_layers=2, kv_heads=2, head_dim=16,
                io_threads=2, dtype="float32", parallel_agnostic=True)


@pytest.fixture(autouse=True)
def jax_telemetry(monkeypatch) -> dict:
    """The JAX engine's shed outcomes, counted here in place of its
    process-wide metric families (its restore latencies are dropped): a
    fleet test later in the same process would read them as live sheds and
    slow restores."""
    collector = importlib.import_module("llmd_kv_cache_tpu.metrics.collector")
    counts: dict = {}

    def record_shed(site, outcome):
        counts[outcome] = counts.get(outcome, 0) + 1

    monkeypatch.setattr(collector, "record_shed", record_shed)
    monkeypatch.setattr(collector, "record_engine_restore", lambda outcome, seconds=None: None)
    monkeypatch.setattr(collector, "record_offload_restore", lambda tier, seconds: None)
    return counts


@pytest.fixture(scope="module")
def params():
    ref = jax_engine.MiniEngine(jax_engine.EngineConfig(
        model=jax_llama.LlamaConfig(**GQA, dtype=jnp.float32), num_pages=8,
        max_pages_per_seq=4, model_name="tiny"), seed=0)
    return jax.tree_util.tree_map(np.asarray, ref.params)


def pod(name, params, root=None, clock=None, **cfg_kw):
    cfg = dict(num_pages=64, max_pages_per_seq=16, model_name="tiny", **cfg_kw)
    if name == "jax":
        return jax_engine.MiniEngine(
            jax_engine.EngineConfig(model=jax_llama.LlamaConfig(**GQA, dtype=jnp.float32),
                                    **cfg),
            seed=0, offload_spec=None if root is None else jax_spec.SharedStorageOffloadSpec(
                root=str(root), **spec_kw()))
    model = llama.LlamaConfig(**GQA, dtype=torch.float32)
    return engine.MiniEngine(
        engine.EngineConfig(model=model, **cfg),
        params=llama.params_from_jax(params, model, device="cpu"), device="cpu",
        offload_spec=None if root is None else spec.SharedStorageOffloadSpec(
            root=str(root), **spec_kw()), clock=clock or Clock())


class PortSheds:
    """The port engines' admission decisions by outcome since this object
    was made: deltas of its ``kvtpu_shed_decisions_total`` family (site
    ``engine.admission``)."""

    def __init__(self):
        self.base = self.read()

    @staticmethod
    def read() -> dict:
        from llmd_kv_cache_tpu_torch.metrics.collector import sample_values

        return {dict(labels)["outcome"]: v for (name, labels), v in
                sample_values(["kvtpu_shed_decisions_total"]).items()
                if dict(labels).get("site") == "engine.admission"}

    def delta(self) -> dict:
        return {k: v - self.base.get(k, 0.0) for k, v in self.read().items()
                if v != self.base.get(k, 0.0)}


def tripped(name, eng, fire):
    """Swap in a shedder on a fake clock and drive it into overload, the
    control law fired ``fire`` times."""
    sm = jax_shedding if name == "jax" else shedding
    clock = Clock()
    eng.shedder = sm.CoDelShedder("engine.admission", target_delay_s=0.5, interval_s=0.1,
                                  clock=clock)
    eng.shedder.observe_delay(1.0)
    for _ in range(fire):
        clock.now += 0.2
        eng.shedder.observe_delay(1.0)
    assert eng.shedder.overloaded


def store_prompt(params, root, prompt):
    """A port pod writes ``prompt``'s blocks through to the store."""
    writer = pod("port", params, root, pod_identifier="writer")
    out = writer.generate("w", prompt, max_new_tokens=4)
    writer.flush_offload()
    return out


@pytest.mark.parametrize("name", ["jax", "port"])
def test_shed_and_brownout_at_enqueue(tmp_path, params, name, jax_telemetry):
    prompt = list(range(30, 46))  # 4 full blocks
    want = store_prompt(params, tmp_path, prompt)
    sheds = PortSheds()
    eng = pod(name, params, tmp_path, pod_identifier=f"{name}-pod", shed_target_delay_s=0.5)
    assert isinstance(eng.shedder, (shedding.CoDelShedder, jax_shedding.CoDelShedder))
    tripped(name, eng, fire=1)
    err = jax_shedding.OverloadShedError if name == "jax" else shedding.OverloadShedError
    with pytest.raises(err) as ei:
        eng.enqueue("low", prompt, max_new_tokens=4, priority=shedding.PRIORITY_LOW)
    assert ei.value.site == "engine.admission" and ei.value.queue_delay_s == 1.0
    assert "low" not in eng.requests
    # Brownout: admitted, but without the storage restore (recompute).
    req = eng.enqueue("b", prompt, max_new_tokens=4)
    assert not req.restore_pending
    crit = eng.enqueue("c", prompt[:8] + [7, 7, 7, 7], max_new_tokens=4,
                       priority=shedding.PRIORITY_CRITICAL)
    assert crit.restore_pending
    while not (req.done and crit.done):
        eng.step()
    assert req.output == want and req.cached_len == 0 and req.restored_blocks == 0
    assert crit.restored_blocks == 2
    assert eng.shedder.stats()["brownouts"] == 1 and eng.shedder.stats()["sheds"] == 1
    counts = jax_telemetry if name == "jax" else sheds.delta()
    assert counts == {"shed": 1, "brownout": 1}
    # Sustained overload sheds normal-priority work too.
    tripped(name, eng, fire=shedding._NORMAL_SHED_AFTER)
    with pytest.raises(err):
        eng.enqueue("n", prompt, max_new_tokens=4)


def test_step_feeds_the_admission_delay_on_the_engine_clock(params):
    """``step()`` observes enqueue → first pick on the engine's clock: the
    same delays fed to a JAX shedder give the same verdicts."""
    clock = Clock()
    sheds = PortSheds()
    eng = pod("port", params, clock=clock, shed_target_delay_s=0.5, shed_interval_s=0.1)
    ref = jax_shedding.CoDelShedder("engine.admission", target_delay_s=0.5, interval_s=0.1,
                                    clock=clock)
    verdicts = []
    for i, (wait, run) in enumerate([(0.6, 0.0), (0.6, 0.05), (0.7, 0.0), (0.1, 0.0),
                                     (0.8, 0.3), (0.9, 0.3)]):
        try:
            req = eng.enqueue(f"r{i}", [i + 1, 2, 3], max_new_tokens=1)
        except shedding.OverloadShedError:
            verdicts.append(("shed", ref.admit()))
            continue
        verdicts.append(("admitted", ref.admit()))
        clock.now += wait
        eng.step()  # the first pick: observes the wait, prefills, finishes
        ref.observe_delay(wait)
        assert req.done and req.enqueued_at is None
        clock.now += run
    assert eng.shedder.stats() == ref.stats()
    assert verdicts == [("admitted", "admit"), ("admitted", "admit"),
                        ("admitted", "brownout"), ("admitted", "brownout"),
                        ("admitted", "admit"), ("admitted", "admit")]
    assert sheds.delta() == {"brownout": 2}


def deferred(eng, prompt, **kw):
    req = eng.enqueue("r", prompt, max_new_tokens=4, **kw)
    while not req.done:
        eng.step()
    return req


@pytest.mark.parametrize("budget", ["zero", "below-ema", "ambient-spent"])
def test_deadline_gate_skips_the_deferred_restore(tmp_path, params, budget):
    prompt = list(range(50, 66))  # 4 full blocks
    want = store_prompt(params, tmp_path, prompt)
    out = {}
    for name in ("jax", "port"):
        sheds = PortSheds()
        eng = pod(name, params, tmp_path, pod_identifier=f"{name}-reader")
        jobs = []
        inner = eng.offload_handlers.async_load_blocks
        eng.offload_handlers.async_load_blocks = lambda *a, **k: jobs.append(a) or inner(*a, **k)
        dm = jax_deadline if name == "jax" else deadline
        if budget == "zero":
            req = deferred(eng, prompt, deadline_s=0)
        elif budget == "below-ema":
            eng._restore_latency_ema = 5.0  # restores take ~5 s here
            req = deferred(eng, prompt, deadline_s=1.0)
        else:
            with dm.deadline_scope(dm.Deadline.after(0.0)):
                req = deferred(eng, prompt)
        assert not jobs and req.cached_len == 0 and req.restored_blocks == 0
        out[name] = req.output
        if name == "port":
            assert sheds.delta() == {"restore_skip": 1}
    assert out["port"] == out["jax"] == want


def test_deadline_with_budget_left_restores(tmp_path, params):
    """A budget above the restore EMA keeps the restore: the gate skips only
    what cannot land in time."""
    prompt = list(range(90, 106))
    want = store_prompt(params, tmp_path, prompt)
    sheds = PortSheds()
    eng = pod("port", params, tmp_path, pod_identifier="reader")
    eng._restore_latency_ema = 0.5
    req = deferred(eng, prompt, deadline_s=60.0)
    assert req.restored_blocks == 4 and req.output == want and not sheds.delta()
    assert req.deadline is not None and eng._restore_latency_ema > 0
