"""The port's engine and indexer observability against the JAX package's.

Both packages' engines (tiny fp32 models, the same weights; JAX on its XLA
attention) serve the same traffic with telemetry on, an ``AuditLog`` and a
``WorkingSetTracker`` attached and a recording span exporter installed:
the padded scheduler with a traced request beside untraced ones and an
abort, bursts of 4, an admission shed and brownout, a deferred restore
from a tmpdir store, and a prefill/decode handoff pair. Held equal, apart
from times and ids: histogram counts, pool gauges and ``debug_vars``'
shape; flight-record kinds and data; span names, attributes and parentage;
metric deltas (both packages' families on registries of the test's own); audit
records; working-set stats. Also: telemetry on against off (tokens and
events), the ragged scheduler's dispatch tokens (the one difference from
JAX's ledger: its bucket), the port's injected clock making TTFT and ITL
exact, ``EngineConfig``'s fields against JAX's, and both indexers' score
path (span, ledger, flight record, audit prediction, working set, the
pool's store/evict/clear attribution).
"""

import dataclasses
import importlib
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import generate_latest as prom_latest

from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokenProcessorConfig
from llmd_kv_cache_tpu.events.model import EventBatch as JaxEventBatch
from llmd_kv_cache_tpu.events.pool import Pool as JaxPool
from llmd_kv_cache_tpu.events.pool import PoolConfig as JaxPoolConfig
from llmd_kv_cache_tpu.index import InMemoryIndex as JaxInMemoryIndex
from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.offload import handoff as jax_handoff
from llmd_kv_cache_tpu.offload import spec as jax_spec
from llmd_kv_cache_tpu.scoring import Indexer as JaxIndexer
from llmd_kv_cache_tpu.scoring import IndexerConfig as JaxIndexerConfig
from llmd_kv_cache_tpu.telemetry.engine_telemetry import (
    EngineTelemetryConfig as JaxTelemetryConfig,
)
from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
from llmd_kv_cache_tpu_torch.events.model import EventBatch
from llmd_kv_cache_tpu_torch.events.pool import Pool, PoolConfig
from llmd_kv_cache_tpu_torch.index.in_memory import InMemoryIndex
from llmd_kv_cache_tpu_torch.metrics import generate_latest
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload import handoff, spec
from llmd_kv_cache_tpu_torch.resilience import shedding
from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig
from llmd_kv_cache_tpu_torch.telemetry import engine_telemetry
from llmd_kv_cache_tpu_torch.telemetry.engine_telemetry import EngineTelemetryConfig, StepGate

from torch_telemetry_helpers import private_jax_metrics, private_port_metrics, samples

GQA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)
PAGE = GQA["page_size"]
PKG = {"jax": "llmd_kv_cache_tpu", "port": "llmd_kv_cache_tpu_torch"}
# Compared by delta: counters and histogram counts (their sums and buckets
# are times). Gauges by value after the traffic.
COUNTED = ("kvtpu_shed_decisions_total", "kvtpu_engine_restore_jobs_total",
           "kvtpu_engine_restore_latency_seconds_count", "kvtpu_offload_restore_seconds_count",
           "kv_offload_jobs_total", "kv_offload_total_bytes_total",
           "kv_offload_shed_blocks_total", "kvcache_engine_admission_delay_seconds_count",
           "kvtpu_engine_kv_pool_evictions_total", "kvtpu_engine_prefix_hit_blocks_total",
           "kvtpu_engine_requests_total", "kvtpu_engine_decode_steps_total",
           "kvtpu_engine_ragged_real_tokens_total", "kvtpu_engine_ragged_padded_tokens_total",
           "kvtpu_handoff_chunks_total", "kvtpu_handoff_requests_total",
           "kvtpu_handoff_latency_seconds_count", "kvtpu_engine_ttft_seconds_count",
           "kvtpu_engine_itl_seconds_count", "kvtpu_engine_tpot_seconds_count",
           "kvtpu_engine_decode_step_seconds_count", "kvtpu_workingset_sampled_accesses_total",
           "kvtpu_engine_profile_captures_total")
GAUGES = ("kvtpu_engine_kv_pool_free_pages", "kvtpu_engine_kv_pool_cached_blocks",
          "kvtpu_engine_kv_pool_orphan_pages", "kvtpu_handoff_transfer_queue_depth",
          "kvtpu_handoff_in_flight_jobs")
# Times and ids inside records and span attributes.
UNTIMED = {"job_id", "seconds", "delay_s", "ts", "mono", "seq", "staleness_s", "trace_id",
           "traceparent"}


@pytest.fixture(autouse=True)
def registries(monkeypatch) -> dict:
    """Both collectors' families on registries of this test's own."""
    return {"jax": private_jax_metrics(monkeypatch), "port": private_port_metrics(monkeypatch)}


@pytest.fixture(scope="module")
def params():
    ref = jax_engine.MiniEngine(jax_engine.EngineConfig(
        model=jax_llama.LlamaConfig(**GQA, dtype=jnp.float32), num_pages=8,
        max_pages_per_seq=4, model_name="tiny"), seed=0)
    return jax.tree_util.tree_map(np.asarray, ref.params)


class Clock:
    """A clock that ticks ``step`` seconds each time it is read."""

    def __init__(self, step=0.0):
        self.now, self.step = 0.0, step

    def __call__(self) -> float:
        self.now += self.step
        return self.now


def spec_kw():
    return dict(model_name="tiny", page_size=PAGE, num_layers=GQA["num_layers"],
                kv_heads=GQA["num_kv_heads"], head_dim=GQA["head_dim"], io_threads=2,
                dtype="float32", parallel_agnostic=True)


class Obs:
    """One package's engines and observability stack for one scenario: a
    recording span exporter, a fresh flight recorder, an AuditLog and a
    WorkingSetTracker (sample rate 1, an injected clock)."""

    def __init__(self, side, params, registries):
        self.side, self.params, self.registry = side, params, registries[side]
        mod = lambda name: importlib.import_module(f"{PKG[side]}.{name}")  # noqa: E731
        self.tm, self.fr = mod("telemetry.tracing"), mod("telemetry.flight_recorder")
        self.audit_mod, self.ws_mod = mod("telemetry.audit"), mod("telemetry.workingset")
        self.ho = jax_handoff if side == "jax" else handoff
        self.engines = []

    def __enter__(self):
        self.exporter = self.tm.install_span_exporter()
        self.fr.set_flight_recorder(self.fr.FlightRecorder(8192))
        self.audit = self.audit_mod.AuditLog()
        self.ws = self.ws_mod.WorkingSetTracker(
            self.ws_mod.WorkingSetConfig(enabled=True, sample_rate=1.0), clock=Clock())
        self.before = self.metrics()
        return self

    def __exit__(self, *exc):
        self.tm.uninstall_span_exporter()
        self.fr.set_flight_recorder(None)

    def metrics(self) -> dict:
        text = (prom_latest if self.side == "jax" else generate_latest)(self.registry).decode()
        return {k: v for k, v in samples(text).items() if k[0] in COUNTED + GAUGES}

    def engine(self, root=None, telemetry=True, observed=True, clock=None, **cfg_kw):
        cfg = dict(num_pages=48, max_pages_per_seq=16, model_name="tiny",
                   max_prefill_tokens=8, **cfg_kw)
        if telemetry:
            tel = (JaxTelemetryConfig if self.side == "jax" else EngineTelemetryConfig)
            cfg["telemetry"] = tel(pool_gauge_every=1)
        if self.side == "jax":
            eng = jax_engine.MiniEngine(
                jax_engine.EngineConfig(model=jax_llama.LlamaConfig(**GQA, dtype=jnp.float32),
                                        **cfg),
                seed=0, offload_spec=None if root is None else jax_spec.SharedStorageOffloadSpec(
                    root=str(root), **spec_kw()))
        else:
            model = llama.LlamaConfig(**GQA, dtype=torch.float32)
            eng = engine.MiniEngine(
                engine.EngineConfig(model=model, **cfg),
                params=llama.params_from_jax(self.params, model, device="cpu"), device="cpu",
                offload_spec=None if root is None else spec.SharedStorageOffloadSpec(
                    root=str(root), **spec_kw()), **({} if clock is None else {"clock": clock}))
        if observed:
            eng.attach_audit(self.audit)
            eng.attach_workingset(self.ws)
            self.engines.append(eng)
        return eng

    def summary(self) -> dict:
        """Everything compared, less times and ids."""
        after = self.metrics()
        delta = {k: v - self.before.get(k, 0.0) for k, v in after.items()
                 if k[0] in COUNTED and v != self.before.get(k, 0.0)}
        gauges = {k: v for k, v in after.items() if k[0] in GAUGES}
        spans = self.exporter.spans
        names = {s.span_id: s.name for s in spans}

        def clean(d):
            return {k: v for k, v in d.items() if k not in UNTIMED}

        span_view = sorted(repr((s.name, names.get(s.parent_span_id, s.parent_span_id and "remote"),
                                 clean(s.attributes), s.status)) for s in spans)
        recs = self.fr.flight_recorder().snapshot()
        ordered = [(r["kind"], clean(r["data"] or {})) for r in recs
                   if r["kind"] not in ("offload", "retry")]
        settled = sorted(repr((r["kind"], clean(r["data"]))) for r in recs
                         if r["kind"] in ("offload", "retry"))
        audit_recs = [clean(r) for r in self.audit.export_since(-1)["records"]]
        ws_debug = {k: v for k, v in self.ws.debug_view().items() if k != "overhead_s_total"}
        timed = ("start_unix", "duration_s", "overhead_s", "overhead_frac")
        windows = [{k: v for k, v in w.items() if k not in timed}
                   for w in self.ws.export_since(-1)["windows"]]
        engines = []
        for eng in self.engines:
            if eng.telemetry is None:
                continue
            dv = eng.telemetry.debug_vars()
            engines.append(dict(
                keys=shape(dv),
                pool=dv["pool"],
                requests={k: dv["requests"][k] for k in ("active", "finished_window")},
                recent=[{k: r[k] for k in ("request_id", "tokens", "prefix_hit_blocks",
                                           "traced", "outcome")}
                        for r in eng.telemetry.finished],
                steps=dv["steps"], ragged=dv["ragged"], stats=eng.block_manager.pool_stats()))
        return dict(metrics=delta, gauges=gauges, spans=span_view, records=ordered,
                    settled=settled, audit=audit_recs, workingset=ws_debug,
                    windows=windows, engines=engines)


def shape(d):
    """A nested dict's keys (the ``debug_vars`` layout)."""
    if isinstance(d, dict):
        return {k: shape(v) for k, v in d.items()}
    return type(d).__name__ if d is not None else None


def run_both(params, registry, scenario, tmp_path=None):
    out = {}
    for side in ("jax", "port"):
        with Obs(side, params, registry) as obs:
            root = None if tmp_path is None else tmp_path / side
            result = scenario(obs, root)
            out[side] = dict(result=result, summary=obs.summary())
    return out


def traced(obs, name="route"):
    """A root span's traceparent (a scorer's) in this package's tracer."""
    with obs.tm.tracer().span(name) as sp:
        return sp.traceparent


def drain(eng, reqs):
    while not all(r.done for r in reqs):
        eng.step()
    return [list(r.output) for r in reqs]


def scenario_padded(obs, _root, **cfg_kw):
    eng = obs.engine(pod_identifier="pod-a", **cfg_kw)
    prefix = list(range(1, 17))
    a = eng.enqueue("a", prefix + [20, 21, 22], max_new_tokens=6,
                    traceparent=traced(obs))
    b = eng.enqueue("b", prefix + [30, 31], max_new_tokens=5)
    c = eng.add_request("c", [5, 6, 7, 8, 9], max_new_tokens=3)
    x = eng.enqueue("x", list(range(100, 113)), max_new_tokens=9)
    eng.step()
    eng.step()
    eng.abort_request("x")
    out = drain(eng, [a, b, c])
    d = eng.enqueue("d", prefix + [40], max_new_tokens=4, traceparent=traced(obs, "d"))
    out += drain(eng, [d])
    return dict(tokens=out, aborted=x.output)


def scenario_burst(obs, root):
    return scenario_padded(obs, root, decode_burst=4)


def scenario_shed(obs, _root):
    """A tripped shedder: a low-priority shed, a brownout."""
    eng = obs.engine(pod_identifier="pod-s", shed_target_delay_s=0.5)
    sm = importlib.import_module(f"{PKG[obs.side]}.resilience.shedding")
    clock = Clock()
    eng.shedder = sm.CoDelShedder("engine.admission", target_delay_s=0.5, interval_s=0.1,
                                  clock=clock)
    eng.shedder.observe_delay(1.0)
    clock.now += 0.2
    eng.shedder.observe_delay(1.0)
    with pytest.raises(sm.OverloadShedError):
        eng.enqueue("low", [1, 2, 3, 4, 5], max_new_tokens=3,
                    priority=shedding.PRIORITY_LOW)
    b = eng.enqueue("b", [1, 2, 3, 4, 5], max_new_tokens=3)
    return dict(tokens=drain(eng, [b]))


def scenario_restore(obs, root):
    """A writer pod stores a prompt; a fresh pod restores it in a deferred
    restore beside a decoding row (offload job spans and records, restore
    metrics, the working set's storage stream)."""
    prompt = list(range(40, 57))  # 4 full blocks
    writer = obs.engine(root, pod_identifier="writer", observed=False)
    want = writer.generate("w", prompt, max_new_tokens=3)
    writer.flush_offload()
    eng = obs.engine(root, pod_identifier="reader")
    row = eng.enqueue("row", [9, 8, 7, 6, 5], max_new_tokens=6)
    eng.step()
    req = eng.enqueue("r", prompt, max_new_tokens=3, traceparent=traced(obs))
    out = drain(eng, [row, req])
    eng.flush_offload()
    return dict(tokens=out, want=want, restored=req.restored_blocks)


def scenario_handoff(obs, root):
    """A prefill-role pod streams a prompt's chunk commits to a decode-role
    pod (one coordinator, the request's traceparent on ``begin``)."""
    coord = obs.ho.HandoffCoordinator()
    pre = obs.engine(root, pod_identifier="prefill-0", role="prefill")
    dec = obs.engine(root, pod_identifier="decode-0", role="decode")
    for e in (pre, dec):
        e.attach_handoff(coord)
    prompt = list(range(70, 82))  # 3 full blocks
    tp = traced(obs)
    coord.begin("h1", "prefill-0", "decode-0", total_blocks=len(prompt) // PAGE,
                traceparent=tp)
    pref = pre.enqueue("h1", prompt, max_new_tokens=1, traceparent=tp)
    hreq = dec.enqueue("h1", prompt, max_new_tokens=4, handoff=True, traceparent=tp)
    # Each chunk's store lands before the next chunk commits, and the decode
    # pod pulls after the last: the chunks' landing order and the number of
    # pulls do not depend on the I/O threads (tests/test_torch_handoff.py
    # interleaves the pods).
    while not pref.done:
        pre.step()
        pre.flush_offload()
    deadline = time.monotonic() + 60.0
    while not hreq.done and time.monotonic() < deadline:
        dec.step()
    return dict(tokens=hreq.output, cached=hreq.cached_len, restored=hreq.restored_blocks,
                completed=coord.completed)


SCENARIOS = {"padded": scenario_padded, "burst": scenario_burst, "shed": scenario_shed,
             "restore": scenario_restore, "handoff": scenario_handoff}
# A deferred restore's load (and a handoff's pull) finishes on the I/O
# threads while steps go on: how many steps it takes (each observed, each
# emitting the row's token) is a matter of time, in both packages.
STEP_COUNTED = ("kvtpu_engine_decode_step_seconds_count", "kvtpu_engine_decode_steps_total")


def untime_steps(summary):
    for key in [k for k in summary["metrics"] if k[0] in STEP_COUNTED]:
        summary["metrics"].pop(key)
    for e in summary["engines"]:
        e.pop("steps")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_observability_matches_jax(tmp_path, params, registries, name):
    out = run_both(params, registries, SCENARIOS[name], tmp_path)
    jax_out, port_out = out["jax"], out["port"]
    assert port_out["result"] == jax_out["result"]
    got, ref = port_out["summary"], jax_out["summary"]
    if name in ("restore", "handoff"):
        untime_steps(got)
        untime_steps(ref)
    for key in ref:
        assert got[key] == ref[key], key
    # Each scenario exercised what it is for.
    assert got["engines"] and got["records"]
    if name in ("padded", "burst", "restore", "handoff"):
        assert any("engine.decode_step" in s or "engine.prefill_chunk" in s
                   for s in got["spans"]) or name == "handoff"
    if name == "restore":
        assert port_out["result"]["restored"] == 4 and got["settled"]
        assert any(k[0] == "kvtpu_engine_restore_jobs_total" for k in got["metrics"])
    if name == "shed":
        assert {dict(k[1])["outcome"] for k in got["metrics"]
                if k[0] == "kvtpu_shed_decisions_total"} == {"shed", "brownout"}
    if name == "handoff":
        assert any("handoff.complete" in s for s in got["spans"])


def test_telemetry_on_and_off_give_the_same_tokens_and_events(params, registries):
    """Telemetry, tracing, audit and working set change nothing served."""
    runs = []
    for telemetry in (True, False):
        with Obs("port", params, registries) as obs:
            eng = obs.engine(telemetry=telemetry, observed=telemetry, decode_burst=2,
                             pod_identifier="p")
            events = []
            eng.block_manager.event_sink = events.extend
            tp = traced(obs) if telemetry else None
            reqs = [eng.enqueue("a", list(range(1, 20)), max_new_tokens=7, traceparent=tp),
                    eng.enqueue("b", list(range(1, 13)) + [3, 3], max_new_tokens=5)]
            runs.append((drain(eng, reqs), [repr(e) for e in events],
                         eng.block_manager.pool_stats()))
            assert (eng.telemetry is not None) == telemetry
    assert runs[0] == runs[1]


def jax_flat_bucket(tokens):
    bucket = 8
    while bucket < tokens:
        bucket *= 2
    return bucket


def test_ragged_dispatch_tokens_are_unpadded_the_only_difference(params, registries):
    """On the ragged scheduler the port reports each ragged dispatch's real
    tokens as dispatched (its flat axis is not padded); JAX reports its
    power-of-two bucket. The padded prefill of ``add_request`` reports its
    page bucket in both. Everything else in the ledger is the same."""
    calls = {}

    def logged(obs, root):
        make = obs.engine

        def engine(*args, **kwargs):
            eng = make(*args, **kwargs)
            inner = eng.telemetry.on_dispatch_tokens

            def on_dispatch_tokens(real, dispatched):
                calls.setdefault(obs.side, []).append((real, dispatched))
                inner(real, dispatched)

            eng.telemetry.on_dispatch_tokens = on_dispatch_tokens
            return eng

        obs.engine = engine
        return scenario_padded(obs, root, ragged_attention=True)

    out = run_both(params, registries, logged)
    got, ref = out["port"]["summary"], out["jax"]["summary"]
    assert out["port"]["result"] == out["jax"]["result"]
    assert [r for r, _ in calls["port"]] == [r for r, _ in calls["jax"]]
    # The first call is add_request's padded prefill (5 tokens in 2 pages).
    assert calls["port"][0] == calls["jax"][0] == (5, 8)
    assert all(d == r for r, d in calls["port"][1:])
    assert all(d == jax_flat_bucket(r) for r, d in calls["jax"][1:])
    padded = ("kvtpu_engine_ragged_padded_tokens_total", (("group", "pod-a"),))
    real = ("kvtpu_engine_ragged_real_tokens_total", (("group", "pod-a"),))
    assert got["metrics"][real] == ref["metrics"][real] == sum(r for r, _ in calls["port"])
    assert got["metrics"][padded] == sum(d for _, d in calls["port"])
    assert ref["metrics"][padded] == sum(d for _, d in calls["jax"])
    ragged = [e["ragged"] for e in (got["engines"][0], ref["engines"][0])]
    assert ragged[0]["real_tokens_total"] == ragged[1]["real_tokens_total"]
    assert ragged[0]["dispatches"] == ragged[1]["dispatches"] == len(calls["port"])
    assert ragged[0]["last_waste_ratio"] == 0.0 < ragged[1]["last_waste_ratio"]
    for m in (got["metrics"], ref["metrics"]):
        m.pop(padded)
    for e in (got["engines"][0], ref["engines"][0]):
        e.pop("ragged")
    for key in ref:
        assert got[key] == ref[key], key


def test_injected_clock_makes_ttft_and_itl_exact(params, registries):
    """Telemetry reads the engine's clock: with a clock that ticks 1 ms a
    read, each request's lifecycle is a count of reads, the same every run."""
    views = []
    for _ in range(2):
        with Obs("port", params, registries) as obs:
            eng = obs.engine(pod_identifier="p", clock=Clock(1e-3))
            reqs = [eng.enqueue("a", list(range(1, 10)), max_new_tokens=4),
                    eng.enqueue("b", list(range(1, 6)), max_new_tokens=3)]
            drain(eng, reqs)
            views.append([{k: v for k, v in r.items() if k.endswith("_ts")}
                          for r in eng.telemetry.finished])
            tel = eng.telemetry
            itl, ttft = tel.itl.snapshot(), tel.ttft.snapshot()
    assert views[0] == views[1]
    for r in views[0]:
        assert r["enqueue_ts"] < r["admit_ts"] <= r["first_token_ts"] <= r["last_token_ts"] \
            < r["finish_ts"]
        assert round(r["enqueue_ts"] * 1e3, 6) == int(round(r["enqueue_ts"] * 1e3))
    assert ttft["count"] >= 2 and itl["count"] >= 5


def test_profiler_capture_holds_steps_off_while_it_starts_and_stops(
        params, registries, tmp_path, monkeypatch):
    """A capture on a thread of its own while the engine steps on this one:
    the profiler starts and stops with no step running and new ones held
    off, and steps run while it records."""
    gate, steps, seen = engine_telemetry.STEP_GATE, [0], {}

    class Probe(torch.profiler.profile):
        def __enter__(self):
            seen["start"] = (gate._active, gate._closed, steps[0])
            return super().__enter__()

        def __exit__(self, *exc):
            seen["stop"] = (gate._active, gate._closed, steps[0])
            return super().__exit__(*exc)

    monkeypatch.setattr(torch.profiler, "profile", Probe)
    model = llama.LlamaConfig(**GQA, dtype=torch.float32)
    eng = engine.MiniEngine(
        engine.EngineConfig(model=model, num_pages=48, max_pages_per_seq=16, model_name="tiny",
                            max_prefill_tokens=8,
                            telemetry=EngineTelemetryConfig(profile_dir=str(tmp_path))),
        params=llama.params_from_jax(params, model, device="cpu"), device="cpu")
    result = {}
    th = threading.Thread(target=lambda: result.update(eng.telemetry.profiler.capture(0.2)))
    th.start()
    reqs = []
    while th.is_alive():
        if all(r.done for r in reqs):
            reqs = [eng.enqueue(f"r{steps[0]}-{i}", list(range(1, 9)), max_new_tokens=8)
                    for i in range(2)]
        eng.step()
        steps[0] += 1
    th.join()
    assert seen["start"][:2] == (0, True) and seen["stop"][:2] == (0, True)
    assert seen["stop"][2] > seen["start"][2]
    assert result["held_s"] > 0 and os.path.exists(result["trace"])


def test_step_gate_waits_for_steps_and_lets_nested_calls_through():
    gate, order = StepGate(), []
    inside, release = threading.Event(), threading.Event()

    def serve():
        with gate.step():
            inside.set()
            release.wait(5)
            with gate.step():  # nested on this thread: passes a waiting close
                order.append("nested")
            order.append("step")

    def close():
        with gate.closed():
            order.append("closed")

    server, closer = threading.Thread(target=serve), threading.Thread(target=close)
    server.start()
    assert inside.wait(5)
    closer.start()
    deadline = time.monotonic() + 5
    while not gate._closed and time.monotonic() < deadline:
        time.sleep(0.001)
    release.set()
    server.join(5)
    closer.join(5)
    assert order == ["nested", "step", "closed"]
    with gate.step():
        with pytest.raises(RuntimeError, match="inside an engine step"):
            with gate.closed():
                pass
    def late_step():
        with gate.step():
            order.append("late")

    with gate.closed():
        late = threading.Thread(target=late_step)
        late.start()
        time.sleep(0.05)
        assert order[-1] == "closed" and late.is_alive()
    late.join(5)
    assert order[-1] == "late"


def test_engine_config_has_every_jax_field():
    port = {f.name: f for f in dataclasses.fields(engine.EngineConfig)}
    ref = {f.name: f for f in dataclasses.fields(jax_engine.EngineConfig)}
    assert set(port) == set(ref)
    for name in ("use_pallas_decode", "use_pallas_prefill", "decode_batch_rows", "telemetry"):
        assert port[name].default == ref[name].default


def test_a_jax_configs_four_fields_carry_across(params):
    """A JAX EngineConfig's backend knobs and telemetry config, handed to
    the port field by field: the knobs are kept and change nothing, the
    telemetry config (JAX's class) turns the port's telemetry on."""
    jcfg = jax_engine.EngineConfig(
        model=jax_llama.LlamaConfig(**GQA, dtype=jnp.float32), num_pages=32,
        max_pages_per_seq=8, model_name="tiny", use_pallas_decode=False,
        use_pallas_prefill=True, decode_batch_rows=4,
        telemetry=JaxTelemetryConfig(pool_gauge_every=3, max_finished=5, ttft_buckets=(0.5, 2.0)))
    model = llama.LlamaConfig(**GQA, dtype=torch.float32)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "model"}
    cfg = engine.EngineConfig(model=model, **fields)
    eng = engine.MiniEngine(cfg, params=llama.params_from_jax(params, model, device="cpu"),
                            device="cpu")
    assert (cfg.use_pallas_decode, cfg.use_pallas_prefill, cfg.decode_batch_rows) == (
        False, True, 4)
    tcfg = eng.telemetry.cfg
    assert isinstance(tcfg, EngineTelemetryConfig)
    assert (tcfg.pool_gauge_every, tcfg.max_finished, tcfg.ttft_buckets) == (3, 5, (0.5, 2.0))
    plain = engine.MiniEngine(engine.EngineConfig(model=model, num_pages=32, max_pages_per_seq=8,
                                                  model_name="tiny"),
                              params=llama.params_from_jax(params, model, device="cpu"),
                              device="cpu")
    prompt = list(range(3, 14))
    assert eng.generate("r", prompt, 4) == plain.generate("r", prompt, 4)
    off = engine.MiniEngine(dataclasses.replace(cfg, telemetry={"enabled": False}),
                            params=llama.params_from_jax(params, model, device="cpu"),
                            device="cpu")
    assert off.telemetry is None


# --------------------------------------------------------------------------
# the indexer and the event pool
# --------------------------------------------------------------------------

def score_path(side, registry):
    """Two pods' engine events into this package's pool (ledger shared), then
    scores with an AuditLog and a WorkingSetTracker attached, one inside a
    root span; a clear. Returns what is compared."""
    with Obs(side, None, registry) as obs:
        if side == "jax":
            ix = JaxIndexer(JaxIndexerConfig(token_processor_config=JaxTokenProcessorConfig(
                block_size_tokens=PAGE)), index=JaxInMemoryIndex())
            pool = JaxPool(JaxPoolConfig(concurrency=1), ix.kv_block_index, ix.token_processor)
            from llmd_kv_cache_tpu.events import model as ev
            batch = JaxEventBatch
        else:
            ix = Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
                block_size_tokens=PAGE)), index=InMemoryIndex())
            pool = Pool(PoolConfig(concurrency=1), ix.kv_block_index, ix.token_processor)
            from llmd_kv_cache_tpu_torch.events import model as ev
            batch = EventBatch
        pool.ledger = ix.ledger
        ix.attach_audit(obs.audit)
        ix.attach_workingset(obs.ws)
        toks = list(range(1, 17))
        keys = ix.compute_block_keys(toks, "m")
        stored = ev.BlockStoredEvent(block_hashes=keys, tokens=toks, parent_hash=0,
                                     block_size=PAGE)
        pool.process_event_batch(batch(timestamp=0.0, events=[stored]), "pod-a", "m")
        pool.process_event_batch(batch(timestamp=0.0, events=[
            ev.BlockStoredEvent(block_hashes=keys[:2], tokens=toks[:8], parent_hash=0,
                                block_size=PAGE)]), "pod-b", "m")
        pool.process_event_batch(batch(timestamp=0.0, events=[
            ev.BlockRemovedEvent(block_hashes=keys[3:])]), "pod-a", "m")
        scores = [ix.score_tokens(toks, "m")]
        with obs.tm.tracer().span("route"):
            scores.append(ix.score_tokens(toks + [1, 2], "m", {"pod-b"}))
        scores.append(ix.score_tokens([1, 2], "m"))
        pool.process_event_batch(batch(timestamp=0.0, events=[ev.AllBlocksClearedEvent()]),
                                 "pod-b", "m")
        scores.append(ix.score_tokens(toks, "m"))
        summary = obs.summary()
        text = (prom_latest if side == "jax" else generate_latest)(registry[side]).decode()
        return dict(scores=scores, ledger=ix.ledger.snapshot(), spans=summary["spans"],
                    records=summary["records"], audit=summary["audit"],
                    workingset=summary["workingset"],
                    score_hist=samples(text).get(("kvcache_score_latency_seconds_count", ())),
                    prefix_cache=ix.prefix_cache_stats())


def test_indexer_and_pool_observability_match_jax(registries):
    before = Indexer()._score_latency.count  # process-wide, as JAX's
    ref = score_path("jax", registries)
    got = score_path("port", registries)
    assert got.pop("score_hist") - before == ref.pop("score_hist") == 4
    assert got == ref
    assert got["ledger"]["pods"]["pod-a"]["evicted_blocks"] == 1
    assert got["ledger"]["pods"]["pod-b"]["clears"] == 1
    assert any("score_tokens" in s for s in got["spans"])
