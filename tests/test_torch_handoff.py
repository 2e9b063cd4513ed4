"""The port's disaggregated prefill/decode serving against the JAX package's.

- the handoff coordinator and the residency tracker: the cases of
  ``tests/test_handoff.py`` run through both packages with the same calls,
  holding equal states, bonuses, ``debug()`` snapshots and published
  events, besides the values the JAX tests expect;
- ``Indexer`` residency scoring (``role="decode"``, ``detail``) on both;
- role validation: the same refusals, with the JAX package's messages;
- engine pairs (a prefill-role pod streaming chunk commits, a decode-role
  pod pulling them) of both packages, as ``tests/test_failure_recovery.py``
  runs them: complete over a slow tier, prefill death with fallback, a torn
  chunk quarantined, and a handoff timeout. The port's tokens,
  ``cached_len`` and coordinator counters equal the JAX pair's (fp32
  models, weights carried by ``params_from_jax``), and the tokens equal a
  monolithic pod's at the same chunking;
- a prefill-role pod on the ragged scheduler;
- a port decode pod pulling the KV a JAX prefill pod streamed into the same
  store, each with its own package's coordinator.
"""

import dataclasses
import importlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokenProcessorConfig
from llmd_kv_cache_tpu.core.keys import TIER_TPU_HBM as JAX_TIER_TPU_HBM
from llmd_kv_cache_tpu.core.keys import PodEntry as JaxPodEntry
from llmd_kv_cache_tpu.index import InMemoryIndex as JaxInMemoryIndex
from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.offload import handoff as jax_handoff
from llmd_kv_cache_tpu.offload import spec as jax_spec
from llmd_kv_cache_tpu.offload import worker as jax_worker
from llmd_kv_cache_tpu.resilience.failpoints import failpoints as jax_failpoints
from llmd_kv_cache_tpu.scoring import Indexer as JaxIndexer
from llmd_kv_cache_tpu.scoring import IndexerConfig as JaxIndexerConfig
from llmd_kv_cache_tpu.scoring import residency as jax_residency
from llmd_kv_cache_tpu_torch.core.keys import TIER_TPU_HBM, PodEntry
from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
from llmd_kv_cache_tpu_torch.index.in_memory import InMemoryIndex
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload import handoff, spec, worker
from llmd_kv_cache_tpu_torch.resilience.failpoints import failpoints
from llmd_kv_cache_tpu_torch.scoring import residency
from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig

GQA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)
PAGE = GQA["page_size"]

# The two packages' control-plane modules, side by side.
PACKAGES = {"jax": (jax_handoff, jax_residency), "port": (handoff, residency)}


@pytest.fixture(autouse=True)
def quiet_jax_telemetry(monkeypatch):
    """Drop the JAX engines' restore latencies and shed outcomes in place of
    recording them in process-wide metric families, which a fleet test later
    in the same process would read as live slow restores and sheds."""
    collector = importlib.import_module("llmd_kv_cache_tpu.metrics.collector")
    monkeypatch.setattr(collector, "record_engine_restore", lambda outcome, seconds=None: None)
    monkeypatch.setattr(collector, "record_offload_restore", lambda tier, seconds: None)
    monkeypatch.setattr(collector, "record_shed", lambda site, outcome: None)


# --------------------------------------------------------------------------
# coordinator and tracker: the same calls on both packages
# --------------------------------------------------------------------------

def state_view(st):
    """A HandoffState as a dict, less its clock readings."""
    if st is None:
        return None
    d = dataclasses.asdict(st)
    d.pop("started")
    d.pop("finished")
    return d


def debug_view(coord) -> dict:
    """``debug()`` with the handoff latency reduced to whether it is set."""
    d = coord.debug()
    for view in (d, d["starvation"]):
        view["last_handoff_latency_s"] = view["last_handoff_latency_s"] is not None
    return d


def case_chunk_streaming_lifecycle(ho, _res, log):
    coord = ho.HandoffCoordinator()
    st = coord.begin("r1", "prefill-0", "decode-0", total_blocks=3)
    assert isinstance(st, ho.HandoffState)
    assert coord.queue_depth() == 1 and coord.in_flight_jobs() == 0
    coord.on_chunk_start("r1", [11])
    coord.on_chunk_start("r1", [12, 13])
    assert coord.in_flight_jobs() == 2
    coord.on_chunk_landed("r1", [11])
    st = coord.state("r1")
    assert st.landed_blocks == 1 and st.in_flight_jobs == 1 and not st.done
    log.append(state_view(st))
    coord.prefill_finished("r1")
    assert not coord.state("r1").done
    coord.on_chunk_landed("r1", [12, 13])
    st = coord.state("r1")
    assert st.done and not st.failed and st.landed_blocks == 3
    assert coord.queue_depth() == 0
    log.append(state_view(st))
    coord.decode_settled("r1", "complete")
    assert coord.state("r1") is None
    assert coord.completed == 1 and coord.failed == 0
    assert coord.last_latency_s is not None
    log.append(debug_view(coord))


def case_shed_blocks_within_landed_chunk(ho, _res, log):
    coord = ho.HandoffCoordinator()
    coord.begin("r1", "p", "d", total_blocks=3)
    coord.on_chunk_start("r1", [1, 2, 3])
    coord.on_chunk_landed("r1", [1, 2], shed=[3])
    st = coord.state("r1")
    assert st.landed_blocks == 2
    assert st.in_flight_blocks == 0 and st.in_flight_jobs == 0
    log.append(state_view(st))


def case_failed_chunk_is_not_terminal(ho, _res, log):
    coord = ho.HandoffCoordinator()
    coord.begin("r1", "p", "d", total_blocks=2)
    coord.on_chunk_start("r1", [1])
    coord.on_chunk_start("r1", [2])
    coord.on_chunk_failed("r1", [1])
    assert not coord.state("r1").failed
    log.append(state_view(coord.state("r1")))
    coord.prefill_finished("r1")
    coord.on_chunk_landed("r1", [2])
    assert coord.state("r1").done
    log.append(state_view(coord.state("r1")))


def case_fail_flips_failed_and_done(ho, _res, log):
    coord = ho.HandoffCoordinator()
    coord.begin("r1", "p", "d", total_blocks=3)
    coord.on_chunk_start("r1", [1])
    coord.fail("r1", "prefill pod died")
    st = coord.state("r1")
    assert st.failed and st.done and st.in_flight_jobs == 0
    log.append(state_view(st))
    coord.decode_settled("r1", "fallback")
    assert coord.failed == 1 and coord.completed == 0
    log.append(debug_view(coord))


def case_unknown_request_is_a_noop(ho, _res, log):
    coord = ho.HandoffCoordinator()
    coord.on_chunk_start("ghost", [1])
    coord.on_chunk_landed("ghost", [1])
    coord.on_chunk_failed("ghost", [1])
    coord.prefill_finished("ghost")
    coord.fail("ghost")
    coord.decode_settled("ghost", "complete")
    assert coord.queue_depth() == 0
    log.append(debug_view(coord))


def case_publish_hook_streams_availability_events(ho, _res, log):
    events = []
    coord = ho.HandoffCoordinator(publish=events.append)
    coord.begin("r1", "p", "decode-0", total_blocks=2)
    coord.on_chunk_start("r1", [1])
    coord.on_chunk_landed("r1", [1])
    coord.prefill_finished("r1")
    coord.on_chunk_start("r1", [2])
    coord.on_chunk_landed("r1", [2])
    assert [e.block_hashes for e in events] == [[1], [2]]
    assert [e.done for e in events] == [False, True]
    assert all(e.decode_pod == "decode-0" for e in events)
    log.extend((type(e).__name__, e.type, dataclasses.asdict(e)) for e in events)


def case_debug_snapshot(ho, _res, log):
    coord = ho.HandoffCoordinator()
    coord.begin("r1", "p", "d", total_blocks=1)
    coord.on_chunk_start("r1", [1])
    dbg = coord.debug()
    assert dbg["transfer_queue_depth"] == 1 and dbg["in_flight_jobs"] == 1
    assert dbg["completed"] == 0 and dbg["failed"] == 0
    assert dbg["last_handoff_latency_s"] is None
    log.append(dbg)


def case_pick_pair_prefers_scores_then_list_order(ho, _res, log):
    pick = ho.HandoffCoordinator.pick_pair
    assert pick(["p1", "p2"], ["d1", "d2"]) == ("p1", "d1")
    got = pick(["p1", "p2"], ["d1", "d2"], prefill_scores={"p2": 3.0},
               decode_scores={"d1": 0.5, "d2": 2.0})
    assert got == ("p2", "d2")
    log.append(got)
    with pytest.raises(ValueError):
        pick([], ["d1"])


def case_starvation_mix_and_outcomes(ho, _res, log):
    coord = ho.HandoffCoordinator()
    coord.observe_mix(0, 0)  # no tokens: ignored
    coord.observe_mix(300, 100)
    coord.observe_mix(100, 300)
    for i, outcome in enumerate(["complete", "timeout", "fallback"]):
        coord.begin(f"r{i}", "p", "d", total_blocks=1)
        coord.decode_settled(f"r{i}", outcome)
    for i in range(3, 6):  # deep queue, nothing in flight
        coord.begin(f"r{i}", "p", "d", total_blocks=1)
    log.append(debug_view(coord))
    assert coord.starvation()["starved_side"] == "prefill"


def case_residency_feed_from_the_coordinator(ho, res, log):
    tracker = res.ResidencyTracker()
    coord = ho.HandoffCoordinator(residency=tracker)
    coord.begin("r1", "p", "d0", total_blocks=4)
    coord.on_chunk_start("r1", [1, 2])
    log.append(tracker.bonus([1, 2, 3, 4]))
    coord.on_chunk_landed("r1", [1], shed=[2])
    log.append(tracker.bonus([1, 2, 3, 4]))
    coord.on_chunk_start("r1", [3, 4])
    coord.on_chunk_failed("r1", [3, 4])
    log.append((tracker.bonus([1, 2, 3, 4]), tracker.debug()))
    coord.decode_settled("r1", "complete")
    assert tracker.bonus([1]) == {}
    log.append(tracker.debug())


def case_landed_vs_in_flight_weights(_ho, res, log):
    tr = res.ResidencyTracker()
    tr.on_transfer_started("d0", [1, 2])
    assert tr.bonus([1, 2]) == {"d0": 1.0}
    tr.on_landed("d0", [1])
    assert tr.bonus([1, 2]) == {"d0": 1.5}
    tr.on_landed("d0", [2])
    assert tr.bonus([1, 2]) == {"d0": 2.0}
    log.append(tr.claim_rows([1, 2]))


def case_bonus_is_consecutive_from_zero(_ho, res, log):
    tr = res.ResidencyTracker()
    tr.on_landed("d0", [1, 3])
    assert tr.bonus([1, 2, 3]) == {"d0": 1.0}
    log.append(tr.claim_rows([1, 2, 3]))


def case_pod_filter_and_release(_ho, res, log):
    tr = res.ResidencyTracker()
    tr.on_landed("d0", [1])
    tr.on_landed("d1", [1])
    assert set(tr.bonus([1])) == {"d0", "d1"}
    assert set(tr.bonus([1], {"d1"})) == {"d1"}
    log.append(sorted(tr.claim_rows([1], {"d1"})))
    tr.on_released("d1", [1])
    assert set(tr.bonus([1])) == {"d0"}
    tr.release_pod_claims("d0")
    assert tr.bonus([1]) == {} and tr.claim_rows([1]) == []
    log.append(tr.debug())


def case_tier_discount_scales_bonus(_ho, res, log):
    tr = res.ResidencyTracker()
    tr.on_landed("d0", [1, 2])
    tr.tier_discount_fn = lambda: 0.25
    assert tr.bonus([1, 2]) == {"d0": 0.5}
    log.append(tr.discount())


CONTROL_CASES = [case_chunk_streaming_lifecycle, case_shed_blocks_within_landed_chunk,
                 case_failed_chunk_is_not_terminal, case_fail_flips_failed_and_done,
                 case_unknown_request_is_a_noop,
                 case_publish_hook_streams_availability_events, case_debug_snapshot,
                 case_pick_pair_prefers_scores_then_list_order,
                 case_starvation_mix_and_outcomes, case_residency_feed_from_the_coordinator,
                 case_landed_vs_in_flight_weights, case_bonus_is_consecutive_from_zero,
                 case_pod_filter_and_release, case_tier_discount_scales_bonus]


@pytest.mark.parametrize("case", CONTROL_CASES, ids=lambda c: c.__name__[5:])
def test_control_plane_matches_jax(case):
    logs = {}
    for name, (ho, res) in PACKAGES.items():
        logs[name] = []
        case(ho, res, logs[name])
    assert logs["port"] == logs["jax"]


def test_coordinator_keeps_plain_counters():
    """The chunk outcomes in JAX's metric family (kvtpu_handoff_chunks_total),
    the queue gauges it reads on demand and their metric gauges."""
    from llmd_kv_cache_tpu_torch.metrics import REGISTRY

    def chunks(outcome):
        return REGISTRY.get_sample_value("kvtpu_handoff_chunks_total",
                                         {"outcome": outcome}) or 0.0

    before = {o: chunks(o) for o in ("landed", "failed")}
    coord = handoff.HandoffCoordinator()
    coord.begin("r1", "p", "d", total_blocks=3)
    coord.on_chunk_start("r1", [1])
    coord.on_chunk_start("r1", [2])
    assert (coord.queue_depth(), coord.in_flight_jobs()) == (1, 2)
    assert REGISTRY.get_sample_value("kvtpu_handoff_in_flight_jobs") == 2
    coord.on_chunk_landed("r1", [1])
    coord.on_chunk_failed("r1", [2])
    assert {o: chunks(o) - n for o, n in before.items()} == {"landed": 1, "failed": 1}
    coord.prefill_finished("r1")
    assert (coord.queue_depth(), coord.in_flight_jobs()) == (0, 0)
    assert REGISTRY.get_sample_value("kvtpu_handoff_transfer_queue_depth") == 0


# --------------------------------------------------------------------------
# Indexer residency scoring
# --------------------------------------------------------------------------

def indexers():
    ours = Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
        block_size_tokens=PAGE)), index=InMemoryIndex())
    ref = JaxIndexer(JaxIndexerConfig(token_processor_config=JaxTokenProcessorConfig(
        block_size_tokens=PAGE)), index=JaxInMemoryIndex())
    return ((ours, PodEntry, TIER_TPU_HBM, residency),
            (ref, JaxPodEntry, JAX_TIER_TPU_HBM, jax_residency))


@pytest.mark.parametrize("landed", [2, 1], ids=["all-landed", "one-landed"])
def test_decode_role_adds_residency_bonus(landed):
    out = []
    for ix, entry, tier, res in indexers():
        tokens = list(range(8))
        keys = ix.compute_block_keys(tokens, "m")
        ix.kv_block_index.add(None, keys, [entry(pod_identifier="pod-a", device_tier=tier)])
        tracker = res.ResidencyTracker()
        tracker.on_landed("decode-0", keys[:landed])
        tracker.on_transfer_started("decode-1", keys)
        ix.attach_residency(tracker)
        assert tracker.tier_discount_fn is None  # the in-memory index has none
        assert ix.score_tokens(tokens, "m") == {"pod-a": 2.0}
        detail: dict = {}
        scores = ix.score_tokens(tokens, "m", role="decode", detail=detail)
        assert scores == {"pod-a": 2.0, "decode-0": float(landed), "decode-1": 1.0}
        assert detail["residency"] == {"decode-0": float(landed), "decode-1": 1.0}
        filtered: dict = {}
        out.append((scores, ix.score_tokens(tokens, "m", {"decode-1"}, role="decode",
                                            detail=filtered), filtered,
                    ix.score_tokens(tokens, "m", role="prefill")))
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------

def spec_kw(**kw):
    return dict(model_name="tiny", page_size=PAGE, num_layers=GQA["num_layers"],
                kv_heads=GQA["num_kv_heads"], head_dim=GQA["head_dim"], io_threads=2,
                dtype="float32", parallel_agnostic=True, **kw)


@pytest.fixture(scope="module")
def params():
    """The JAX engine's seed-0 weights, as numpy (both packages' pods use
    them)."""
    ref = jax_engine.MiniEngine(jax_engine.EngineConfig(
        model=jax_llama.LlamaConfig(**GQA, dtype=jnp.float32), num_pages=8,
        max_pages_per_seq=4, model_name="tiny"), seed=0)
    return jax.tree_util.tree_map(np.asarray, ref.params)


@pytest.fixture
def armed():
    failpoints.reset()
    jax_failpoints.reset()
    yield
    failpoints.reset()
    jax_failpoints.reset()


class Side:
    """One package's engine, coordinator and failpoint registry."""

    def __init__(self, name, params, clock=None):
        self.name = name
        self.params = params
        self.clock = clock
        if name == "jax":
            self.eng, self.ho, self.fp, self.worker = (jax_engine, jax_handoff,
                                                       jax_failpoints, jax_worker)
        else:
            self.eng, self.ho, self.fp, self.worker = engine, handoff, failpoints, worker

    def pod(self, root, pod, role="both", chunk=PAGE, store=True, **cfg_kw):
        cfg = dict(num_pages=64, max_pages_per_seq=16, model_name="tiny",
                   pod_identifier=pod, role=role, max_prefill_tokens=chunk, **cfg_kw)
        if self.name == "jax":
            return jax_engine.MiniEngine(
                jax_engine.EngineConfig(
                    model=jax_llama.LlamaConfig(**GQA, dtype=jnp.float32), **cfg),
                seed=0, offload_spec=(jax_spec.SharedStorageOffloadSpec(
                    root=str(root), **spec_kw()) if store else None))
        model = llama.LlamaConfig(**GQA, dtype=torch.float32)
        kw = {} if self.clock is None else {"clock": self.clock}
        return engine.MiniEngine(
            engine.EngineConfig(model=model, **cfg),
            params=llama.params_from_jax(self.params, model, device="cpu"), device="cpu",
            offload_spec=spec.SharedStorageOffloadSpec(root=str(root), **spec_kw())
            if store else None, **kw)

    def pair(self, root, **cfg_kw):
        coord = self.ho.HandoffCoordinator()
        pre = self.pod(root, "prefill-0", "prefill", **cfg_kw)
        dec = self.pod(root, "decode-0", "decode", **cfg_kw)
        for e in (pre, dec):
            e.attach_handoff(coord)
        return coord, pre, dec

    def reference(self, root, prompt, max_new_tokens):
        """A monolithic pod's output at the same prefill chunking."""
        return self.pod(root, "ref", store=False).generate("ref", prompt, max_new_tokens)


def coord_view(coord) -> dict:
    return dict(completed=coord.completed, failed=coord.failed,
                outcomes=coord.starvation()["outcomes"],
                queue=coord.queue_depth(), in_flight=coord.in_flight_jobs())


def run_complete(side, root):
    """A slow tier (the first pull retries an injected I/O error): the
    decode pod waits, pulls every block as chunks land, and never starves
    its local row."""
    coord, pre, dec = side.pair(root)
    prompt = list(range(70, 82))  # 3 full blocks
    expected = side.reference(root, prompt, 4)
    local = dec.add_request("local", list(range(10, 22)), max_new_tokens=10)
    coord.begin("h1", "prefill-0", "decode-0", total_blocks=len(prompt) // PAGE)
    pref = pre.enqueue("h1", prompt, max_new_tokens=1)
    hreq = dec.enqueue("h1", prompt, max_new_tokens=4, handoff=True)
    side.fp.arm(side.worker.FP_LOAD_IO_ERROR, mode="custom", times=1)
    deadline = time.monotonic() + 120.0
    while not hreq.done and time.monotonic() < deadline:
        if not pref.done:
            pre.step()
        pre.poll_offload()
        emitted = dec.step()
        if not local.done:
            assert "local" in emitted  # never starved by the wait
    assert hreq.done and hreq.output == expected
    assert hreq.cached_len == len(prompt) and hreq.restored_blocks == 3
    assert coord.state("h1") is None and coord.completed == 1
    while not local.done:  # how far it got before H finished is timing
        dec.step()
    assert local.output == side.reference(root, list(range(10, 22)), 10)
    return dict(tokens=hreq.output, local=local.output, cached_len=hreq.cached_len,
                restored=hreq.restored_blocks, coord=coord_view(coord))


def run_prefill_death(side, root):
    """Prefill pod killed after chunk 1 of 3: the decode pod keeps the
    landed chunk, re-prefills the rest and matches the monolithic pod."""
    coord, pre, dec = side.pair(root)
    prompt = list(range(130, 142))
    expected = side.reference(root, prompt, 4)
    coord.begin("h2", "prefill-0", "decode-0", total_blocks=3)
    pre.enqueue("h2", prompt, max_new_tokens=1)
    hreq = dec.enqueue("h2", prompt, max_new_tokens=4, handoff=True)
    pre.step()
    pre.flush_offload()
    st = coord.state("h2")
    assert st is not None and st.landed_blocks == 1 and not st.done
    deadline = time.monotonic() + 60.0
    while hreq.cached_len < PAGE and time.monotonic() < deadline:
        dec.step()
    assert hreq.cached_len == PAGE
    pre.abort_request("h2")
    assert coord.state("h2").failed
    while not hreq.done:
        dec.step()
    assert hreq.output == expected
    assert coord.state("h2") is None and coord.failed >= 1
    return dict(tokens=hreq.output, cached_len=hreq.cached_len,
                restored=hreq.restored_blocks, coord=coord_view(coord))


def run_torn_chunk(side, root):
    """A torn transfer chunk: CRC verification quarantines it on the pull
    and the decode pod recomputes its whole prefix."""
    coord, pre, dec = side.pair(root)
    prompt = list(range(200, 212))
    expected = side.reference(root, prompt, 4)
    side.fp.arm(side.worker.FP_STORE_TORN, mode="custom", times=1)
    coord.begin("h3", "prefill-0", "decode-0", total_blocks=3)
    pref = pre.enqueue("h3", prompt, max_new_tokens=1)
    while not pref.done:
        pre.step()
    pre.flush_offload()
    torn = pref.block_hashes[0]
    assert pre.offload_manager.lookup([torn]) == 1  # the tear is silent
    hreq = dec.enqueue("h3", prompt, max_new_tokens=4, handoff=True)
    deadline = time.monotonic() + 120.0
    while not hreq.done and time.monotonic() < deadline:
        dec.step()
    assert hreq.done and hreq.output == expected
    assert hreq.cached_len == 0
    path = dec.offload_handlers.mapper.block_path(torn, 0)
    assert os.path.exists(path + side.worker.QUARANTINE_SUFFIX)
    return dict(tokens=hreq.output, cached_len=hreq.cached_len,
                restored=hreq.restored_blocks, coord=coord_view(coord))


def run_timeout(side, root):
    """The prefill pod lands chunk 1 and stalls: the decode pod pulls it,
    waits out ``handoff_wait_s`` (the port's engine clock is advanced; the
    JAX request's wait deadline is moved to the past), settles "timeout"
    and prefills the remainder itself."""
    coord, pre, dec = side.pair(root, handoff_wait_s=30.0)
    prompt = list(range(150, 162))
    expected = side.reference(root, prompt, 4)
    coord.begin("h4", "prefill-0", "decode-0", total_blocks=3)
    pre.enqueue("h4", prompt, max_new_tokens=1)
    hreq = dec.enqueue("h4", prompt, max_new_tokens=4, handoff=True)
    pre.step()
    pre.flush_offload()
    deadline = time.monotonic() + 60.0
    while hreq.cached_len < PAGE and time.monotonic() < deadline:
        dec.step()
    for _ in range(3):  # the wait is live: no local prefill
        dec.step()
        assert hreq.prefill_pos is not None and hreq.handoff_deadline is not None
    if side.clock is None:
        hreq.handoff_deadline = time.monotonic() - 1.0
    else:
        side.clock.now += 31.0
    while not hreq.done:
        dec.step()
    assert hreq.output == expected and coord.state("h4") is None
    return dict(tokens=hreq.output, cached_len=hreq.cached_len,
                restored=hreq.restored_blocks, coord=coord_view(coord))


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


@pytest.mark.parametrize("run", [run_complete, run_prefill_death, run_torn_chunk,
                                 run_timeout], ids=lambda r: r.__name__[4:])
def test_engine_pair_matches_jax(tmp_path, params, armed, run):
    got = {}
    for name in ("jax", "port"):
        clock = FakeClock() if (name == "port" and run is run_timeout) else None
        got[name] = run(Side(name, params, clock), tmp_path / name)
    assert got["port"] == got["jax"]


def test_timeout_with_nothing_landed(tmp_path, params):
    """No peer ever writes: the request times out on the engine's clock and
    computes its whole prompt, with the monolithic pod's tokens."""
    clock = FakeClock()
    side = Side("port", params, clock)
    coord, _pre, dec = side.pair(tmp_path, handoff_wait_s=5.0)
    prompt = list(range(40, 50))
    coord.begin("t", "prefill-0", "decode-0", total_blocks=2)
    req = dec.enqueue("t", prompt, max_new_tokens=3, handoff=True)
    for _ in range(4):
        dec.step()
        assert req.prefill_pos == 0 and req.restore_job is None
    clock.now += 5.0
    while not req.done:
        dec.step()
    assert req.output == side.reference(tmp_path, prompt, 3) and req.cached_len == 0
    assert coord.starvation()["outcomes"] == {"timeout": 1}


def test_abort_while_waiting_settles_failed(tmp_path, params):
    side = Side("port", params)
    coord, _pre, dec = side.pair(tmp_path)
    coord.begin("a", "prefill-0", "decode-0", total_blocks=2)
    dec.enqueue("a", list(range(8)), max_new_tokens=2, handoff=True)
    dec.step()
    assert dec.abort_request("a")
    assert coord.state("a") is None and coord.starvation()["outcomes"] == {"failed": 1}


def test_prefill_pod_streams_chunk_commits(tmp_path, params):
    """Each prefill chunk's full blocks enter the prefix cache and the
    store before the next chunk runs; the last store job settles after its
    request is gone and still reaches the coordinator."""
    side = Side("port", params)
    coord, pre, _dec = side.pair(tmp_path)
    events = []
    coord.publish = events.append
    prompt = list(range(60, 74))  # 3 full blocks + 2
    coord.begin("s", "prefill-0", "decode-0", total_blocks=3)
    req = pre.enqueue("s", prompt, max_new_tokens=1)
    commits = []
    while not req.done:
        pre.step()
        commits.append(req.committed_blocks)
    assert commits == [1, 2, 3, 3] and req.output and "s" not in pre.requests
    pre.flush_offload()
    # Store jobs settle in any order across the I/O threads.
    assert sorted(e.block_hashes for e in events) == sorted([h] for h in req.block_hashes)
    # The last chunk computed commits no new block here (3 full blocks, all
    # committed by the first three chunks), so whether the last landed
    # event says done depends on whether it settled before prefill end.
    assert not any(e.done for e in events[:-1]) and coord.state("s").done
    assert pre.offload_manager.lookup(req.block_hashes) == 3


def run_ragged_prefill_pod(side, root):
    """A prefill-role pod on the ragged scheduler streams its chunk commits
    from ``_ragged_step`` beside its own decode row; the decode pod pulls
    every block and matches the monolithic pod."""
    coord = side.ho.HandoffCoordinator()
    pre = side.pod(root, "prefill-0", "prefill", ragged_attention=True)
    dec = side.pod(root, "decode-0", "decode")
    for e in (pre, dec):
        e.attach_handoff(coord)
    prompt = list(range(90, 102))
    expected = side.reference(root, prompt, 4)
    row = pre.enqueue("row", list(range(3, 6)), max_new_tokens=12)  # a decode row
    pre.step()
    coord.begin("g", "prefill-0", "decode-0", total_blocks=3)
    pref = pre.enqueue("g", prompt, max_new_tokens=1)
    hreq = dec.enqueue("g", prompt, max_new_tokens=4, handoff=True)
    commits = []
    while not hreq.done:
        if not pref.done:
            pre.step()
            commits.append(pref.committed_blocks)
        pre.poll_offload()
        dec.step()
    assert commits == [1, 2, 3]
    assert hreq.output == expected and hreq.cached_len == 12
    assert coord.completed == 1
    return dict(tokens=hreq.output, row=row.output, commits=commits,
                cached_len=hreq.cached_len, coord=coord_view(coord))


def test_prefill_role_on_the_ragged_scheduler(tmp_path, params):
    got = {name: run_ragged_prefill_pod(Side(name, params), tmp_path / name)
           for name in ("jax", "port")}
    assert got["port"] == got["jax"]


def test_port_decode_pod_pulls_a_jax_prefill_pods_stream(tmp_path, params):
    """A JAX prefill pod streams chunk commits into the store, a port decode
    pod pulls them (each with its own package's coordinator): the port pod
    settles "complete" once every full block is resident, its pages equal
    the JAX pod's bit for bit, and its tokens the JAX monolithic pod's."""
    jax_side, port_side = Side("jax", params), Side("port", params)
    jax_coord, port_coord = jax_handoff.HandoffCoordinator(), handoff.HandoffCoordinator()
    pre = jax_side.pod(tmp_path, "prefill-0", "prefill")
    pre.attach_handoff(jax_coord)
    dec = port_side.pod(tmp_path, "decode-0", "decode")
    dec.attach_handoff(port_coord)
    prompt = list(range(170, 184))  # 3 full blocks + 2
    expected = jax_side.reference(tmp_path, prompt, 5)
    for coord in (jax_coord, port_coord):
        coord.begin("x", "prefill-0", "decode-0", total_blocks=3)
    pref = pre.enqueue("x", prompt, max_new_tokens=1)
    hreq = dec.enqueue("x", prompt, max_new_tokens=5, handoff=True)
    deadline = time.monotonic() + 120.0
    while not hreq.done and time.monotonic() < deadline:
        if not pref.done:
            pre.step()
        pre.poll_offload()
        dec.step()
    assert hreq.done and hreq.output == expected
    assert hreq.cached_len == 12 and hreq.restored_blocks == 3
    assert port_coord.completed == 1 and port_coord.state("x") is None
    assert jax_coord.state("x").done and not jax_coord.state("x").failed
    for h in pref.block_hashes:
        jp = pre.block_manager.blocks[h].page
        tp = dec.block_manager.blocks[h].page
        np.testing.assert_array_equal(np.asarray(pre.k_cache[:, jp]), dec.k_cache[:, tp].numpy())
        np.testing.assert_array_equal(np.asarray(pre.v_cache[:, jp]), dec.v_cache[:, tp].numpy())


# --------------------------------------------------------------------------
# role validation
# --------------------------------------------------------------------------

def refusal(fn) -> str:
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_non_both_role_requires_offload_spec(tmp_path, params, role):
    msgs = [refusal(lambda s=s: Side(s, params).pod(tmp_path, "p", role, store=False))
            for s in ("jax", "port")]
    assert msgs[0] == msgs[1] and "offload" in msgs[1]


def test_unknown_role_rejected(tmp_path, params):
    msgs = [refusal(lambda s=s: Side(s, params).pod(tmp_path, "p", "mixed"))
            for s in ("jax", "port")]
    assert msgs[0] == msgs[1] and "role" in msgs[1]


def test_handoff_enqueue_requires_offload_spec(tmp_path, params):
    eng = Side("port", params).pod(tmp_path, "p", store=False)
    assert "handoff" in refusal(lambda: eng.enqueue("r1", list(range(8)), handoff=True))
    assert not eng.requests  # refused before admission: nothing to release


def test_set_role_flips_and_validates(tmp_path, params):
    ours = Side("port", params).pod(tmp_path / "t", "p")
    ref = Side("jax", params).pod(tmp_path / "j", "p")
    for eng in (ours, ref):
        assert eng.set_role("prefill") == "both" and eng.cfg.role == "prefill"
        assert eng.set_role("decode") == "prefill"
    assert refusal(lambda: ours.set_role("x")) == refusal(lambda: ref.set_role("x"))
    bare = Side("port", params).pod(tmp_path, "b", store=False)
    assert "offload" in refusal(lambda: bare.set_role("decode"))
    assert bare.cfg.role == "both"
