"""The port's offload tier against the JAX package's.

Same numpy inputs from a seed go through both packages:

- ``FileMapper``: fingerprints, block paths and ``config.json`` bytes;
- ``CUDABlockCopier`` (here on CPU pools) against ``TPUBlockCopier`` on pools
  holding the same bf16 bits: gather slabs and scatter results, compared as
  ``uint16``, including a batch over ``MAX_BATCH_PAGES``;
- both packages' handlers store the same pages under the same hashes on the
  posix and object backends, with and without multi-block spans: the files
  are byte-identical, checksum footer included;
- a tiny engine of either package writes a store that a tiny engine of the
  other restores, through ``add_request`` and through ``enqueue``: the
  restored pages are bit-equal to the writer's and the greedy tokens equal
  (fp32 models, weights carried by ``params_from_jax``);
- the cases of ``tests/test_engine_offload.py`` on the port's engine, and a
  torn file quarantined and recomputed, with the retry paths, driven by the
  port's failpoints.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.offload import file_mapper as jax_file_mapper
from llmd_kv_cache_tpu.offload import spec as jax_spec
from llmd_kv_cache_tpu.offload import worker as jax_worker
from llmd_kv_cache_tpu.offload.tpu_copier import TPUBlockCopier
from llmd_kv_cache_tpu_torch.core.keys import EMPTY_BLOCK_HASH
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload import file_mapper, native, spec, worker
from llmd_kv_cache_tpu_torch.offload.cuda_copier import CUDABlockCopier
from llmd_kv_cache_tpu_torch.offload.staging import HostStagingPool
from llmd_kv_cache_tpu_torch.resilience.failpoints import failpoints
from torch_telemetry_helpers import (
    private_flight_recorders,
    private_jax_metrics,
    private_port_metrics,
)

GQA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)
MLA = dict(GQA, num_kv_heads=4, kv_lora_rank=16, qk_rope_head_dim=8)
PAGE = GQA["page_size"]


@pytest.fixture(autouse=True)
def _private_globals(monkeypatch):
    """Both packages' metric families and flight recorders of the test's
    own: the engines record restore latencies, offload jobs and requests,
    which the JAX fleet tests later in the worker would otherwise read (run
    in one process after this file, ``tests/test_cluster_e2e.py``'s fleet
    tests saw a firing restore-latency SLO)."""
    private_jax_metrics(monkeypatch)
    private_port_metrics(monkeypatch)
    with private_flight_recorders():
        yield


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def bf16_pools(shape, v_width=None, seed=0):
    """The same bf16 bits as (JAX k, v) and (torch k, v) pools; a V width
    of 0 is the MLA pool."""
    rng = np.random.default_rng(seed)
    v_shape = shape if v_width is None else shape[:-1] + (v_width,)
    k_bits = rng.normal(size=shape).astype(np.float32).view(np.uint32) >> 16
    v_bits = rng.normal(size=v_shape).astype(np.float32).view(np.uint32) >> 16
    k_bits, v_bits = k_bits.astype(np.uint16), v_bits.astype(np.uint16)
    jk = jnp.asarray(k_bits.view(jnp.bfloat16))
    jv = jnp.asarray(v_bits.view(jnp.bfloat16))
    tk = torch.from_numpy(k_bits.view(np.int16).copy()).view(torch.bfloat16)
    tv = torch.from_numpy(v_bits.view(np.int16).copy()).view(torch.bfloat16)
    return (jk, jv), (tk, tv)


def as_words(x) -> np.ndarray:
    """Raw 16-bit words of a bf16 JAX/numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def wait_results(handlers, job_id, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for res in handlers.get_finished():
            if res.job_id == job_id:
                return res
        time.sleep(0.005)
    raise TimeoutError("job did not finish")


def tree_bytes(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def spec_kw(model: dict, **kw):
    mla = "kv_lora_rank" in model
    return dict(model_name="tiny", page_size=model["page_size"],
                num_layers=model["num_layers"],
                kv_heads=1 if mla else model["num_kv_heads"],
                head_dim=(model["kv_lora_rank"] + model["qk_rope_head_dim"]
                          if mla else model["head_dim"]),
                kv_streams=1 if mla else 2, io_threads=2, **kw)


# --------------------------------------------------------------------------
# FileMapper
# --------------------------------------------------------------------------

MAPPER_CASES = [
    pytest.param(dict(), id="gqa-default"),
    pytest.param(dict(kv_streams=1, kv_heads=1, head_dim=576), id="mla"),
    pytest.param(dict(pages_per_file=4), id="blocks-per-file-4"),
    pytest.param(dict(pages_per_file=4, kv_streams=1, integrity="none"), id="mla-bpf4-bare"),
    pytest.param(dict(integrity="none"), id="no-integrity"),
    pytest.param(dict(attention_sinks=4), id="sinks"),
    pytest.param(dict(rank=3), id="rank-3"),
    pytest.param(dict(rank=3, parallel_agnostic=True), id="parallel-agnostic"),
    pytest.param(dict(pages_per_block=2, sliding_window=64, swa_layers=(1, 3)),
                 id="pages-per-block-swa"),
]


@pytest.mark.parametrize("fields", MAPPER_CASES)
def test_file_mapper_matches_jax(tmp_path, fields):
    kw = dict(model_name="org/model-1.5b", num_layers=4, **fields)
    ours = file_mapper.FileMapper(file_mapper.FileMapperConfig(
        root=str(tmp_path / "port"), **kw))
    ref = jax_file_mapper.FileMapper(jax_file_mapper.FileMapperConfig(
        root=str(tmp_path / "jax"), **kw))
    assert ours.fingerprint == ref.fingerprint
    assert (os.path.relpath(ours.base_dir, tmp_path / "port")
            == os.path.relpath(ref.base_dir, tmp_path / "jax"))
    for h in (0, 1, 0xDEADBEEF, (1 << 64) - 1, -5, 1 << 70):
        for group in (0, 1):
            assert (os.path.relpath(ours.block_path(h, group), tmp_path / "port")
                    == os.path.relpath(ref.block_path(h, group), tmp_path / "jax"))
    ours.write_run_config()
    ref.write_run_config()
    with open(ours.config_path(), "rb") as a, open(ref.config_path(), "rb") as b:
        assert a.read() == b.read()
    assert file_mapper.FileMapper.parse_block_path(ours.block_path(0xABC, 1)) == (0xABC, 1)


@pytest.mark.parametrize("model", [GQA, MLA], ids=["gqa", "mla"])
@pytest.mark.parametrize("kw", [dict(), dict(blocks_per_file=4, integrity="none")],
                         ids=["default", "bpf4"])
def test_spec_fingerprint_matches_jax(tmp_path, model, kw):
    """The spec of either package resolves a store to the same directory
    (the port's single-device mesh fields are JAX's for no mesh)."""
    ours = spec.SharedStorageOffloadSpec(root=str(tmp_path), **spec_kw(model, **kw))
    ref = jax_spec.SharedStorageOffloadSpec(root=str(tmp_path), **spec_kw(model, **kw))
    assert ours.build_mapper().base_dir == ref.build_mapper().base_dir


def test_spec_rejects_what_is_not_ported(tmp_path):
    # The storage event publisher is ported: an events endpoint gives the
    # manager a publisher whose topic carries the medium in the pod slot.
    manager = spec.SharedStorageOffloadSpec(
        root=str(tmp_path), model_name="m",
        events_endpoint="tcp://localhost:5557").get_manager()
    assert manager.event_publisher.topic == "kv@SHARED_STORAGE@m"
    assert manager.block_size_tokens == 16
    manager.event_publisher.close()
    s = spec.SharedStorageOffloadSpec.from_extra_config(
        {"root": str(tmp_path), "modelName": "m", "kvStreams": 1, "blocksPerFile": 2})
    assert (s.kv_streams, s.blocks_per_file, s.model_name) == (1, 2, "m")
    k = torch.zeros(2, 8, 1, 16, 576, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kv_streams=1"):
        spec.SharedStorageOffloadSpec(root=str(tmp_path), model_name="m", num_layers=2,
                                      kv_heads=1, head_dim=576).get_handlers(
            k, k[..., :0])


# --------------------------------------------------------------------------
# native build and placement
# --------------------------------------------------------------------------

def test_kvio_builds_beside_the_checkout_not_in_csrc():
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT
    assert lib.name == "libkvio.so" and lib.exists()
    assert native.build() == lib  # keyed by a hash: built once


def test_numa_node_for_cpu_pools_and_the_override(monkeypatch):
    monkeypatch.delenv("KVIO_NUMA_NODE", raising=False)
    assert native.card_numa_node(torch.device("cpu")) == native.NUMA_OFF
    monkeypatch.setenv("KVIO_NUMA_NODE", "0")
    assert native.card_numa_node(torch.device("cpu")) == native.NUMA_DISCOVER


def test_staging_pool_recycles_and_extends():
    pool = HostStagingPool(slot_bytes=64, slots=2)
    views = [pool.acquire(64), pool.acquire(10), pool.acquire(64)]  # extends
    assert pool.total_slots == 4 and pool.free_slots == 1
    assert views[1].nbytes == 10
    big = pool.acquire(100)  # transient, released as a no-op
    for v in (*views, big):
        pool.release(v)
    pool.release(views[0])  # idempotent
    assert pool.free_slots == 4
    assert not pool.pinned


# --------------------------------------------------------------------------
# copier
# --------------------------------------------------------------------------

GROUPS = [[3], [1, 2], [7, 5, 9], [0]]
BIG = [[p] for p in range(1, 140)]  # 139 one-page groups: over MAX_BATCH_PAGES


@pytest.mark.parametrize("v_width", [None, 0], ids=["gqa", "mla"])
@pytest.mark.parametrize("groups", [GROUPS, BIG], ids=["groups", "over-max-batch"])
def test_copier_gather_matches_tpu_copier(v_width, groups):
    (jk, jv), (tk, tv) = bf16_pools((2, 160, 2, 4, 8), v_width)
    ref = TPUBlockCopier(jk, jv).gather_many_to_host(groups)
    ours = CUDABlockCopier(tk, tv)
    got = ours.gather_many_to_host(groups)
    assert len(got) == len(ref)
    for g, r, ids in zip(got, ref, groups):
        assert g.dtype == np.uint16 and g.shape == ours.slab_shape(len(ids))
        np.testing.assert_array_equal(g, as_words(r))
        assert g.flags.c_contiguous
    np.testing.assert_array_equal(ours.gather_to_host([4, 2]),
                                  as_words(TPUBlockCopier(jk, jv).gather_to_host([4, 2])))


@pytest.mark.parametrize("v_width", [None, 0], ids=["gqa", "mla"])
@pytest.mark.parametrize("groups", [GROUPS, BIG], ids=["groups", "over-max-batch"])
def test_copier_scatter_matches_tpu_copier(v_width, groups):
    (jk, jv), (tk, tv) = bf16_pools((2, 160, 2, 4, 8), v_width)
    slabs = TPUBlockCopier(jk, jv).gather_many_to_host(groups)
    dest = [g[::-1] for g in groups]  # scattered to other pages
    dest = [[p + 10 if p < 150 else p for p in g] for g in dest]
    (zk, zv), (ok, ov) = bf16_pools((2, 160, 2, 4, 8), v_width, seed=1)
    ref = TPUBlockCopier(zk, zv)
    ref.scatter_many_from_host([(s, d) for s, d in zip(slabs, dest)])
    ours = CUDABlockCopier(ok, ov)
    ours.scatter_many_from_host([(as_words(s), d) for s, d in zip(slabs, dest)])
    np.testing.assert_array_equal(as_words(ok), as_words(ref.k_cache))
    np.testing.assert_array_equal(as_words(ov), as_words(ref.v_cache))
    # In place: the copier holds the very tensors it was given.
    assert ours.k_cache is ok and ours.v_cache is ov
    assert not ours.pinned_host_active


# --------------------------------------------------------------------------
# handlers: byte-identical stores
# --------------------------------------------------------------------------

def handler_pair(tmp_path, backend, **kw):
    (jk, jv), (tk, tv) = bf16_pools((2, 40, 2, 4, 8))
    common = dict(model_name="m", page_size=4, num_layers=2, kv_heads=2, head_dim=8,
                  io_threads=2, backend=backend, **kw)
    ref = jax_spec.SharedStorageOffloadSpec(root=str(tmp_path / "jax"), **common)
    ours = spec.SharedStorageOffloadSpec(root=str(tmp_path / "port"), **common)
    return ref.get_handlers(jk, jv), ours.get_handlers(tk, tv), (tk, tv)


@pytest.mark.parametrize("backend", ["posix", "object"])
@pytest.mark.parametrize("integrity", ["crc32", "none"])
def test_handlers_write_the_jax_files(tmp_path, backend, integrity):
    ref, ours, _ = handler_pair(tmp_path, backend, integrity=integrity)
    transfers = [(0xA1, [3]), (0xB2, [5]), (1 << 63 | 7, [11])]
    try:
        for h in (ref, ours):
            assert wait_results(h, h.async_store_blocks(transfers)).success
        jax_files, port_files = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
        assert len(port_files) == 3
        assert port_files == jax_files
    finally:
        ref.shutdown()
        ours.shutdown()


@pytest.mark.parametrize("backend", ["posix", "object"])
def test_handlers_write_the_jax_span_files(tmp_path, backend):
    """Multi-block files (4 blocks of 2 pages each), crc32 footer per slot;
    then a partial (head-offset) load of the port's own file restores the
    pages bit-exactly."""
    ref, ours, (tk, tv) = handler_pair(tmp_path, backend, blocks_per_file=4,
                                       pages_per_block=2)
    blocks = [[2 * i + 1, 2 * i + 2] for i in range(8)]
    try:
        for h, mod in ((ref, jax_worker), (ours, worker)):
            spans = mod.map_blocks_to_file_spans([0x51, 0x52], 0, blocks, 4)
            assert wait_results(h, h.async_store_spans(spans)).success
        port_files = tree_bytes(tmp_path / "port")
        assert len(port_files) == 2
        assert port_files == tree_bytes(tmp_path / "jax")

        before_k, before_v = tk.clone(), tv.clone()
        tk[:, 20:30] = 0
        tv[:, 20:30] = 0
        span = worker.FileSpan(file_key=0x52, head_offset=1,
                               blocks=[[20, 21], [22, 23]])
        assert wait_results(ours, ours.async_load_spans([span])).success
        for dst, src in ((20, 11), (21, 12), (22, 13), (23, 14)):
            assert torch.equal(tk[:, dst], before_k[:, src])
            assert torch.equal(tv[:, dst], before_v[:, src])
    finally:
        ref.shutdown()
        ours.shutdown()


@pytest.mark.parametrize("backend", ["posix", "object"])
def test_port_restores_a_jax_handler_store(tmp_path, backend):
    """Files the JAX handlers wrote load into the port's pools bit-exactly."""
    (jk, jv), (tk, tv) = bf16_pools((2, 40, 2, 4, 8))
    common = dict(model_name="m", page_size=4, num_layers=2, kv_heads=2, head_dim=8,
                  io_threads=2, backend=backend, root=str(tmp_path))
    ref = jax_spec.SharedStorageOffloadSpec(**common).get_handlers(jk, jv)
    assert wait_results(ref, ref.async_store_blocks([(0xC1, [3, 4]), (0xC2, [9])])).success
    zk, zv = torch.zeros_like(tk), torch.zeros_like(tv)
    ours = spec.SharedStorageOffloadSpec(**common).get_handlers(zk, zv)
    try:
        res = wait_results(ours, ours.async_load_blocks([(0xC1, [30, 31]), (0xC2, [7])]))
        assert res.success
        for dst, src in ((30, 3), (31, 4), (7, 9)):
            np.testing.assert_array_equal(as_words(zk[:, dst]), as_words(jk[:, src]))
            np.testing.assert_array_equal(as_words(zv[:, dst]), as_words(jv[:, src]))
    finally:
        ref.shutdown()
        ours.shutdown()


# --------------------------------------------------------------------------
# engines across the packages
# --------------------------------------------------------------------------

def jax_pod(root, model, pod="pod-j"):
    jcfg = jax_llama.LlamaConfig(**model, dtype=jnp.float32)
    return jax_engine.MiniEngine(
        jax_engine.EngineConfig(model=jcfg, num_pages=64, max_pages_per_seq=16,
                                model_name="tiny", pod_identifier=pod),
        seed=0, offload_spec=jax_spec.SharedStorageOffloadSpec(
            root=str(root), dtype="float32", **spec_kw(model)))


def port_pod(root, model, params, pod="pod-t", **cfg_kw):
    tcfg = llama.LlamaConfig(**model, dtype=torch.float32)
    return engine.MiniEngine(
        engine.EngineConfig(model=tcfg, num_pages=64, max_pages_per_seq=16,
                            model_name="tiny", pod_identifier=pod, **cfg_kw),
        params=params, device="cpu", offload_spec=spec.SharedStorageOffloadSpec(
            root=str(root), dtype="float32", **spec_kw(model)))


def pages_of(eng, hashes) -> list:
    """Each block's (K, V) page contents as numpy, from an engine's pools."""
    out = []
    for h in hashes:
        page = eng.block_manager.blocks[h].page
        k, v = eng.k_cache[:, page], eng.v_cache[:, page]
        out.append((np.asarray(k), np.asarray(v)))
    return out


def serve(eng, prompt, deferred):
    """Serve ``prompt`` to 4 tokens, through add_request or enqueue."""
    req = (eng.enqueue if deferred else eng.add_request)("r", prompt, max_new_tokens=4)
    if deferred:
        assert req.restore_pending and req.cached_len == 0
    while not req.done:
        eng.step()
    return req


@pytest.mark.parametrize("model", [GQA, MLA], ids=["gqa", "mla"])
@pytest.mark.parametrize("deferred", [False, True], ids=["add_request", "enqueue"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_engine_store_restores_across_packages(tmp_path, model, deferred, writer):
    prompt = np.random.default_rng(3).integers(1, 256, 22).tolist()  # 5 blocks + 2
    jax_writer = jax_pod(tmp_path, model)
    params = llama.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_writer.params),
                                   llama.LlamaConfig(**model, dtype=torch.float32),
                                   device="cpu")
    if writer == "jax":
        src = jax_writer
        dst = port_pod(tmp_path, model, params)
    else:
        src = port_pod(tmp_path, model, params)
        dst = jax_pod(tmp_path, model, pod="pod-j2")
    want = src.generate("w", prompt, max_new_tokens=4)
    src.flush_offload()
    src_req_hashes = src.processor.tokens_to_kv_block_keys(EMPTY_BLOCK_HASH, prompt, "tiny")
    assert len(src_req_hashes) == 5
    assert dst.offload_manager.lookup(src_req_hashes) == 5

    req = serve(dst, prompt, deferred)
    assert req.cached_len == 5 * PAGE and req.restored_blocks == 5
    assert req.output == want
    for (k, v), (rk, rv) in zip(pages_of(dst, src_req_hashes),
                                pages_of(src, src_req_hashes)):
        np.testing.assert_array_equal(k, rk)
        np.testing.assert_array_equal(v, rv)


# --------------------------------------------------------------------------
# the cases of tests/test_engine_offload.py on the port's engine
# --------------------------------------------------------------------------

def make_engine(tmp_path, pod="pod-0", **spec_extra):
    tiny = llama.LlamaConfig.tiny()
    return engine.MiniEngine(
        engine.EngineConfig(model=tiny, num_pages=64, max_pages_per_seq=16,
                            model_name="tiny", pod_identifier=pod),
        device="cpu", offload_spec=spec.SharedStorageOffloadSpec(
            root=str(tmp_path), model_name="tiny", page_size=tiny.page_size,
            num_layers=tiny.num_layers, kv_heads=tiny.num_kv_heads,
            head_dim=tiny.head_dim, io_threads=2, parallel_agnostic=True,
            **spec_extra))


class TestWriteThroughAndRestore:
    def test_write_through_stores_blocks(self, tmp_path):
        eng = make_engine(tmp_path)
        req = eng.add_request("r1", list(range(50, 62)), max_new_tokens=1)
        eng.flush_offload()
        assert eng.offload_manager.lookup(req.block_hashes) == len(req.block_hashes)

    def test_restore_from_storage_on_fresh_engine(self, tmp_path):
        prompt = list(range(70, 86))
        a = make_engine(tmp_path, "pod-a")
        out_a = a.generate("r1", prompt, max_new_tokens=4)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        req = b.add_request("r2", prompt, max_new_tokens=4)
        assert req.cached_len == len(prompt)
        while not req.done:
            b.step()
        assert req.output == out_a

    def test_enqueue_defers_restore_into_step(self, tmp_path):
        prompt = list(range(70, 86))
        a = make_engine(tmp_path, "pod-a")
        out_a = a.generate("r1", prompt, max_new_tokens=4)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        req = b.enqueue("r2", prompt, max_new_tokens=4)
        assert req.restore_pending and req.cached_len == 0
        while not req.done:
            b.step()
        assert req.cached_len == len(prompt)
        assert req.output == out_a

    def test_deferred_restore_keeps_decodes_running(self, tmp_path):
        prompt = list(range(70, 86))
        a = make_engine(tmp_path, "pod-a")
        a.generate("warm", prompt, max_new_tokens=1)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        r1 = b.add_request("r1", list(range(10, 22)), max_new_tokens=8)
        r2 = b.enqueue("r2", prompt, max_new_tokens=2)
        while not r1.done:
            assert "r1" in b.step()  # never starved by the restore
        while not r2.done:
            b.step()
        assert r2.cached_len == len(prompt)

    def test_deferred_restores_overlap(self, tmp_path):
        prompt = list(range(70, 86))
        a = make_engine(tmp_path, "pod-a")
        out_a = a.generate("warm", prompt, max_new_tokens=4)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        starts = []
        orig = b._start_deferred_restore
        b._start_deferred_restore = lambda req: (starts.append(req.request_id), orig(req))[1]
        r1 = b.enqueue("r1", prompt, max_new_tokens=4)
        r2 = b.enqueue("r2", list(range(70, 82)), max_new_tokens=2)
        b.step()
        assert set(starts) == {"r1", "r2"}
        # Bounded by time, not steps: a step waiting on a load does no
        # model work, so hundreds of steps can pass before a load lands.
        deadline = time.monotonic() + 30.0
        while not (r1.done and r2.done) and time.monotonic() < deadline:
            b.step()
        assert r1.done and r2.done
        assert r1.output == out_a

    def test_abort_with_inflight_restore_is_nonblocking(self, tmp_path):
        prompt = list(range(70, 86))
        a = make_engine(tmp_path, "pod-a")
        out_a = a.generate("warm", prompt, max_new_tokens=4)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        b.enqueue("r1", prompt, max_new_tokens=4)
        b.step()
        start = time.monotonic()
        assert b.abort_request("r1")
        assert time.monotonic() - start < 1.0
        assert not b._restore_job_ids
        assert b.generate("r2", prompt, max_new_tokens=4) == out_a

    def test_partial_storage_hit(self, tmp_path):
        a = make_engine(tmp_path, "pod-a")
        a.add_request("r1", list(range(70, 78)), max_new_tokens=1)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        req = b.add_request("r2", list(range(70, 78)) + [9, 8, 7, 6, 5, 4, 3, 2],
                            max_new_tokens=1)
        assert req.cached_len == 8 and req.restored_blocks == 2

    def test_restore_drain_does_not_swallow_store_completions(self, tmp_path):
        prompt1 = list(range(70, 82))
        a = make_engine(tmp_path, "pod-a")
        a.add_request("r1", prompt1, max_new_tokens=1)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        r2 = b.add_request("r2", list(range(200, 212)), max_new_tokens=1)
        r3 = b.add_request("r3", prompt1, max_new_tokens=1)
        assert r3.cached_len == len(prompt1)
        start = time.monotonic()
        b.flush_offload(timeout_s=10.0)
        assert time.monotonic() - start < 5.0
        assert not b._pending_store_jobs
        assert b.offload_manager.lookup(r2.block_hashes) == len(r2.block_hashes)

    def test_restored_blocks_reenter_prefix_cache(self, tmp_path):
        a = make_engine(tmp_path, "pod-a")
        prompt = list(range(30, 42))
        a.add_request("r1", prompt, max_new_tokens=1)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        b.add_request("r2", prompt, max_new_tokens=1)
        req3 = b.add_request("r3", prompt, max_new_tokens=1)
        assert req3.cached_len == len(prompt) and req3.restored_blocks == 0

    def test_restore_latency_tap(self, tmp_path):
        a = make_engine(tmp_path, "pod-a")
        prompt = list(range(30, 42))
        a.add_request("r1", prompt, max_new_tokens=1)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b")
        seen = []
        b.on_restore_latency = seen.append
        b.add_request("r2", prompt, max_new_tokens=1)
        assert len(seen) == 1 and b._restore_latency_ema == seen[0] > 0

    def test_object_backend_round_trip(self, tmp_path):
        prompt = list(range(70, 86))
        a = make_engine(tmp_path, "pod-a", backend="object")
        out_a = a.generate("r1", prompt, max_new_tokens=4)
        a.flush_offload()
        b = make_engine(tmp_path, "pod-b", backend="object")
        req = serve(b, prompt, deferred=True)
        assert req.cached_len == len(prompt) and req.output == out_a[:4]

    def test_engine_refuses_a_mismatched_spec(self, tmp_path):
        tiny = llama.LlamaConfig.tiny()
        kw = dict(root=str(tmp_path), model_name="tiny", page_size=tiny.page_size,
                  num_layers=tiny.num_layers, kv_heads=tiny.num_kv_heads,
                  head_dim=tiny.head_dim)
        cfg = engine.EngineConfig(model=tiny, num_pages=64, max_pages_per_seq=16)
        with pytest.raises(ValueError, match="dtype"):
            engine.MiniEngine(cfg, device="cpu", offload_spec=spec.SharedStorageOffloadSpec(
                dtype="float16", **kw))
        with pytest.raises(ValueError, match="attention_sinks"):
            engine.MiniEngine(cfg, device="cpu", offload_spec=spec.SharedStorageOffloadSpec(
                attention_sinks=4, **kw))


# --------------------------------------------------------------------------
# faults: retries, a torn file quarantined and recomputed
# --------------------------------------------------------------------------

@pytest.fixture
def armed():
    failpoints.reset()
    yield failpoints
    failpoints.reset()


def port_handlers(tmp_path):
    (_, _), (tk, tv) = bf16_pools((2, 16, 2, 4, 8), seed=7)
    s = spec.SharedStorageOffloadSpec(root=str(tmp_path), model_name="m", page_size=4,
                                      num_layers=2, kv_heads=2, head_dim=8, io_threads=2)
    return s, s.get_handlers(tk, tv)


def test_host_buffers_return_to_their_pools(tmp_path, armed):
    """Store buffers (payload + footer) and load slots go back to their
    pools when a job settles: after success, a retried store, a torn load,
    and a cancelled load."""
    _s, h = port_handlers(tmp_path)
    store_pool, load_pool = h._store_buffers, h.staging

    def all_free():
        return (store_pool.free_slots == store_pool.total_slots
                and load_pool.free_slots == load_pool.total_slots)

    try:
        many = [(0x100 + i, [i % 16]) for i in range(40)]  # > the 32 first slots
        assert wait_results(h, h.async_store_blocks(many)).success
        assert store_pool.total_slots == 64 and all_free()
        assert wait_results(h, h.async_load_blocks(many)).success
        assert load_pool.total_slots == 64 and all_free()
        armed.arm(worker.FP_STORE_IO_ERROR, mode="custom", times=1)
        res = wait_results(h, h.async_store_blocks([(0xE1, [1])]))
        assert res.success and res.attempts == 2 and all_free()
        armed.arm(worker.FP_STORE_TORN, mode="custom", times=1)
        assert wait_results(h, h.async_store_blocks([(0xE2, [2])])).success
        assert wait_results(h, h.async_load_blocks([(0xE2, [3])])).corrupt_hashes == [0xE2]
        assert all_free()
        job = h.async_load_blocks([(0x100 + i, [i % 16]) for i in range(8)])
        h.wait_job(job, timeout_s=5.0)
        assert all_free()
    finally:
        h.shutdown()


@pytest.mark.parametrize("fp", [worker.FP_STORE_IO_ERROR, worker.FP_LOAD_IO_ERROR])
def test_transient_io_errors_retry(tmp_path, armed, fp):
    _s, h = port_handlers(tmp_path)
    try:
        if fp == worker.FP_STORE_IO_ERROR:
            armed.arm(fp, mode="custom", times=1)
        res = wait_results(h, h.async_store_blocks([(0xC1, [3])]))
        assert res.success and res.attempts == (2 if fp == worker.FP_STORE_IO_ERROR else 1)
        armed.arm(fp, mode="custom", times=1)
        res = wait_results(h, h.async_load_blocks([(0xC1, [5])]))
        assert res.success and res.attempts == (2 if fp == worker.FP_LOAD_IO_ERROR else 1)
        armed.arm(worker.FP_LOAD_IO_ERROR, mode="custom")  # every attempt
        res = wait_results(h, h.async_load_blocks([(0xC1, [5])]))
        assert not res.success and res.attempts == h.retry_policy.max_attempts
    finally:
        h.shutdown()


def test_torn_write_is_quarantined(tmp_path, armed):
    s, h = port_handlers(tmp_path)
    manager = s.get_manager()
    try:
        armed.arm(worker.FP_STORE_TORN, mode="custom", times=1)
        assert wait_results(h, h.async_store_blocks([(0xD1, [2])])).success
        assert manager.lookup([0xD1]) == 1
        res = wait_results(h, h.async_load_blocks([(0xD1, [2])]))
        assert not res.success and res.corrupt_hashes == [0xD1] and res.attempts == 1
        path = h.mapper.block_path(0xD1, 0)
        assert not os.path.exists(path)
        assert os.path.exists(path + worker.QUARANTINE_SUFFIX)
        assert manager.lookup([0xD1]) == 0
    finally:
        h.shutdown()


@pytest.mark.parametrize("deferred", [False, True], ids=["add_request", "enqueue"])
def test_engine_recomputes_a_torn_block(tmp_path, armed, deferred):
    """A flipped byte in one stored block: the restore fails verification,
    the file is quarantined, and the request recomputes its prefix — with
    the same tokens as the writer."""
    prompt = list(range(70, 86))
    a = make_engine(tmp_path, "pod-a")
    armed.arm(worker.FP_STORE_TORN, mode="custom", times=1)
    out_a = a.generate("r1", prompt, max_new_tokens=4)
    a.flush_offload()
    hashes = a.processor.tokens_to_kv_block_keys(EMPTY_BLOCK_HASH, prompt, "tiny")
    assert a.offload_manager.lookup(hashes) == 4  # the tear is silent

    b = make_engine(tmp_path, "pod-b")
    req = serve(b, prompt, deferred)
    assert req.restored_blocks == 0 and req.output == out_a
    quarantined = [h for h in hashes if os.path.exists(
        b.offload_handlers.mapper.block_path(h) + worker.QUARANTINE_SUFFIX)]
    assert len(quarantined) == 1
    # The recomputed block was written through again: a third pod restores
    # the whole prefix.
    b.flush_offload()
    c = make_engine(tmp_path, "pod-c")
    req = c.add_request("r3", prompt, max_new_tokens=4)
    assert req.restored_blocks == 4
