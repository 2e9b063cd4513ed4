"""The offload tier's device legs on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the engine cases run
the hand-written kernels); elsewhere they skip. On a machine with the card,
which has no JAX (hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_offload.py -q

They check that gathers and scatters on CUDA pools are bit-equal to the
same copier on CPU pools; that gather buffers and staging slots are pinned
and an unpinned slab is refused; that a store issued right after the
prefill kernel wrote its pages, with no synchronisation by the caller,
writes exactly the pool's bytes (the copier's side stream waits on the
engine's stream); that the next forward reads a restore's pages only after
its scatter; and that a decode-burst pod replays its captured graph
correctly after a restore into its pools.
"""

import time

import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu_torch.core.keys import EMPTY_BLOCK_HASH
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload import spec
from llmd_kv_cache_tpu_torch.offload.cuda_copier import CUDABlockCopier
from llmd_kv_cache_tpu_torch.offload.staging import HostStagingPool

pytestmark = pytest.mark.cuda

# A small model the kernels take: head_dim 128, GQA group 2, page 16.
MODEL = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=128, intermediate_size=512, page_size=16)
GROUPS = [[3], [1, 2], [7, 5, 9], [0]] + [[p] for p in range(10, 150)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the offload copier's device legs)")
    return torch.Generator(device="cuda").manual_seed(0)


def pools(gen, mla=False):
    shape = (3, 160, 1 if mla else 2, 16, 576 if mla else 128)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = (k[..., :0].clone() if mla else
         torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))
    return k, v


def host_tensor(slab: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(slab.reshape(-1).view(np.int16))


def wait_results(handlers, job_id, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for res in handlers.get_finished():
            if res.job_id == job_id:
                return res
        time.sleep(0.002)
    raise TimeoutError("job did not finish")


@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_gather_and_scatter_on_the_card_equal_the_cpu_path(gen, mla):
    k, v = pools(gen, mla)
    on_card = CUDABlockCopier(k, v)
    on_cpu = CUDABlockCopier(k.cpu(), v.cpu())
    got = on_card.gather_many_to_host(GROUPS)
    want = on_cpu.gather_many_to_host(GROUPS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert host_tensor(g).is_pinned()

    # Scatter the card's (pinned) slabs to other pages of zeroed pools.
    dest = [[p + 1 for p in reversed(g)] for g in GROUPS]
    zk, zv = torch.zeros_like(k), torch.zeros_like(v)
    CUDABlockCopier(zk, zv).scatter_many_from_host(list(zip(got, dest)))
    ck, cv = zk.cpu().zero_(), zv.cpu().zero_()
    CUDABlockCopier(ck, cv).scatter_many_from_host(list(zip(want, dest)))
    torch.cuda.synchronize()
    assert torch.equal(zk.cpu(), ck) and torch.equal(zv.cpu(), cv)


def test_unpinned_slabs_are_refused_and_staging_is_pinned(gen, tmp_path):
    k, v = pools(gen)
    copier = CUDABlockCopier(k, v)
    assert copier.pinned_host_active
    slab = np.array(copier.gather_to_host([4]))  # a pageable copy
    with pytest.raises(RuntimeError, match="page-locked"):
        copier.scatter_from_host(slab, [5])
    staging = HostStagingPool(slot_bytes=copier.slab_nbytes(1), slots=2, pinned=True)
    views = [staging.acquire(copier.slab_nbytes(1)) for _ in range(3)]  # extends
    assert all(torch.from_numpy(vw).is_pinned() for vw in views)
    s = spec.SharedStorageOffloadSpec(root=str(tmp_path), model_name="m", num_layers=3,
                                      kv_heads=2, head_dim=128)
    handlers = s.get_handlers(k, v)
    try:
        assert handlers.staging.pinned
        buf = handlers.staging.acquire(handlers.file_bytes)
        assert torch.from_numpy(buf).is_pinned()
        handlers.staging.release(buf)
    finally:
        handlers.shutdown()


def test_store_right_after_the_prefill_writes_the_pool_bytes(gen, tmp_path):
    """The prefill kernel and its page scatter are still queued behind a
    long sleep on the engine's stream when the store is issued; the store
    must wait for them (no caller-side synchronisation). A first round
    loads the kernels and caches the memory, since first uses may make the
    host wait for the device."""
    cfg = llama.LlamaConfig(**MODEL)
    params = llama.init_params(cfg, seed=0, device="cuda")
    k, v = llama.init_kv_cache(cfg, 64, device="cuda")
    s = spec.SharedStorageOffloadSpec(root=str(tmp_path), model_name="m", num_layers=2,
                                      kv_heads=2, head_dim=128)
    handlers = s.get_handlers(k, v)
    pages = [5, 9, 2, 7]
    table = torch.zeros(1, 8, dtype=torch.int32, device="cuda")
    table[0, :4] = torch.tensor(pages, dtype=torch.int32)

    def prefill():
        tokens = torch.randint(1, 512, (1, 64), generator=gen, device="cuda")
        llama.forward_prefill(params, cfg, tokens, k, v, table,
                              torch.zeros(1, dtype=torch.int32, device="cuda"),
                              torch.full((1,), 64, dtype=torch.int32, device="cuda"),
                              last_only=True)

    def page_bytes(page):
        return torch.stack([k[:, page], v[:, page]], dim=1).cpu().view(torch.int16)

    try:
        prefill()
        assert wait_results(handlers, handlers.async_store_blocks(
            [(0x20 + i, [p]) for i, p in enumerate(pages)])).success
        torch.cuda.synchronize()
        before = [page_bytes(p) for p in pages]

        torch.cuda._sleep(1 << 29)  # ~0.3 s of the engine's stream
        prefill()  # other tokens: it rewrites the pages
        job = handlers.async_store_blocks([(0x10 + i, [p]) for i, p in enumerate(pages)])
        assert wait_results(handlers, job).success
        torch.cuda.synchronize()
        slot = handlers.slot_bytes
        for i, page in enumerate(pages):
            with open(handlers.mapper.block_path(0x10 + i), "rb") as f:
                payload = f.read()[:slot]
            want = page_bytes(page)
            assert not torch.equal(want, before[i])
            assert payload == want.numpy().tobytes()
    finally:
        handlers.shutdown()


def test_next_forward_reads_the_restored_pages(gen, tmp_path):
    """A deferred restore's scatter runs on the copier's stream; the prefill
    chunk and the decode steps that follow on the engine's stream (no
    caller-side synchronisation) read the restored pages: the tokens equal
    the writer's."""
    cfg = llama.LlamaConfig(**MODEL)
    params = llama.init_params(cfg, seed=0, device="cuda")
    kw = dict(root=str(tmp_path), model_name="m", num_layers=2, kv_heads=2, head_dim=128)

    def pod(name):
        return engine.MiniEngine(
            engine.EngineConfig(model=cfg, num_pages=64, max_pages_per_seq=16,
                                max_prefill_tokens=64, model_name="m", pod_identifier=name),
            params=params, device="cuda", offload_spec=spec.SharedStorageOffloadSpec(**kw))

    prompt = torch.randint(1, 512, (72,), generator=gen, device="cuda").tolist()  # 4 blocks + 8
    writer = pod("w")
    want = writer.generate("a", prompt, max_new_tokens=8)
    writer.flush_offload()
    reader = pod("r")
    req = reader.enqueue("b", prompt, max_new_tokens=8)
    while not req.done:
        reader.step()
    assert req.restored_blocks == 4 and req.output == want


def test_burst_pod_replays_its_graph_after_a_restore(gen, tmp_path):
    """decode_burst pods: the reader captures its burst graph on another
    request first, then restores a prefix into its pools in place and
    decodes it through the same graph: tokens and pages equal the
    writer's."""
    cfg = llama.LlamaConfig(**MODEL)
    params = llama.init_params(cfg, seed=0, device="cuda")
    kw = dict(root=str(tmp_path), model_name="m", num_layers=2, kv_heads=2, head_dim=128)

    def pod(name):
        return engine.MiniEngine(
            engine.EngineConfig(model=cfg, num_pages=128, max_pages_per_seq=16,
                                max_prefill_tokens=64, model_name="m", pod_identifier=name,
                                decode_burst=4),
            params=params, device="cuda", offload_spec=spec.SharedStorageOffloadSpec(**kw))

    prompt = torch.randint(1, 512, (72,), generator=gen, device="cuda").tolist()
    writer = pod("w")
    want = writer.generate("a", prompt, max_new_tokens=13)
    writer.flush_offload()

    reader = pod("r")
    other = torch.randint(1, 512, (40,), generator=gen, device="cuda").tolist()
    reader.generate("warm", other, max_new_tokens=9)  # captures the graph
    graph = reader._burst_graph
    assert graph is not None
    k_ptr = reader.k_cache.data_ptr()
    req = reader.add_request("b", prompt, max_new_tokens=13)
    assert req.restored_blocks == 4 and req.cached_len == 64
    while not req.done:
        reader.step()
    assert reader._burst_graph is graph and reader.k_cache.data_ptr() == k_ptr
    assert req.output == want
    hashes = reader.processor.tokens_to_kv_block_keys(EMPTY_BLOCK_HASH, prompt, "m")
    for h in hashes:
        pw, pr = writer.block_manager.blocks[h].page, reader.block_manager.blocks[h].page
        assert torch.equal(writer.k_cache[:, pw], reader.k_cache[:, pr])
        assert torch.equal(writer.v_cache[:, pw], reader.v_cache[:, pr])
