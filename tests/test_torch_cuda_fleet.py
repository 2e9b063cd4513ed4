"""The vLLM ``OffloadingSpec`` shim's store and load round trip on card pools.

Needs an NVIDIA GPU (the pools are CUDA tensors, the copier's gather and
scatter run on the card); elsewhere it skips. The vLLM API is
``chip_smoke``'s double in ``sys.modules`` (no vLLM on either machine). On
a machine with the card, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_fleet.py -q
"""

import sys
import time
from functools import partial

import pytest
import torch

from chip_smoke import GPULoadStoreSpec, OffloadKey, install_vllm_double, vllm_config

pytestmark = pytest.mark.cuda

LAYERS, PAGES, KV_HEADS, PAGE_SIZE, HEAD_DIM = 4, 64, 8, 16, 128


@pytest.fixture
def vllm_spec(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pools and the copier run on it)")
    yield install_vllm_double(partial(monkeypatch.setitem, sys.modules))
    sys.modules.pop("llmd_kv_cache_tpu_torch.offload.vllm_spec", None)


def finished(handler, job_id, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for res in handler.get_finished():
            if res.job_id == job_id:
                return res
        time.sleep(0.002)
    raise TimeoutError(f"transfer {job_id} did not finish")


def test_vllm_handlers_round_trip_card_pools(vllm_spec, tmp_path):
    """Pages of bf16 card pools stored as files of 16 pages each come back
    bit-equal into other pages of a zeroed pool; a missing file's load
    reports ``success=False``."""
    extra = {"shared_storage_path": str(tmp_path), "block_size": 16 * PAGE_SIZE,
             "page_size": PAGE_SIZE, "num_layers": LAYERS, "kv_heads": KV_HEADS,
             "head_dim": HEAD_DIM, "dtype": "bfloat16", "io_threads": 4}
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (LAYERS, PAGES, KV_HEADS, PAGE_SIZE, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    spec = vllm_spec.CUDAStorageOffloadingSpec(vllm_config(extra), None)
    store_h = list(spec.get_handlers((k, v)))[0][2]
    keys = [OffloadKey(0, 0xA1), OffloadKey(0, 0xB2)]
    src = list(range(3, 35))
    assert store_h.transfer_async(1, (GPULoadStoreSpec(src),
                                      vllm_spec.CUDASharedStorageLoadStoreSpec(keys)))
    assert finished(store_h, 1).success
    mgr = spec.get_manager()
    assert all(mgr.lookup(key, None) for key in keys)

    spec2 = vllm_spec.CUDAStorageOffloadingSpec(vllm_config(extra), None)
    k2, v2 = torch.zeros_like(k), torch.zeros_like(v)
    load_h = list(spec2.get_handlers((k2, v2)))[1][2]
    dst = list(range(30, 62))
    assert load_h.transfer_async(2, (vllm_spec.CUDASharedStorageLoadStoreSpec(keys),
                                     GPULoadStoreSpec(dst)))
    load_h.wait([2])
    torch.cuda.synchronize()
    assert torch.equal(k2[:, dst], k[:, src]) and torch.equal(v2[:, dst], v[:, src])
    assert [r.success for r in load_h.get_finished()] == [True]
    assert load_h.transfer_async(3, (vllm_spec.CUDASharedStorageLoadStoreSpec(
        [OffloadKey(0, 0xDEAD)]), GPULoadStoreSpec(list(range(16)))))
    assert finished(load_h, 3).success is False
    for s in (spec, spec2):
        s._handlers.shutdown()
