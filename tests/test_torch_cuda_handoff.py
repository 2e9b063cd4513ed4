"""Disaggregated prefill/decode serving on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the pods run the
hand-written kernels); elsewhere they skip. On a machine with the card,
which has no JAX (hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_handoff.py -q

A small-width prefill-role pod streams a prompt's chunk commits through a
posix store to a decode-role pod that pulls them beside a decoding row.
On the card every attention call launches a kernel (no plain version
runs): the prefill pod launches the prefill kernel once a layer a chunk
and no decode kernel, the decode pod the prefill kernel once a layer for
the prompt's last token and the decode kernel once a layer a step. The
restored pages equal the prefill pod's bit for bit, and the decode pod's
tokens equal those of a "both" pod that restores the same blocks from the
store through ``add_request`` (the same 1-token chunk). The same pair
on the CPU's plain versions (the same bf16 weights) gives first-token
logits within 5% of the largest logit, and the same first token wherever
the CPU's top two logits are further apart than that (bf16 GEMMs of other
shapes round differently: a greedy stream may part at a near tie).
"""

import time

import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload import spec
from llmd_kv_cache_tpu_torch.offload.handoff import HandoffCoordinator
from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

pytestmark = pytest.mark.cuda

# A small model the kernels take: head_dim 128, GQA group 2, page 16.
MODEL = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=128, intermediate_size=512, page_size=16)
CHUNK = 32
PROMPT = np.random.default_rng(12).integers(1, 512, 80).tolist()  # 5 blocks: 32 + 32 + 16
LOGITS_REL_TOL = 5e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pods run the hand-written kernels)")
    return torch.device("cuda")


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def serve_pair(root, device, params, model):
    """Prefill pod → store → decode pod beside one decoding row; returns the
    request, each pod's launches and the pods."""
    kw = dict(num_pages=64, max_pages_per_seq=16, model_name="small",
              max_prefill_tokens=CHUNK)
    store = spec.SharedStorageOffloadSpec(
        root=str(root), model_name="small", page_size=16, num_layers=2, kv_heads=2,
        head_dim=128, io_threads=2)
    coord = HandoffCoordinator()
    pre, dec = (engine.MiniEngine(engine.EngineConfig(model=model, pod_identifier=pod,
                                                      role=role, **kw),
                                  params=params, device=device, offload_spec=store)
                for pod, role in (("prefill-0", "prefill"), ("decode-0", "decode")))
    for e in (pre, dec):
        e.attach_handoff(coord)
    local = dec.add_request("local", list(range(1, 21)), max_new_tokens=24)
    decode_steps = [0]
    inner = dec._decode_chunk

    def decode_chunk(chunk):
        decode_steps[0] += 1
        return inner(chunk)

    dec._decode_chunk = decode_chunk
    counted = (ops.cuda_paged_prefill_attention, ops.cuda_paged_decode_attention)
    launches = {"prefill-0": [0, 0], "decode-0": [0, 0]}

    def step(pod, name):
        before = [fn.launches for fn in counted]
        out = pod.step()
        launches[name] = [n + fn.launches - b for n, fn, b in
                          zip(launches[name], counted, before)]
        return out

    coord.begin("h", "prefill-0", "decode-0", total_blocks=5)
    pref = pre.enqueue("h", PROMPT, max_new_tokens=1)
    req = dec.enqueue("h", PROMPT, max_new_tokens=8, handoff=True)
    deadline = time.monotonic() + 120.0
    while not req.done and time.monotonic() < deadline:
        if not pref.done:
            step(pre, "prefill-0")
        pre.poll_offload()
        emitted = step(dec, "decode-0")
        if not local.done:
            assert "local" in emitted  # never starved by the wait
    assert req.done and coord.completed == 1 and coord.state("h") is None
    return req, launches, decode_steps[0], pre, dec, store


def test_pair_on_the_card_runs_the_kernels(card, tmp_path, monkeypatch):
    model = llama.LlamaConfig(**MODEL)
    cpu_params = llama.init_params(model, seed=0, device="cpu")

    def no_plain(*args, **kwargs):
        raise AssertionError("plain attention ran on the card")

    with monkeypatch.context() as m:
        for mod in (ops, llama):
            m.setattr(mod, "paged_attention", no_plain)
        req, launches, steps, pre, dec, store = serve_pair(
            tmp_path / "card", card, to_device(cpu_params, card), model)
        ref = engine.MiniEngine(engine.EngineConfig(
            model=model, num_pages=64, max_pages_per_seq=16, model_name="small",
            max_prefill_tokens=CHUNK), params=pre.params, device=card,
            offload_spec=store)
        ref_req = ref.add_request("r", PROMPT, max_new_tokens=8)
        while not ref_req.done:
            ref.step()
        torch.cuda.synchronize()
    layers = MODEL["num_layers"]
    assert launches["prefill-0"] == [layers * 3, 0]
    # The decode pod: one 1-token chunk for H, and a decode launch a layer
    # a decode step.
    assert launches["decode-0"] == [layers, layers * steps] and steps >= 7
    assert req.cached_len == 80 and req.restored_blocks == 5
    for h in req.block_hashes:
        pp, dp = pre.block_manager.blocks[h].page, dec.block_manager.blocks[h].page
        assert torch.equal(pre.k_cache[:, pp], dec.k_cache[:, dp])
        assert torch.equal(pre.v_cache[:, pp], dec.v_cache[:, dp])
    assert ref_req.restored_blocks == 5 and ref_req.output == req.output

    cpu_req = serve_pair(tmp_path / "cpu", "cpu", cpu_params, model)[0]
    scale = float(np.abs(cpu_req.last_logits).max())
    err = float(np.abs(req.last_logits - cpu_req.last_logits).max())
    assert err <= LOGITS_REL_TOL * scale, (err, scale)
    top2 = np.sort(cpu_req.last_logits)[-2:]
    if top2[1] - top2[0] > LOGITS_REL_TOL * scale:
        assert req.output[0] == cpu_req.output[0]
    agree = sum(a == b for a, b in zip(req.output, cpu_req.output))
    print(f"card vs CPU plain: first-token logits max err {err:.4e} of {scale:.4e}, "
          f"greedy agreement {agree}/{len(req.output)}")
