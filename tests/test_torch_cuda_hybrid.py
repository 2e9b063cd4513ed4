"""Sliding windows, sinks and the hybrid two-pool engine on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the pods run the
hand-written kernels); elsewhere they skip. On a machine with the card,
which has no JAX (hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_hybrid.py -q

Small models the kernels take (head_dim 128, GQA group 2, page 16, bf16;
the CPU tests hold the same layouts against JAX at fp32): a hybrid model
(one full-attention and two SWA layers, window 64) and a uniform-SWA model
with 4 sinks. On the card every attention call launches a kernel, once a
layer a dispatch, and no plain version runs. The same engine on the CPU
(the plain versions, the same bf16 weights and traffic) takes the same
pages at every step: each manager's free count and each request's SWA
pages. Their first-token logits agree within 5% of the largest logit, and
their first tokens wherever the CPU's top two logits are further apart
than that (bf16 GEMMs of other shapes round differently). A hybrid burst
replayed from the engine's CUDA graph gives the tokens and pools of the
same burst run eagerly through the kernels from identical pools.
"""

import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=512, hidden_size=256, num_layers=3, num_heads=4, num_kv_heads=2,
             head_dim=128, intermediate_size=512, page_size=16)
LAYOUTS = {"hybrid": dict(SMALL, sliding_window=64, swa_layers=(0, 2)),
           "swa-sinks": dict(SMALL, sliding_window=64, swa_layers=(0, 1, 2),
                             attention_sinks=4)}
LOGITS_REL_TOL = 5e-2
RNG = np.random.default_rng(31)
# A 190-token prompt and two continuing it (a hybrid pod resumes only
# where a committed window ends).
FIRST = RNG.integers(1, 512, 190).tolist()
PROMPTS = [FIRST] + [FIRST + RNG.integers(1, 512, n).tolist() for n in (7, 66)]


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


def make(model, params, device, **kw):
    return engine.MiniEngine(engine.EngineConfig(
        model=model, num_pages=96, num_swa_pages=48, max_pages_per_seq=24, max_batch=3,
        max_prefill_tokens=64, model_name="small", **kw), params=params, device=device)


def pages(eng):
    out = [eng.block_manager.num_free()]
    if eng.hybrid:
        out += [eng.swa_manager.num_free(),
                sorted((rid, r.swa_pages) for rid, r in eng.requests.items())]
    return out


def serve(eng, counted=False):
    """The three prompts served to 12 tokens each, the last two enqueued
    once the first is prefilled (so they resume at its trailing window);
    returns the requests, the pages after every step and, when
    ``counted``, whether every step launched layers x dispatches."""
    reqs = [eng.enqueue("r0", PROMPTS[0], max_new_tokens=12)]
    chunks, decodes = [], []
    inner_p, inner_d = eng._prefill_chunk, eng._decode_chunk
    eng._prefill_chunk = lambda req: (chunks.append(1), inner_p(req))[1]
    eng._decode_chunk = lambda chunk: (decodes.append(1), inner_d(chunk))[1]
    trace, ok = [], True
    layers = eng.cfg.model.num_layers
    while not all(r.done for r in reqs):
        before = (ops.cuda_paged_prefill_attention.launches,
                  ops.cuda_paged_decode_attention.launches, len(chunks), len(decodes))
        eng.step()
        trace.append(pages(eng))
        if len(reqs) == 1 and reqs[0].prefill_pos is None:
            reqs += [eng.enqueue(f"r{i}", p, max_new_tokens=12)
                     for i, p in enumerate(PROMPTS[1:], 1)]
        if counted:
            got = (ops.cuda_paged_prefill_attention.launches - before[0],
                   ops.cuda_paged_decode_attention.launches - before[1])
            ok &= got == (layers * (len(chunks) - before[2]), layers * (len(decodes) - before[3]))
    return reqs, trace, ok


@pytest.mark.parametrize("name", LAYOUTS)
def test_engine_on_the_card_runs_the_kernels_and_pages_as_the_cpu(card, monkeypatch, name):
    model = llama.LlamaConfig(**LAYOUTS[name])
    cpu_params = llama.init_params(model, seed=0, device="cpu")

    def no_plain(*args, **kwargs):
        raise AssertionError("plain attention ran on the card")

    with monkeypatch.context() as m:
        for mod in (ops, llama):
            m.setattr(mod, "paged_attention", no_plain)
        gpu_reqs, gpu_trace, launched = serve(make(model, to_device(cpu_params, card), card),
                                              counted=True)
        torch.cuda.synchronize()
    assert launched
    cpu_reqs, cpu_trace, _ = serve(make(model, cpu_params, "cpu"))
    assert gpu_trace == cpu_trace
    for g, c in zip(gpu_reqs, cpu_reqs):
        assert g.cached_len == c.cached_len and len(g.output) == 12
    assert gpu_reqs[1].cached_len > 0
    # First tokens: logits of the last prompt's final chunk.
    scale = float(np.abs(cpu_reqs[-1].last_logits).max())
    err = float(np.abs(gpu_reqs[-1].last_logits - cpu_reqs[-1].last_logits).max())
    assert err <= LOGITS_REL_TOL * scale, (err, scale)
    for g, c in zip(gpu_reqs, cpu_reqs):
        top2 = np.sort(c.last_logits)[-2:]
        if top2[1] - top2[0] > LOGITS_REL_TOL * scale:
            assert g.output[0] == c.output[0]


def test_hybrid_burst_graph_replays_the_eager_burst(card):
    model = llama.LlamaConfig(**LAYOUTS["hybrid"])
    params = llama.init_params(model, seed=1, device=card)
    eng = make(model, params, card, decode_burst=8)
    eng.generate("warm", PROMPTS[1], max_new_tokens=9)  # captures the graph
    assert eng._burst_graph is not None and not eng._burst_degraded
    reqs = [eng.enqueue(f"g{i}", p, max_new_tokens=81) for i, p in enumerate(PROMPTS)]
    while any(r.prefill_pos is not None for r in reqs):
        eng.step()
    page = model.page_size
    for r in reqs:  # the pages the next burst writes, as the engine takes them
        eng._swa_ensure(r, (r.computed_len + 8 - 1) // page)
    last, ctx, tables = eng._decode_batch_arrays(reqs, eng.cfg.max_batch)
    swa = np.zeros_like(tables)
    for i, r in enumerate(reqs):
        swa[i] = eng._swa_table_for(r)
    budgets = torch.tensor([r.max_new_tokens - len(r.output) for r in reqs], dtype=torch.int32,
                           device=card)
    pools = [t.clone() for t in (eng.k_cache, eng.v_cache, eng.k_swa, eng.v_swa)]
    eager = llama.forward_decode_steps_hybrid(
        params, model, torch.from_numpy(last).to(card), *pools,
        torch.from_numpy(tables).to(card), torch.from_numpy(swa).to(card),
        torch.from_numpy(ctx).to(card), budgets, 8)[0].cpu().tolist()
    before = [len(r.output) for r in reqs]
    assert all(n + 8 <= 81 for n in before)  # a whole burst left for every row
    eng.step()
    assert [r.output[n:] for r, n in zip(reqs, before)] == eager
    for got, want in zip((eng.k_cache, eng.v_cache, eng.k_swa, eng.v_swa), pools):
        assert torch.equal(got, want)
