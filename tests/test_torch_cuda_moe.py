"""Mixture-of-experts layers and engines on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the engines run the
hand-written attention kernels); elsewhere they skip. On a machine with the
card, which has no JAX (hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_moe.py -q

The MoE layer of each router on the card against the same layer on the
CPU, in fp32, at the widths ``chip_smoke.py`` phase 15 serves with a few
tokens: Mixtral-8x7B's (8 experts of 14336 over hidden 4096, top 2, the
capacity dispatch at factor 0.5 so that assignments drop) and
Moonlight-16B-A3B's (64 experts of 1408 over hidden 2048, top 6 within the
best group by a non-zero ``router_bias``, two shared experts): the chosen
experts and the kept assignments are equal, and the outputs within 1e-4 of
the CPU's largest |output|. Then small bf16 engines (the kernels' head
widths) whose burst, replayed from the engine's CUDA graph with the MoE
layer inside it, gives the tokens and pools of the same burst run eagerly
from identical pools; their single steps launch the kernels once a layer a
dispatch and never the plain attention.
"""

import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

pytestmark = pytest.mark.cuda

# The full-width layer checks' config fields.
WIDE = {
    "mixtral-8x7b": dict(hidden_size=4096, intermediate_size=14336, num_experts=8,
                         num_experts_per_token=2, moe_capacity_factor=0.5),
    "moonlight-16b-a3b": dict(hidden_size=2048, intermediate_size=11264, num_experts=64,
                              num_experts_per_token=6, moe_dispatch="dense",
                              moe_intermediate_size=1408, n_shared_experts=2,
                              moe_router=("deepseek_v3", 1, 1, 1, 2.446)),
}
OUT_REL_TOL = 1e-4
SMALL = dict(vocab_size=512, hidden_size=256, num_layers=3, num_heads=4, num_kv_heads=2,
             head_dim=128, intermediate_size=512, page_size=16)
ENGINES = {
    "mixtral-small": dict(SMALL, num_experts=4, num_experts_per_token=2),
    "deepseek-small": dict(SMALL, num_heads=16, num_kv_heads=16, kv_lora_rank=512,
                           qk_rope_head_dim=64, num_experts=8, num_experts_per_token=2,
                           moe_dispatch="dense", moe_layers=(1, 2), n_shared_experts=1,
                           moe_intermediate_size=64, moe_router=("deepseek_v3", 4, 2, 1, 2.5)),
}
RNG = np.random.default_rng(15)
PREFIX = RNG.integers(1, 512, 70).tolist()
PROMPTS = [PREFIX + RNG.integers(1, 512, n).tolist() for n in (9, 30, 3)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the engines run the hand-written kernels)")
    return torch.device("cuda")


def wide_layer(fields, card, seed=0):
    """One expert layer at fp32 (0.02-scaled normals, the router's bias at
    0.5), made on the card from a seed, and the config."""
    cfg = llama.LlamaConfig(num_layers=1, dtype=torch.float32, **fields)
    gen = torch.Generator(device=card).manual_seed(seed)
    e, h = cfg.num_experts, cfg.hidden_size
    inter = cfg.moe_intermediate_size or cfg.intermediate_size

    def normal(*shape, scale=0.02):
        return torch.randn(shape, generator=gen, device=card) * scale

    layer = {"router": normal(h, e), "w_gate": normal(e, h, inter), "w_up": normal(e, h, inter),
             "w_down": normal(e, inter, h)}
    if cfg.deepseek_router:
        sh = inter * cfg.n_shared_experts
        layer.update(router_bias=normal(e, scale=0.5), w_gate_sh=normal(h, sh),
                     w_up_sh=normal(h, sh), w_down_sh=normal(sh, h))
    return cfg, layer


def routing(cfg, layer, x):
    """The chosen experts and, for the capacity dispatch, which assignments
    keep a slot."""
    if cfg.deepseek_router:
        return llama._deepseek_route(x[0], layer, cfg)[0], None
    top_idx = llama._moe_router(x, layer, cfg)[0]
    oh, pos = llama._capacity_slots(top_idx, cfg.num_experts)
    return top_idx, (oh.sum(1) > 0) & (pos < llama.moe_capacity(cfg, x.shape[1]))


@pytest.mark.parametrize("name", WIDE)
def test_moe_layer_on_the_card_matches_the_cpu(card, name):
    cfg, layer = wide_layer(WIDE[name], card)
    x = torch.randn((1, 16, cfg.hidden_size), generator=torch.Generator(device=card)
                    .manual_seed(1), device=card)
    cpu_layer = {k: v.cpu() for k, v in layer.items()}
    got = llama._mlp(x, layer, cfg).cpu()
    want = llama._mlp(x.cpu(), cpu_layer, cfg)
    (g_idx, g_kept), (w_idx, w_kept) = routing(cfg, layer, x), routing(cfg, cpu_layer, x.cpu())
    assert torch.equal(g_idx.cpu(), w_idx)
    if w_kept is not None:
        assert torch.equal(g_kept.cpu(), w_kept) and not bool(w_kept.all())
    assert float((got - want).abs().max()) <= OUT_REL_TOL * float(want.abs().max())


def make(model, params, device, **kw):
    return engine.MiniEngine(engine.EngineConfig(
        model=model, num_pages=96, max_pages_per_seq=24, max_batch=3, max_prefill_tokens=64,
        model_name="small-moe", **kw), params=params, device=device)


@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("scheduler", [{}, {"ragged_attention": True}],
                         ids=["padded", "ragged"])
def test_moe_engine_runs_the_kernels(card, monkeypatch, name, scheduler):
    model = llama.LlamaConfig(**ENGINES[name])
    eng = make(model, llama.init_params(model, seed=0, device=card), card, **scheduler)

    def no_plain(*args, **kwargs):
        raise AssertionError("plain attention ran on the card")

    for mod in (ops, llama):
        for fn in ("paged_attention", "paged_ragged_attention"):
            monkeypatch.setattr(mod, fn, no_plain, raising=False)
    counted = ("cuda_paged_decode_attention", "cuda_paged_prefill_attention",
               "cuda_paged_ragged_attention", "cuda_paged_latent_decode_attention",
               "cuda_paged_latent_prefill_attention")
    before = {fn: getattr(ops, fn).launches for fn in counted}
    dispatches = []
    for attr in ("_prefill_chunk", "_decode_chunk", "_ragged_dispatch"):
        inner = getattr(eng, attr)
        setattr(eng, attr, lambda *a, _inner=inner, _attr=attr: (dispatches.append(_attr),
                                                                _inner(*a))[1])
    reqs = [eng.enqueue(f"r{i}", p, max_new_tokens=6) for i, p in enumerate(PROMPTS)]
    while not all(r.done for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    launched = {fn: getattr(ops, fn).launches - n for fn, n in before.items()}
    assert sum(launched.values()) == model.num_layers * len(dispatches) > 0
    assert all(len(r.output) == 6 and all(0 <= t < 512 for t in r.output) for r in reqs)


@pytest.mark.parametrize("name", ENGINES)
def test_moe_burst_graph_replays_the_eager_burst(card, name):
    model = llama.LlamaConfig(**ENGINES[name])
    params = llama.init_params(model, seed=1, device=card)
    eng = make(model, params, card, decode_burst=8)
    eng.generate("warm", PROMPTS[0], max_new_tokens=9)  # captures the graph
    assert eng._burst_graph is not None
    reqs = [eng.enqueue(f"g{i}", p, max_new_tokens=41) for i, p in enumerate(PROMPTS)]
    while any(r.prefill_pos is not None for r in reqs):
        eng.step()
    last, ctx, tables = eng._decode_batch_arrays(reqs, eng.cfg.max_batch)
    budgets = torch.tensor([r.max_new_tokens - len(r.output) for r in reqs], dtype=torch.int32,
                           device=card)
    budgets[1] = 3  # a row that freezes mid-burst: masked out of the routing after it
    reqs[1].max_new_tokens = len(reqs[1].output) + 3
    pools = [eng.k_cache.clone(), eng.v_cache.clone()]
    eager = llama.forward_decode_steps(
        params, model, torch.from_numpy(last).to(card), *pools, torch.from_numpy(tables).to(card),
        torch.from_numpy(ctx).to(card), budgets, 8)[0].cpu().tolist()
    before = [len(r.output) for r in reqs]
    eng.step()
    assert [r.output[n:] for r, n in zip(reqs, before)] == [
        row[:int(b)] for row, b in zip(eager, budgets.clamp(max=8).tolist())]
    assert torch.equal(eng.k_cache, pools[0]) and torch.equal(eng.v_cache, pools[1])
