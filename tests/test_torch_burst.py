"""The port's fused decode bursts against the JAX package.

- The plain ``paged_attention`` with a decode-burst KV tail (what the decode
  wrappers run for CPU tensors) matches the JAX ``paged_attention`` with the
  same tail and the Pallas decode kernels' tail fold (``_tail_fold``, both
  grids: ``merge_heads`` True and False) in interpret mode, at fp32 within
  2e-5 (only fp32 summation order differs): GQA with and without SWA +
  sinks, the sink-torture case (tail slots at sink positions once the burst
  outruns the window) and ``shared_kv`` (the latent tail is K and V), as
  ``tests/test_pallas_attention.py`` holds the kernels to them.
- Both decode wrappers take the tail arguments as a set and run the plain
  version for CPU tensors, counting no launch.
- ``forward_decode_steps`` gives the JAX ``forward_decode_steps(use_pallas=
  False)``'s tokens and leaves the same valid pages, for the tiny GQA and
  MLA configs, with budgets 0, 1, 3 and past the burst.
- The port's burst engine gives the JAX burst engine's tokens, ``cached_len``
  and events, and its own single-step engine's tokens (the JAX
  ``TestDecodeBurst`` and the MLA burst case of ``tests/test_mla.py``); a
  ragged engine with bursts is refused.

Inputs come from numpy with a seed; weights are the JAX tree carried over by
``params_from_jax``; everything runs at fp32 (bf16 argmax near-ties flip
between differently compiled programs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from llmd_kv_cache_tpu.ops.pallas_paged_attention import pallas_paged_decode_attention
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.ops.cuda_paged_attention import (
    cuda_paged_decode_attention,
    cuda_paged_latent_decode_attention,
)
from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

from test_torch_attention import t
from test_torch_engine import normalize

# Attention at fp32 (the tolerance of the JAX tail tests).
TAIL_TOL = 2e-5
# Cache contents at fp32 after a burst: the same K/V projections, in
# another summation order.
CACHE_TOL = 1e-5

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=128, page_size=4)
DS_TINY = dict(TINY, num_kv_heads=4, kv_lora_rank=16, qk_rope_head_dim=8)


# --------------------------------------------------------------------------
# attention with a tail: the plain version vs JAX and the Pallas tail fold
# --------------------------------------------------------------------------

def tail_case(q_heads, kv_heads, ctx, tail_lens, slots, seed, head_dim=8, page_size=4):
    """Two decode rows over random pools (page 0 too), 4 pages a row, and a
    random dense tail of ``slots`` slots; ``ctx`` paged keys a row."""
    rng = np.random.default_rng(seed)
    batch, pages_per_seq = len(ctx), 4
    num_pages = 1 + batch * pages_per_seq
    shape = (num_pages, kv_heads, page_size, head_dim)
    k, v = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    table = (1 + np.arange(batch * pages_per_seq)).reshape(batch, pages_per_seq).astype(np.int32)
    q = rng.normal(size=(batch, q_heads, head_dim)).astype(np.float32)
    tail = (batch, slots, kv_heads, head_dim)
    tk, tv = rng.normal(size=tail).astype(np.float32), rng.normal(size=tail).astype(np.float32)
    return (q, k, v, table, np.array(ctx, np.int32), tk, tv, np.array(tail_lens, np.int32))


TAIL_CASES = [
    # (q_heads, kv_heads, ctx, tail_lens, slots, window, sinks, seed)
    pytest.param(8, 2, [10, 7], [5, 1], 6, None, None, 3, id="gqa"),
    pytest.param(8, 2, [10, 7], [5, 1], 6, 12, None, 3, id="gqa-swa"),
    pytest.param(8, 2, [10, 7], [5, 1], 6, 12, 4, 3, id="gqa-swa-sinks"),
    # The burst outran window 3 with ctx below the 4 sinks: tail slots sit
    # at sink positions and stay attendable.
    pytest.param(8, 2, [2, 1], [8, 6], 8, 3, 4, 6, id="sink-torture"),
]


@pytest.mark.parametrize("q_heads,kv_heads,ctx,tail_lens,slots,window,sinks,seed",
                         TAIL_CASES)
def test_plain_tail_matches_jax_and_pallas(q_heads, kv_heads, ctx, tail_lens, slots,
                                           window, sinks, seed):
    q, k, v, table, ctx, tk, tv, tl = tail_case(q_heads, kv_heads, ctx, tail_lens, slots,
                                                seed)
    q_pos = (ctx + tl - 1)[:, None]
    got = paged_attention(t(q)[:, None], t(k), t(v), t(table), t(q_pos), t(ctx),
                          sliding_window=window, attention_sinks=sinks, tail_k=t(tk),
                          tail_v=t(tv), tail_lens=t(tl))[:, 0].numpy()
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(q_pos), jnp.asarray(ctx), sliding_window=window,
        attention_sinks=sinks, tail_k=jnp.asarray(tk), tail_v=jnp.asarray(tv),
        tail_lens=jnp.asarray(tl)))[:, 0]
    np.testing.assert_allclose(got, ref, atol=TAIL_TOL, rtol=TAIL_TOL)
    # The wrapper's CPU path is the same plain version.
    wrapped = cuda_paged_decode_attention(
        t(q), t(k), t(v), t(table), t(ctx), sliding_window=window, sinks=sinks,
        tail_k=t(tk), tail_v=t(tv), tail_lens=t(tl)).numpy()
    np.testing.assert_array_equal(wrapped, got)
    for merge_heads in (False, True):
        pallas = np.asarray(pallas_paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
            jnp.asarray(ctx), sliding_window=window, sinks=sinks, merge_heads=merge_heads,
            tail_k=jnp.asarray(tk), tail_v=jnp.asarray(tv), tail_lens=jnp.asarray(tl),
            interpret=True))
        np.testing.assert_allclose(got, pallas, atol=TAIL_TOL, rtol=TAIL_TOL)


def test_plain_shared_kv_tail_matches_pallas():
    """Absorbed MLA: one latent head is K and V, and so is its tail."""
    q, k, _, table, ctx, tk, _, tl = tail_case(8, 1, [12, 9], [3, 1], 4, seed=4)
    got = cuda_paged_decode_attention(t(q), t(k), t(k[..., :0]), t(table), t(ctx),
                                      shared_kv=True, tail_k=t(tk), tail_lens=t(tl)).numpy()
    q_pos = jnp.asarray(ctx + tl - 1)[:, None]
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(k), jnp.asarray(table), q_pos,
        jnp.asarray(ctx), tail_k=jnp.asarray(tk), tail_v=jnp.asarray(tk),
        tail_lens=jnp.asarray(tl)))[:, 0]
    np.testing.assert_allclose(got, ref, atol=TAIL_TOL, rtol=TAIL_TOL)
    for merge_heads in (False, True):
        pallas = np.asarray(pallas_paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(table),
            jnp.asarray(ctx), shared_kv=True, merge_heads=merge_heads,
            tail_k=jnp.asarray(tk), tail_lens=jnp.asarray(tl), interpret=True))
        np.testing.assert_allclose(got, pallas, atol=TAIL_TOL, rtol=TAIL_TOL)


# --------------------------------------------------------------------------
# the wrappers' tail arguments
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wrapper", [cuda_paged_decode_attention,
                                     cuda_paged_latent_decode_attention])
def test_tail_arguments_travel_as_a_set(wrapper):
    kv_heads = 2 if wrapper is cuda_paged_decode_attention else 1
    q, k, v, table, ctx, tk, tv, tl = (t(a) for a in tail_case(8, kv_heads, [5, 3],
                                                                [2, 1], 4, seed=0))
    with pytest.raises(ValueError, match="tail_lens"):
        wrapper(q, k, v, table, ctx, tail_k=tk, tail_v=tv)
    with pytest.raises(ValueError, match="tail_v"):
        wrapper(q, k, v, table, ctx, tail_k=tk, tail_lens=tl)
    with pytest.raises(ValueError, match="without tail_k"):
        wrapper(q, k, v, table, ctx, tail_v=tv, tail_lens=tl)
    # shared_kv: the latent tail is also V, and tail_v is not needed.
    before = (cuda_paged_decode_attention.launches,
              cuda_paged_latent_decode_attention.launches)
    shared = wrapper(q, k, k, table, ctx, shared_kv=True, tail_k=tk, tail_lens=tl)
    assert torch.equal(shared, wrapper(q, k, k, table, ctx, tail_k=tk, tail_v=tk,
                                       tail_lens=tl))
    assert (cuda_paged_decode_attention.launches,
            cuda_paged_latent_decode_attention.launches) == before  # CPU: no launch


def test_tail_longer_than_a_kernel_chunk_raises_off_the_cpu():
    """The kernels fold a tail of at most 64 slots; the plain version takes
    any on the CPU, and a longer tail elsewhere is refused before the device
    is looked at."""
    meta = dict(device="meta")
    q = torch.empty(2, 8, 128, dtype=torch.bfloat16, **meta)
    k = torch.empty(9, 2, 16, 128, dtype=torch.bfloat16, **meta)
    table = torch.empty(2, 3, dtype=torch.int32, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    tail = torch.empty(2, 65, 2, 128, dtype=torch.bfloat16, **meta)
    with pytest.raises(NotImplementedError, match="tail of 1..64"):
        cuda_paged_decode_attention(q, k, k, table, lens, tail_k=tail, tail_v=tail,
                                    tail_lens=lens)
    latent = torch.empty(9, 1, 16, 576, dtype=torch.bfloat16, **meta)
    with pytest.raises(NotImplementedError, match="tail of 1..64"):
        cuda_paged_decode_attention(
            torch.empty(2, 16, 576, dtype=torch.bfloat16, **meta), latent, None, table,
            lens, shared_kv=True, tail_k=torch.empty(2, 65, 1, 576, **meta),
            tail_lens=lens)
    q, k, v, table, ctx, tk, tv, tl = (t(a) for a in tail_case(8, 2, [5, 3], [70, 1], 70,
                                                                seed=1))
    assert torch.isfinite(cuda_paged_decode_attention(
        q, k, v, table, ctx, tail_k=tk, tail_v=tv, tail_lens=tl)).all()


# --------------------------------------------------------------------------
# forward_decode_steps
# --------------------------------------------------------------------------

def pair_of_configs(kw):
    return (jax_llama.LlamaConfig(**kw, dtype=jnp.float32),
            llama.LlamaConfig(**kw, dtype=torch.float32))


@pytest.mark.parametrize("kw", [pytest.param(TINY, id="gqa-tiny"),
                                pytest.param(DS_TINY, id="deepseek-tiny")])
def test_forward_decode_steps_matches_jax(kw):
    jcfg, tcfg = pair_of_configs(kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(0),
                                                                    jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = llama.params_from_jax(tree, tcfg, device="cpu")
    page, batch, pages_per_seq, steps = jcfg.page_size, 4, 6, 4
    num_pages = 1 + batch * pages_per_seq
    table = np.arange(1, num_pages, dtype=np.int32).reshape(batch, pages_per_seq)
    rng = np.random.default_rng(0)
    # Prefill contexts of 9, 4, 13 and 6 tokens through both packages.
    ctx = np.array([9, 4, 13, 6], np.int32)
    prompt = rng.integers(0, 256, (batch, int(ctx.max()))).astype(np.int32)
    jk, jv = jax_llama.init_kv_cache(jcfg, num_pages)
    tk, tv = llama.init_kv_cache(tcfg, num_pages, device="cpu")
    zeros = np.zeros(batch, np.int32)
    _, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(prompt), jk, jv,
                                  jnp.asarray(table), jnp.asarray(zeros), jnp.asarray(ctx))
    llama.forward(tparams, tcfg, t(prompt), tk, tv, t(table), t(zeros), t(ctx))
    last = rng.integers(0, 256, batch).astype(np.int32)
    active = np.array([0, 1, 3, 6], np.int32)  # padding, one tick, three, past the burst
    jtoks, jk, jv = jax_llama.forward_decode_steps(
        jparams, jcfg, jnp.asarray(last), jk, jv, jnp.asarray(table), jnp.asarray(ctx),
        jnp.asarray(active), steps=steps)
    ttoks, tk2, tv2 = llama.forward_decode_steps(
        tparams, tcfg, t(last).long(), tk, tv, t(table), t(ctx), t(active), steps)
    assert tk2 is tk and tv2 is tv  # the pools are updated in place
    jtoks, ttoks = np.asarray(jtoks), ttoks.numpy()
    assert ttoks.shape == (batch, steps)
    for i, n in enumerate(np.minimum(active, steps)):
        assert ttoks[i, :n].tolist() == jtoks[i, :n].tolist()
    # Every page outside the garbage page holds the same K/V (the burst's
    # tokens included); frozen rows wrote nothing.
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               atol=CACHE_TOL, rtol=CACHE_TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               atol=CACHE_TOL, rtol=CACHE_TOL)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class Pair:
    """A JAX engine and a port engine with the same weights and config."""

    def __init__(self, kw=TINY, **cfg_kw):
        jcfg, tcfg = pair_of_configs(kw)
        base = dict(num_pages=64, max_pages_per_seq=16, model_name="tiny",
                    pod_identifier="p")
        base.update(cfg_kw)
        self.jax_events, self.events = [], []
        self.jax = jax_engine.MiniEngine(jax_engine.EngineConfig(model=jcfg, **base),
                                         event_sink=self.jax_events.extend, seed=0)
        self.params = llama.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jax.params), tcfg, device="cpu")
        self.tcfg, self.base = tcfg, base
        self.port = self.port_engine(event_sink=self.events.extend)

    def port_engine(self, event_sink=None, **overrides):
        return engine.MiniEngine(engine.EngineConfig(model=self.tcfg,
                                                     **{**self.base, **overrides}),
                                 event_sink=event_sink, params=self.params, device="cpu")


def test_burst_engine_matches_jax_and_single_step():
    """The JAX ``test_burst_matches_single_step``, and the port's burst
    engine against the JAX one: tokens, ``cached_len`` and events."""
    pair = Pair(decode_burst=4)
    prompt = list(range(30, 42))
    jr = pair.jax.generate("r", prompt, max_new_tokens=7)
    tr = pair.port.generate("r", prompt, max_new_tokens=7)
    assert tr == jr
    assert pair.port_engine(decode_burst=1).generate("r", prompt, max_new_tokens=7) == tr
    again = [pair.jax.add_request("r2", prompt, max_new_tokens=1),
             pair.port.add_request("r2", prompt, max_new_tokens=1)]
    assert again[1].cached_len == again[0].cached_len > 0
    assert normalize(pair.events) == normalize(pair.jax_events)


def test_burst_exceeding_remaining_is_clamped():
    # max_new 3: a burst of 8 takes the 2 tokens left, never more.
    pair = Pair(decode_burst=8)
    prompt = list(range(30, 42))
    out = pair.port.generate("r", prompt, max_new_tokens=3)
    assert len(out) == 3
    assert out == pair.jax.generate("r", prompt, max_new_tokens=3)
    assert out == pair.port_engine(decode_burst=1).generate("r", prompt, max_new_tokens=3)


def test_burst_mixed_batch_and_continuous_batching():
    """Two requests with different budgets in one burst (the JAX
    ``test_burst_mixed_batch``), then continuous batching with chunked
    prefill between bursts, step by step against the JAX engine."""
    pair = Pair(decode_burst=4, max_batch=3, max_prefill_tokens=8, num_pages=96)

    def run(eng):
        a = eng.add_request("a", list(range(10, 22)), max_new_tokens=5)
        b = eng.add_request("b", list(range(50, 66)), max_new_tokens=3)
        while not (a.done and b.done):
            eng.step()
        return a.output, b.output

    assert run(pair.port) == run(pair.jax) == run(pair.port_engine(decode_burst=1))
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 256, 13).tolist()
    prompts = [prefix + rng.integers(1, 256, n).tolist() for n in (7, 3, 12, 0)]
    reqs = [(pair.jax.enqueue(f"r{i}", p, max_new_tokens=4 + 3 * i),
             pair.port.enqueue(f"r{i}", p, max_new_tokens=4 + 3 * i))
            for i, p in enumerate(prompts)]
    for _ in range(60):
        assert pair.port.step() == pair.jax.step()
        if all(jr.done for jr, _ in reqs):
            break
    for jr, tr in reqs:
        assert tr.done and jr.done
        assert (tr.output, tr.cached_len, tr.computed_len) == \
            (jr.output, jr.cached_len, jr.computed_len)
    assert normalize(pair.events) == normalize(pair.jax_events)


def test_burst_not_clamped_by_near_done_request():
    """Per-row budgets: a request about to finish does not cut the chunk's
    burst to its remainder (the JAX test of the same name)."""
    eng = Pair(decode_burst=8).port
    a = eng.add_request("a", list(range(10, 22)), max_new_tokens=9)
    b = eng.add_request("b", list(range(50, 66)), max_new_tokens=2)
    assert len(a.output) == 1 and len(b.output) == 1  # each prefill's token
    eng.step()
    assert b.done  # took its single remaining token, then froze
    assert len(a.output) == 9  # the full 8-token burst
    assert a.computed_len == 12 + 8


def test_mla_burst_matches_jax_and_single_step():
    """The JAX ``test_burst_token_identical`` (tests/test_mla.py), against
    the JAX burst engine too; the latent tail is K and V."""
    pair = Pair(DS_TINY, decode_burst=8, max_batch=4)
    prompt = list(range(30, 49))
    tr = pair.port.generate("r", prompt, max_new_tokens=12)
    assert tr == pair.jax.generate("r", prompt, max_new_tokens=12)
    assert tr == pair.port_engine(decode_burst=1).generate("r", prompt, max_new_tokens=12)
    assert normalize(pair.events) == normalize(pair.jax_events)


def test_burst_size_is_the_power_of_two_floor():
    _, tcfg = pair_of_configs(TINY)
    for burst, want in ((1, 1), (3, 2), (8, 8), (12, 8)):
        eng = engine.MiniEngine(engine.EngineConfig(model=tcfg, decode_burst=burst),
                                device="cpu")
        assert eng._burst == want


def test_ragged_attention_with_bursts_raises_at_construction():
    _, tcfg = pair_of_configs(TINY)
    with pytest.raises(ValueError, match="ragged_attention.*decode_burst"):
        engine.MiniEngine(engine.EngineConfig(model=tcfg, ragged_attention=True,
                                              decode_burst=4), device="cpu")
    # A burst of 1 is single-step decoding, which the ragged path serves.
    engine.MiniEngine(engine.EngineConfig(model=tcfg, ragged_attention=True,
                                          decode_burst=1), device="cpu")


def test_tails_mode_takes_one_token_a_row():
    """A burst tick writes one tail slot a live row; a longer step would
    mis-mask, so it is refused (the JAX ``_forward_impl_grouped`` check)."""
    _, tcfg = pair_of_configs(TINY)
    params = llama.init_params(tcfg, device="cpu")
    k, v = llama.init_kv_cache(tcfg, 9, device="cpu")
    tail = k.new_zeros((tcfg.num_layers, 2, 4) + k.shape[2:3] + k.shape[4:])
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="seq == 1"):
        llama._forward_impl(params, tcfg, torch.zeros(2, 2, dtype=torch.long), k, v,
                            torch.ones(2, 4, dtype=torch.int32), lens, lens + 2,
                            llama._plain_attention, False, tails=(tail, tail.clone(), lens))
