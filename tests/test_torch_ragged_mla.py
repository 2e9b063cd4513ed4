"""The ragged kernel's last two arms in the port against the JAX package:
absorbed MLA on the ragged scheduler (``shared_kv``) and the decode-burst
tail.

- The plain ``paged_ragged_attention(shared_kv=True)``, and
  ``cuda_paged_ragged_attention`` on CPU tensors, match the JAX
  ``pallas_paged_ragged_attention(shared_kv=True)`` in interpret mode, for
  both of its ``shared_stream`` values, at ``test_mla_shared_latent``'s
  shapes and a wider latent, over mixes with an empty row, a padded flat
  axis, 1-token and multi-token rows, with and without SWA + sinks; the V
  pool is never read (an MLA engine's has width 0).
- With a decode-burst tail the plain version matches the Pallas kernel's
  tail arm over GQA pools, fp8 (e4m3) pools (tails fp8 too) and the
  shared latent, at ``test_decode_tail_rows``' mixes and windows and a
  window the tail outruns.
- ``forward_ragged`` of ``deepseek_tiny`` matches the JAX
  ``forward_ragged(interpret=True)`` in logits and latent pool; on the
  CPU (``tiny`` and ``deepseek_tiny``) it makes no ragged plan, hands
  none to any layer, and equals its plain-attention run.
- ``MiniEngine(ragged_attention=True)`` on an MLA model gives the port's
  padded MLA engine's streams, ``cached_len``, events (``mla_attention``)
  and block counts, with chunked prefill and prefix reuse; once, the JAX
  ragged MLA engine's.
- The wrapper's contract on the CPU: ``shared_kv`` and tails reach the
  plain version, fp8 with ``shared_kv`` and a tail set missing its
  ``tail_v`` raise, and CUDA-only checks raise before any launch.

Inputs come from numpy with a seed; weights are the JAX tree carried over
by ``params_from_jax``. Attention and models run at fp32, where the
packages differ only in summation order (1e-5 on attention outputs, 1e-4 of
the largest logit on logits); the Pallas kernel compiles once per shape
and static arguments in interpret mode, so every mix of a case shares one
shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.ops.pallas_paged_attention import pallas_paged_ragged_attention
from llmd_kv_cache_tpu_torch.core.hma import SPEC_MLA
from llmd_kv_cache_tpu_torch.events.model import BlockRemovedEvent, BlockStoredEvent
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.ops.cuda_paged_attention import cuda_paged_ragged_attention
from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_ragged_attention

from test_torch_engine import normalize
from test_torch_fp8 import both_fp8, e4m3_bytes

# Attention outputs at fp32: only summation order differs.
ATTN_TOL = 1e-5
# Logits at fp32, relative to the largest logit (as tests/test_torch_model.py).
LOGITS_TOL = 1e-4

PAGE, PAGES_PER_SEQ = 4, 16
ROWS, TOTAL_Q = 6, 48  # every mix of a case has this shape: one compile


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def row_starts_of(q_lens):
    return np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)


def table_for(rng, rows=ROWS):
    num_pages = 1 + rows * PAGES_PER_SEQ
    table = rng.permutation(np.arange(1, num_pages)).reshape(rows, PAGES_PER_SEQ)
    return num_pages, table.astype(np.int32)


# --------------------------------------------------------------------------
# shared_kv: the plain version against the Pallas kernel's shared_kv arm
# --------------------------------------------------------------------------

# name -> (q_lens, ctx_lens): each sums to at most TOTAL_Q, the rest of the
# flat axis is padding.
LATENT_MIXES = {
    # Decode rows beside chunks that straddle the Pallas 8-token blocks and
    # the port's 4-token latent prefill tiles; row 3 is empty.
    "straddle": ([1, 7, 2, 0, 3, 1], [10, 3, 40, 20, 17, 0]),
    "decode": ([1, 1, 1, 1, 1, 1], [0, 4, 9, 30, 47, 60]),
    # A chunk over a cached prefix, with decode rows around it.
    "continuation": ([1, 1, 24, 1, 0, 1], [12, 35, 21, 6, 0, 2]),
}

# (q_heads, latent width): test_mla_shared_latent's, and 16 heads over a
# wider latent as the DeepSeek models have (one m16 tile of heads).
LATENT_SHAPES = [pytest.param(4, 32, id="h4-d32"), pytest.param(16, 64, id="h16-d64")]
WINDOWS = [pytest.param(None, None, id="full"), pytest.param(6, 2, id="swa-sinks")]


def latent_case(mix, heads, width, seed=0):
    rng = np.random.default_rng(seed)
    q_lens, ctx = LATENT_MIXES[mix]
    num_pages, table = table_for(rng)
    latent = rng.normal(size=(num_pages, 1, PAGE, width)).astype(np.float32)
    q = rng.normal(size=(TOTAL_Q, heads, width)).astype(np.float32)
    return q, latent, table, row_starts_of(q_lens), np.array(ctx, np.int32)


@pytest.mark.parametrize("mix", list(LATENT_MIXES))
@pytest.mark.parametrize("heads,width", LATENT_SHAPES)
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("stream", ["copy", "reuse"])
def test_shared_kv_matches_pallas(mix, heads, width, window, sinks, stream):
    q, latent, table, starts, ctx = latent_case(mix, heads, width)
    real = int(starts[-1])
    ref = np.asarray(pallas_paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(latent), jnp.asarray(latent), jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(ctx), sliding_window=window, sinks=sinks,
        shared_kv=True, shared_stream=stream, interpret=True))
    # The MLA engine's V pool: width 0, never read.
    empty_v = torch.zeros(latent.shape[:-1] + (0,))
    args = (t(q), t(latent), empty_v, t(table), t(starts), t(ctx))
    plain = paged_ragged_attention(*args, sliding_window=window, sinks=sinks,
                                   shared_kv=True).numpy()
    wrapped = cuda_paged_ragged_attention(*args, sliding_window=window, sinks=sinks,
                                          shared_kv=True).numpy()
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_allclose(plain[:real], ref[:real], atol=ATTN_TOL, rtol=ATTN_TOL)
    assert not plain[real:].any()  # slots past the last row are zeros


# --------------------------------------------------------------------------
# the decode-burst tail: the plain version against the Pallas tail arm
# --------------------------------------------------------------------------

TAIL_SLOTS = 5
# name -> (q_lens, ctx_lens, tail_lens): test_decode_tail_rows' rows (two
# tail rows beside a prefill row of tail 0) and the burst pods' mix: 1-token
# rows with tails 0, 1, 5 and the full tail, one at ctx 0, an empty row.
TAIL_MIXES = {
    "jax": ([1, 1, 5, 0, 0, 0], [13, 21, 0, 0, 0, 0], [2, 3, 0, 0, 0, 0]),
    "burst": ([1, 1, 1, 9, 0, 1], [0, 17, 30, 11, 5, 44], [5, 1, 0, 0, 0, 5]),
}
# test_decode_tail_rows' windows, and a window of 2 the tail outruns with
# sinks beyond ctx 0's tail slots.
TAIL_WINDOWS = [pytest.param(None, None, id="full"), pytest.param(8, None, id="swa"),
                pytest.param(8, 2, id="swa-sinks"), pytest.param(2, 3, id="swa2-sinks3")]
# (q_heads, kv_heads, width, kv): GQA pools, fp8 (e4m3) GQA pools with an
# fp8 tail, and the shared latent.
TAIL_ARMS = [pytest.param(4, 2, 8, "fp32", id="gqa"), pytest.param(4, 2, 8, "fp8", id="gqa-fp8"),
             pytest.param(16, 1, 32, "shared", id="shared-kv")]


def tail_case(mix, q_heads, kv_heads, width, kv, seed=1):
    """Numpy inputs of both packages: q, pools, table, starts, ctx, the
    tail and its lengths; fp8 pools and tails as e4m3 bytes."""
    rng = np.random.default_rng(seed)
    q_lens, ctx, tails = TAIL_MIXES[mix]
    num_pages, table = table_for(rng)
    pool = (num_pages, kv_heads, PAGE, width)
    tail = (ROWS, TAIL_SLOTS, kv_heads, width)
    k, v, tk, tv = (rng.normal(size=s).astype(np.float32) for s in (pool, pool, tail, tail))
    if kv == "fp8":
        k, v, tk, tv = (e4m3_bytes(a) for a in (k, v, tk, tv))
    q = rng.normal(size=(TOTAL_Q, q_heads, width)).astype(np.float32)
    return (q, k, v, table, row_starts_of(q_lens), np.array(ctx, np.int32), tk, tv,
            np.array(tails, np.int32))


@pytest.mark.parametrize("mix", list(TAIL_MIXES))
@pytest.mark.parametrize("window,sinks", TAIL_WINDOWS)
@pytest.mark.parametrize("q_heads,kv_heads,width,kv", TAIL_ARMS)
def test_tail_matches_pallas(mix, window, sinks, q_heads, kv_heads, width, kv):
    q, k, v, table, starts, ctx, tk, tv, tl = tail_case(mix, q_heads, kv_heads, width, kv)
    shared = kv == "shared"
    if kv == "fp8":
        (jk, tk_), (jv, tv_), (jtk, ttk), (jtv, ttv) = (both_fp8(a) for a in (k, v, tk, tv))
    else:
        jk, jv, jtk, jtv = (jnp.asarray(a) for a in (k, v, tk, tv))
        tk_, tv_, ttk, ttv = (t(a) for a in (k, v, tk, tv))
    jtails = dict(tail_k=jtk, tail_lens=jnp.asarray(tl))
    if not shared:
        jtails["tail_v"] = jtv
    real = int(starts[-1])
    ref = np.asarray(pallas_paged_ragged_attention(
        jnp.asarray(q), jk, jk if shared else jv, jnp.asarray(table), jnp.asarray(starts),
        jnp.asarray(ctx), sliding_window=window, sinks=sinks, shared_kv=shared,
        interpret=True, **jtails))
    tails = dict(tail_k=ttk, tail_v=None if shared else ttv, tail_lens=t(tl))
    args = (t(q), tk_, None if shared else tv_, t(table), t(starts), t(ctx))
    plain = paged_ragged_attention(*args, sliding_window=window, sinks=sinks,
                                   shared_kv=shared, **tails).numpy()
    wrapped = cuda_paged_ragged_attention(*args, sliding_window=window, sinks=sinks,
                                          shared_kv=shared, **tails).numpy()
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_allclose(plain[:real], ref[:real], atol=ATTN_TOL, rtol=ATTN_TOL)
    # The tail moved the tail rows' outputs: without it they differ.
    untailed = paged_ragged_attention(*args, sliding_window=window, sinks=sinks,
                                      shared_kv=shared).numpy()
    tail_rows = [int(starts[r]) for r in range(ROWS) if tl[r] > 0]
    assert not np.allclose(untailed[tail_rows], plain[tail_rows])


# --------------------------------------------------------------------------
# the wrapper's contract on the CPU
# --------------------------------------------------------------------------

def test_ragged_shared_kv_wrapper_contract():
    q, latent, table, starts, ctx = latent_case("straddle", 16, 64)
    args = (t(q), t(latent), None, t(table), t(starts), t(ctx))
    # fp8 with shared_kv is refused on any device, as in JAX.
    with pytest.raises(ValueError, match="fp8"):
        cuda_paged_ragged_attention(t(q), t(latent).to(torch.float8_e4m3fn), None,
                                    *args[3:], shared_kv=True)
    # A tail set without its tail_v is refused unless shared_kv.
    tail = t(np.zeros((ROWS, 2, 1, 64), np.float32))
    lens = torch.ones(ROWS, dtype=torch.int32)
    with pytest.raises(ValueError, match="tail_v"):
        cuda_paged_ragged_attention(*args[:2], t(latent), *args[3:], tail_k=tail,
                                    tail_lens=lens)
    with pytest.raises(ValueError, match="tail_lens"):
        cuda_paged_ragged_attention(*args, shared_kv=True, tail_k=tail)
    # CPU calls run the plain version (shared_kv and tails passed on) and
    # count no launch.
    counters = ("launches", "launches_shared_kv", "launches_tail")
    before = [getattr(cuda_paged_ragged_attention, c) for c in counters]
    got = cuda_paged_ragged_attention(*args, shared_kv=True, tail_k=tail, tail_lens=lens)
    assert torch.equal(got, paged_ragged_attention(*args, shared_kv=True, tail_k=tail,
                                                   tail_lens=lens))
    assert [getattr(cuda_paged_ragged_attention, c) for c in counters] == before
    # Off the CPU the CUDA-only checks come before the device is looked at:
    # an unbuilt latent width or head count, and a tail past the kernels' 64
    # slots.
    meta = dict(device="meta", dtype=torch.bfloat16)
    mt, ms, mc = (x.to("meta") for x in args[3:])
    with pytest.raises(NotImplementedError, match="latent ragged kernel is built for"):
        cuda_paged_ragged_attention(torch.empty(8, 16, 512, **meta),
                                    torch.empty(9, 1, 4, 512, **meta), None, mt, ms, mc,
                                    shared_kv=True)
    with pytest.raises(NotImplementedError, match="latent ragged kernel is built for"):
        cuda_paged_ragged_attention(torch.empty(8, 8, 576, **meta),
                                    torch.empty(9, 1, 4, 576, **meta), None, mt, ms, mc,
                                    shared_kv=True)
    with pytest.raises(NotImplementedError, match="tail of 1..64"):
        cuda_paged_ragged_attention(
            torch.empty(8, 16, 576, **meta), torch.empty(9, 1, 4, 576, **meta), None, mt,
            ms, mc, shared_kv=True, tail_k=torch.empty(ROWS, 65, 1, 576, **meta),
            tail_lens=mc)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_paged_ragged_attention(
            torch.empty(8, 16, 576, **meta), torch.empty(9, 1, 4, 576, **meta), None, mt,
            ms, mc, shared_kv=True, tail_k=torch.empty(ROWS, 64, 1, 576, **meta),
            tail_lens=mc)


# --------------------------------------------------------------------------
# forward_ragged of an MLA model vs the JAX forward_ragged
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds_models():
    """The JAX deepseek_tiny at fp32 and the port's copy of its weights."""
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.deepseek_tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.LlamaConfig.deepseek_tiny(), dtype=torch.float32)
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_forward_ragged_mla_matches_jax(ds_models):
    jcfg, jparams, tcfg, tparams = ds_models
    rng = np.random.default_rng(0)
    num_pages, pages_per_seq, rows = 40, 8, 4
    jk, jv = jax_llama.init_kv_cache(jcfg, num_pages)
    tk, tv = llama.init_kv_cache(tcfg, num_pages, device="cpu")
    assert tk.shape[2:] == (1, tcfg.page_size, 24) and tv.shape[-1] == 0  # the latent pool
    table = rng.permutation(np.arange(1, num_pages))[:rows * pages_per_seq]
    table = table.reshape(rows, pages_per_seq).astype(np.int32)

    def step(q_lens, ctx, pad):
        nonlocal jk, jv
        starts = row_starts_of(q_lens)
        toks = rng.integers(0, jcfg.vocab_size, size=(1, int(starts[-1]) + pad))
        toks = toks.astype(np.int32)
        ctx = np.array(ctx, np.int32)
        jlog, jk, jv = jax_llama.forward_ragged(
            jparams, jcfg, jnp.asarray(toks), jk, jv, jnp.asarray(table),
            jnp.asarray(starts), jnp.asarray(ctx), interpret=True)
        tlog, tk2, _ = llama.forward_ragged(
            tparams, tcfg, t(toks), tk, tv, t(table), t(starts), t(ctx))
        assert tk2 is tk  # the latent pool is updated in place
        jlog = np.asarray(jlog)
        live = np.array(q_lens) > 0  # an empty row's logits are ignored
        scale = float(np.abs(jlog[live]).max())
        np.testing.assert_allclose(tlog.numpy()[live], jlog[live], rtol=0,
                                   atol=LOGITS_TOL * scale)
        np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],  # page 0 excepted
                                   atol=ATTN_TOL, rtol=ATTN_TOL)

    # Cold prefill chunks of three rows (row 2 empty), padded flat axis;
    # then decode rows beside a continuation chunk.
    step([10, 6, 0, 3], [0, 0, 0, 0], pad=5)
    step([1, 5, 0, 1], [10, 6, 0, 3], pad=1)


@pytest.mark.parametrize("model", ["tiny", "deepseek_tiny"])
def test_forward_ragged_on_the_cpu_makes_no_plan(monkeypatch, model):
    """On the CPU ``forward_ragged`` plans nothing (the plan is the card's:
    it queries the kernel library, which the CPU does not load) and hands
    every layer's ragged call ``plan=None``; its logits and pools equal
    those of its ``plain_attention`` run."""
    cfg = dataclasses.replace(getattr(llama.LlamaConfig, model)(), dtype=torch.float32)
    params = llama.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    num_pages, pages_per_seq = 40, 8
    table = rng.permutation(np.arange(1, num_pages))[:4 * pages_per_seq]
    table = t(table.reshape(4, pages_per_seq).astype(np.int32))
    q_lens, ctx = [1, 7, 0, 1], [5, 3, 0, 11]
    starts = t(row_starts_of(q_lens))
    toks = t(rng.integers(0, cfg.vocab_size, size=(1, sum(q_lens) + 2)).astype(np.int64))
    ctx = t(np.array(ctx, np.int32))
    plans = []

    def recording(*args, plan=None, **kwargs):
        plans.append(plan)
        return cuda_paged_ragged_attention(*args, plan=plan, **kwargs)

    def no_plan(*args, **kwargs):
        raise AssertionError("forward_ragged planned on the CPU")

    monkeypatch.setattr(llama, "cuda_paged_ragged_attention", recording)
    monkeypatch.setattr(llama, "plan_ragged_attention", no_plan)
    outs = []
    for plain in (False, True):
        k, v = llama.init_kv_cache(cfg, num_pages, device="cpu")
        outs.append(llama.forward_ragged(params, cfg, toks, k, v, table, starts, ctx,
                                         plain_attention=plain))
    assert plans == [None] * cfg.num_layers
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the ragged MLA engine
# --------------------------------------------------------------------------

def prompts(seed, lengths, prefix_len=13):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 256, prefix_len).tolist()
    return [prefix + rng.integers(1, 256, n).tolist() for n in lengths]


class Engines:
    """The port's padded and ragged engines on one MLA model's weights
    (fp32: bf16 argmax near-ties flip between differently shaped calls)."""

    def __init__(self, params, **cfg_kw):
        tcfg = dataclasses.replace(llama.LlamaConfig.deepseek_tiny(), dtype=torch.float32)
        base = dict(model=tcfg, max_pages_per_seq=16, model_name="ds", pod_identifier="pod-m")
        base.update(cfg_kw)
        self.events = {False: [], True: []}
        self.eng = {
            ragged: engine.MiniEngine(
                engine.EngineConfig(**base, ragged_attention=ragged),
                event_sink=self.events[ragged].extend, params=params, device="cpu")
            for ragged in (False, True)}
        self.dispatches = 0
        inner = self.eng[True]._ragged_dispatch

        def counted(*args, **kwargs):
            self.dispatches += 1
            return inner(*args, **kwargs)
        self.eng[True]._ragged_dispatch = counted

    def enqueue(self, *args, **kwargs):
        return self.eng[False].enqueue(*args, **kwargs), self.eng[True].enqueue(*args, **kwargs)

    def run(self, reqs, max_steps=200):
        for _ in range(max_steps):
            assert self.eng[True].step() == self.eng[False].step()
            if all(p.done for p, _ in reqs):
                break
        for p, r in reqs:
            assert p.done and r.done
            assert (r.output, r.cached_len, r.block_hashes) == \
                (p.output, p.cached_len, p.block_hashes)

    def assert_same_state(self):
        assert normalize(self.events[True]) == normalize(self.events[False])
        stored = [e for e in self.events[True] if isinstance(e, BlockStoredEvent)]
        assert stored and all(e.kv_cache_spec_kind == SPEC_MLA for e in stored)
        padded, ragged = self.eng[False].block_manager, self.eng[True].block_manager
        assert ragged.num_free() == padded.num_free()
        assert ragged.num_cached_blocks() == padded.num_cached_blocks()


def test_ragged_mla_engine_matches_padded(ds_models):
    """Chunked prefill riding beside decode rows in two dispatches a step
    (max_batch below the running requests), prefix reuse, and eviction in
    a pool too small for every prompt."""
    pair = Engines(ds_models[3], num_pages=96, max_batch=2, max_prefill_tokens=8)
    ps = prompts(1, (7, 3, 12, 0, 20, 5))
    reqs = [pair.enqueue(f"r{i}", p, max_new_tokens=4 + i) for i, p in enumerate(ps[:-1])]
    pair.run(reqs)
    reuse = pair.enqueue("reuse", ps[-1], max_new_tokens=3)
    assert reuse[1].cached_len == 12  # the shared prefix's 3 full blocks
    pair.run([reuse])
    pair.assert_same_state()
    assert pair.dispatches > 0 and pair.eng[True].cfg.ragged_attention

    small = Engines(ds_models[3], num_pages=10, max_prefill_tokens=8)
    for i, p in enumerate(prompts(3, (12, 12, 12), prefix_len=0)):
        small.run([small.enqueue(f"s{i}", p, max_new_tokens=2)])
    assert any(isinstance(e, BlockRemovedEvent) for e in small.events[True])
    small.assert_same_state()


def test_ragged_mla_engine_matches_jax(ds_models):
    """Once against the JAX ragged MLA engine (its Pallas ragged kernel in
    interpret mode): tokens, cached_len, block hashes and events."""
    jcfg, jparams, tcfg, tparams = ds_models
    base = dict(num_pages=64, max_pages_per_seq=16, max_batch=3, max_prefill_tokens=8,
                model_name="ds", pod_identifier="pod-m", ragged_attention=True)
    jax_events, port_events = [], []
    jeng = jax_engine.MiniEngine(jax_engine.EngineConfig(model=jcfg, **base),
                                 event_sink=jax_events.extend, params=jparams)
    assert jeng._ragged  # the ragged path engaged, not the padded fallback
    teng = engine.MiniEngine(engine.EngineConfig(model=tcfg, **base),
                             event_sink=port_events.extend, params=tparams, device="cpu")
    warm, *ps = prompts(5, (2, 11, 3, 6))
    reqs = []
    for i, p in enumerate(([warm], ps)):  # the prefix first, then three over it
        reqs = [(jeng.enqueue(f"r{i}.{j}", q, max_new_tokens=4),
                 teng.enqueue(f"r{i}.{j}", q, max_new_tokens=4)) for j, q in enumerate(p)]
        for _ in range(40):
            assert teng.step() == jeng.step()
            if all(jr.done for jr, _ in reqs):
                break
        for jr, tr in reqs:
            assert jr.done and tr.done
            assert (tr.output, tr.cached_len, tr.block_hashes) == \
                (jr.output, jr.cached_len, jr.block_hashes)
    assert all(tr.cached_len == 12 for _, tr in reqs)  # the prefix's 3 full blocks
    assert normalize(port_events) == normalize(jax_events)
