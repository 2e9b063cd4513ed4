"""fp8 (e4m3) KV pools of the port against the JAX package.

Same numpy inputs from a seed go through both packages:

- the cast into a pool (``to_kv_dtype``) gives the bytes of JAX's
  ``astype(jnp.float8_e4m3fn)`` for all 65,536 bf16 patterns and a seeded
  fp32 sweep with every e4m3 midpoint and its neighbours one ulp away, NaN
  (and its sign) included where a value leaves e4m3's range; a scatter into
  an fp8 pool is bit-equal to JAX's;
- the plain attention over fp8 pools (the wrappers' CPU path): decode with
  and without a burst tail, prefill and the ragged mix against JAX's
  ``paged_attention`` and the Pallas kernels' quantized arms in interpret
  mode (decode, ragged), at fp32 within 1e-5 and at bf16 within 2e-2;
- the fp8 engines, padded, ragged and with bursts of 8, on the weights of
  the JAX engine (``params_from_jax``, fp32 models): the same tokens,
  ``cached_len``, events and pool bytes; a burst engine's tokens equal a
  single-step engine's;
- fp8 against bf16 logits within JAX's own bound (``tests/test_kv_fp8.py``);
- the refusals JAX makes: MLA with fp8, an unknown dtype string, an offload
  spec of another dtype, and fp8 on a single-KV-head kernel off the CPU;
- an fp8 store written by either package's engine restores bit-exactly into
  the other's, under the same fingerprint directory.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.offload import spec as jax_spec
from llmd_kv_cache_tpu.ops import kv_pages as jax_kv_pages
from llmd_kv_cache_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from llmd_kv_cache_tpu.ops.pallas_paged_attention import (
    pallas_paged_decode_attention,
    pallas_paged_ragged_attention,
)
from llmd_kv_cache_tpu_torch.core.keys import EMPTY_BLOCK_HASH
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload import spec
from llmd_kv_cache_tpu_torch.ops import kv_pages
from llmd_kv_cache_tpu_torch.ops.cuda_paged_attention import (
    cuda_paged_decode_attention,
    cuda_paged_prefill_attention,
    cuda_paged_ragged_attention,
)
from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

from test_torch_engine import normalize
from test_torch_offload import spec_kw

FP8 = torch.float8_e4m3fn
# Attention over the same fp8 bytes: at fp32 the packages differ only in
# summation order; at bf16 also in where they round (as
# tests/test_torch_attention.py holds the bf16 pools).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)
DS_TINY = dict(TINY, num_kv_heads=4, kv_lora_rank=16, qk_rope_head_dim=8)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def e4m3_bytes(a: np.ndarray) -> np.ndarray:
    """The JAX cast of ``a`` to e4m3, as its bytes."""
    return np.asarray(jnp.asarray(a).astype(jnp.float8_e4m3fn)).view(np.uint8)


def port_bytes(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.uint8).numpy()


def both_fp8(u8: np.ndarray):
    """The same e4m3 bytes as a JAX array and a torch tensor."""
    return (jnp.asarray(u8.view(ml_dtypes.float8_e4m3fn)),
            torch.from_numpy(u8.copy()).view(FP8))


# --------------------------------------------------------------------------
# the cast
# --------------------------------------------------------------------------

def test_cast_every_bf16_pattern():
    words = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    got = port_bytes(kv_pages.to_kv_dtype(t(words.view(np.int16)).view(torch.bfloat16), FP8))
    want = e4m3_bytes(words.view(jnp.bfloat16))
    np.testing.assert_array_equal(got, want)
    # Past e4m3's range (|x| > 464) and at +-inf JAX writes NaN with the
    # input's sign, where Tensor.to saturates to +-448.
    vals = torch.tensor([466.0, -466.0, float("inf"), float("-inf"), 464.0, -464.0,
                         float("nan")], dtype=torch.bfloat16)
    assert port_bytes(kv_pages.to_kv_dtype(vals, FP8)).tolist() == [
        0x7F, 0xFF, 0x7F, 0xFF, 0x7E, 0xFE, 0x7F]


def test_cast_fp32_sweep_and_midpoints():
    finite = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    finite = np.unique(finite[np.isfinite(finite)])
    mids = ((finite[1:] + finite[:-1]) / 2).astype(np.float32)  # exact in fp32
    mids = np.concatenate([mids, np.float32([464.0, -464.0, 480.0, -480.0])])
    rng = np.random.default_rng(0)
    scaled = (rng.normal(size=100_000) * 10.0 ** rng.uniform(-5, 3, 100_000)).astype(np.float32)
    sweep = np.concatenate([
        mids, np.nextafter(mids, np.float32(np.inf)), np.nextafter(mids, np.float32(-np.inf)),
        finite, scaled,
        np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 3e38, -3e38])])
    got = port_bytes(kv_pages.to_kv_dtype(t(sweep), FP8))
    np.testing.assert_array_equal(got, e4m3_bytes(sweep))


def test_cast_is_the_identity_elsewhere():
    x = torch.randn(64, dtype=torch.float32)
    assert torch.equal(kv_pages.to_kv_dtype(x, torch.bfloat16), x.to(torch.bfloat16))
    y = x.to(torch.bfloat16)
    assert kv_pages.to_kv_dtype(y, torch.bfloat16) is y
    z = kv_pages.to_kv_dtype(y, FP8)
    assert kv_pages.to_kv_dtype(z, FP8) is z
    # The upcast back is exact: every e4m3 value is a bf16 value.
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(FP8)
    up = every.to(torch.bfloat16)
    finite = torch.isfinite(up)
    np.testing.assert_array_equal(port_bytes(kv_pages.to_kv_dtype(up[finite], FP8)),
                                  port_bytes(every[finite]))


@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cast_is_tensor_to_but_nan_past_range(src):
    """The cast is ``Tensor.to`` wherever |x| <= 464 or x is NaN, and NaN
    with x's sign past that, on a strided (non-contiguous) input too."""
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(48, 40, generator=gen) * 10.0 ** (torch.rand(48, 40, generator=gen) * 5 - 2))
    x[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -float("nan")])
    x = x.to(src).t()  # strided
    got = kv_pages.to_kv_dtype(x, FP8).view(torch.uint8)
    plain = x.contiguous().to(FP8).view(torch.uint8)
    past = x.float().abs() > 464
    assert past.any() and (~past).any()
    assert torch.equal(got[~past], plain[~past])
    sign = (x.float()[past] < 0).to(torch.uint8) << 7
    assert torch.equal(got[past], sign | 0x7F)
    np.testing.assert_array_equal(port_bytes(got), e4m3_bytes(x.float().numpy().astype(
        np.float32 if src == torch.float32 else jnp.bfloat16)))


@pytest.mark.parametrize("src", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_scatter_into_fp8_pool_bit_equal(src):
    rng = np.random.default_rng(1)
    kv_heads, head_dim, page, batch, seq = 2, 8, 4, 3, 11
    num_pages = 1 + batch * 4
    cache = np.zeros((num_pages, kv_heads, page, head_dim), np.uint8)
    table = np.arange(1, num_pages, dtype=np.int32).reshape(batch, 4)
    ctx = np.array([0, 3, 5], np.int32)
    positions = (ctx[:, None] + np.arange(seq)[None]).astype(np.int32)
    valid = np.arange(seq)[None] < np.array([[seq], [seq - 4], [1]])
    # Values well past e4m3's range too: those become NaN in both.
    new_kv = (rng.normal(size=(batch, seq, kv_heads, head_dim)) * 300).astype(src)
    jc, tc = both_fp8(cache)
    ref = jax_kv_pages.scatter_kv_pages(jc, jnp.asarray(new_kv), jnp.asarray(table),
                                        jnp.asarray(positions), jnp.asarray(valid))
    src_t = (t(new_kv) if src is np.float32
             else t(np.asarray(new_kv).view(np.int16)).view(torch.bfloat16))
    kv_pages.scatter_kv_pages(tc, src_t, t(table), t(positions), t(valid))
    ref_bytes = np.asarray(ref).view(np.uint8)
    np.testing.assert_array_equal(port_bytes(tc)[1:], ref_bytes[1:])
    assert (ref_bytes[1:] & 0x7F == 0x7F).any()  # the NaN rule was exercised


# --------------------------------------------------------------------------
# the plain attention over fp8 pools
# --------------------------------------------------------------------------

def fp8_pools(rng, num_pages, kv_heads, page_size, head_dim):
    """K and V e4m3 bytes of random values (page 0 too)."""
    shape = (num_pages, kv_heads, page_size, head_dim)
    return (e4m3_bytes(rng.normal(size=shape).astype(np.float32)),
            e4m3_bytes(rng.normal(size=shape).astype(np.float32)))


def decode_case(seed, q_heads=8, kv_heads=2, head_dim=8, page=4):
    rng = np.random.default_rng(seed)
    ctx = np.array([10, 7, 1, 14], np.int32)
    batch, pages_per_seq = len(ctx), 4
    num_pages = 1 + batch * pages_per_seq
    k, v = fp8_pools(rng, num_pages, kv_heads, page, head_dim)
    table = (1 + np.arange(batch * pages_per_seq)).reshape(batch, pages_per_seq)
    q = rng.normal(size=(batch, q_heads, head_dim)).astype(np.float32)
    tail = (batch, 6, kv_heads, head_dim)
    tk = e4m3_bytes(rng.normal(size=tail).astype(np.float32))
    tv = e4m3_bytes(rng.normal(size=tail).astype(np.float32))
    return q, k, v, table.astype(np.int32), ctx, tk, tv, np.array([5, 1, 6, 0], np.int32)


@pytest.mark.parametrize("window,sinks", [(None, None), (9, 3)], ids=["full", "swa-sinks"])
@pytest.mark.parametrize("tail", [False, True], ids=["no-tail", "tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_decode_matches_jax_and_pallas(dtype, tail, window, sinks):
    q, k, v, table, ctx, tk, tv, tl = decode_case(3)
    jk, tk_ = both_fp8(k)
    jv, tv_ = both_fp8(v)
    jtk, ttk = both_fp8(tk)
    jtv, ttv = both_fp8(tv)
    tails = dict(tail_k=ttk, tail_v=ttv, tail_lens=t(tl)) if tail else {}
    jtails = dict(tail_k=jtk, tail_v=jtv, tail_lens=jnp.asarray(tl)) if tail else {}
    tq = t(q).to(dtype)
    got = cuda_paged_decode_attention(tq, tk_, tv_, t(table), t(ctx), sliding_window=window,
                                      sinks=sinks, **tails).float().numpy()
    q_end = ctx + (tl if tail else 0)
    jq = jnp.asarray(q, JNP[dtype])
    ref = np.asarray(jax_paged_attention(
        jq[:, None], jk, jv, jnp.asarray(table), jnp.asarray(q_end - 1)[:, None],
        jnp.asarray(ctx), sliding_window=window, attention_sinks=sinks, **jtails),
        np.float32)[:, 0]
    tol = TOL[dtype]
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
    if dtype == torch.float32:  # the quantized arm of _decode_kernel_merged
        pallas = np.asarray(pallas_paged_decode_attention(
            jq, jk, jv, jnp.asarray(table), jnp.asarray(ctx), sliding_window=window,
            sinks=sinks, interpret=True, **jtails))
        np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


@pytest.mark.parametrize("window,sinks", [(None, None), (7, 2)], ids=["full", "swa-sinks"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_prefill_matches_jax(dtype, window, sinks):
    """The JAX engine prefills an fp8 pool with XLA attention over the
    upcast pages; the prefill wrapper's CPU path computes the same."""
    rng = np.random.default_rng(5)
    q_heads, kv_heads, head_dim, page, pages_per_seq = 8, 2, 8, 4, 6
    ctx, new = np.array([0, 9], np.int32), np.array([12, 5], np.int32)
    num_pages = 1 + 2 * pages_per_seq
    k, v = fp8_pools(rng, num_pages, kv_heads, page, head_dim)
    table = (1 + np.arange(2 * pages_per_seq)).reshape(2, pages_per_seq).astype(np.int32)
    q = rng.normal(size=(2, 12, q_heads, head_dim)).astype(np.float32)
    (jk, tk), (jv, tv) = both_fp8(k), both_fp8(v)
    total = ctx + new
    got = cuda_paged_prefill_attention(t(q).to(dtype), tk, tv, t(table), t(ctx), t(total),
                                       sliding_window=window, sinks=sinks).float().numpy()
    positions = ctx[:, None] + np.arange(12)[None]
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q, JNP[dtype]), jk, jv, jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(total), sliding_window=window, attention_sinks=sinks), np.float32)
    for b in range(2):  # valid query rows
        np.testing.assert_allclose(got[b, :new[b]], ref[b, :new[b]], atol=TOL[dtype],
                                   rtol=TOL[dtype])


ROWS, TOTAL_Q = 6, 48
MIXES = {  # (q_lens, ctx_lens), rows straddling the Pallas kernel's 8-token blocks
    "straddle": ([1, 7, 33, 0, 5, 1], [10, 3, 0, 20, 17, 40]),
    "continuation": ([1, 1, 24, 1, 0, 1], [12, 35, 21, 6, 0, 2]),
}


@pytest.mark.parametrize("window,sinks", [(None, None), (6, 3)], ids=["full", "swa-sinks"])
@pytest.mark.parametrize("mix", list(MIXES))
def test_plain_ragged_matches_pallas(mix, window, sinks):
    """The quantized arm of ``_ragged_kernel`` (interpret mode) on the real
    slots, fp32 queries."""
    rng = np.random.default_rng(7)
    q_lens, ctx = MIXES[mix]
    kv_heads, head_dim, page, pages_per_seq = 2, 8, 4, 16
    num_pages = 1 + ROWS * pages_per_seq
    k, v = fp8_pools(rng, num_pages, kv_heads, page, head_dim)
    table = rng.permutation(np.arange(1, num_pages)).reshape(ROWS, pages_per_seq)
    table = table.astype(np.int32)
    q = rng.normal(size=(TOTAL_Q, 2 * kv_heads, head_dim)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    ctx = np.array(ctx, np.int32)
    (jk, tk), (jv, tv) = both_fp8(k), both_fp8(v)
    ref = np.asarray(pallas_paged_ragged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(starts), jnp.asarray(ctx),
        sliding_window=window, sinks=sinks, interpret=True))
    got = cuda_paged_ragged_attention(t(q), tk, tv, t(table), t(starts), t(ctx),
                                      sliding_window=window, sinks=sinks).numpy()
    real = int(starts[-1])
    np.testing.assert_allclose(got[:real], ref[:real], atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


def test_fp8_wrappers_count_no_cpu_launch():
    q, k, v, table, ctx, tk, tv, tl = decode_case(0)
    counted = (cuda_paged_decode_attention, cuda_paged_prefill_attention,
               cuda_paged_ragged_attention)
    before = [(fn.launches, fn.launches_fp8) for fn in counted]
    _, k8 = both_fp8(k)
    _, v8 = both_fp8(v)
    cuda_paged_decode_attention(t(q), k8, v8, t(table), t(ctx))
    cuda_paged_prefill_attention(t(q)[:, None], k8, v8, t(table), t(ctx - 1), t(ctx))
    starts = torch.arange(len(ctx) + 1, dtype=torch.int32)
    cuda_paged_ragged_attention(t(q), k8, v8, t(table), starts, t(ctx) - 1)
    assert [(fn.launches, fn.launches_fp8) for fn in counted] == before


def test_fp8_off_the_cpu_is_checked_before_the_device():
    """On a device that is not the CPU an fp8 call either reaches a kernel
    or raises: a single KV head has no fp8 arm (as in JAX), a pool pair of
    two dtypes and an fp8 tail beside bf16 pools are refused, and nothing
    runs the plain version."""
    meta = dict(device="meta")
    q = torch.empty(2, 4, 128, dtype=torch.bfloat16, **meta)
    table = torch.empty(2, 3, dtype=torch.int32, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    single = torch.empty(9, 1, 16, 128, dtype=FP8, **meta)
    with pytest.raises(ValueError, match="fp8"):
        cuda_paged_decode_attention(q, single, single, table, lens)
    latent = torch.empty(9, 1, 16, 576, dtype=FP8, **meta)
    with pytest.raises(ValueError, match="fp8"):
        cuda_paged_prefill_attention(torch.empty(2, 8, 16, 576, dtype=torch.bfloat16, **meta),
                                     latent, None, table, lens, lens, shared_kv=True)
    k8 = torch.empty(9, 2, 16, 128, dtype=FP8, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_paged_decode_attention(q, k8, k8, table, lens)


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------

class Pair:
    """A JAX fp8 engine and a port fp8 engine with the same weights."""

    def __init__(self, kw=TINY, **cfg_kw):
        jcfg = jax_llama.LlamaConfig(**kw, dtype=jnp.float32)
        self.tcfg = llama.LlamaConfig(**kw, dtype=torch.float32)
        self.base = dict(num_pages=64, max_pages_per_seq=16, model_name="tiny-fp8",
                         pod_identifier="pod-q", kv_cache_dtype="f8_e4m3", **cfg_kw)
        self.jax_events, self.events = [], []
        self.jax = jax_engine.MiniEngine(jax_engine.EngineConfig(model=jcfg, **self.base),
                                         event_sink=self.jax_events.extend, seed=0)
        self.params = llama.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jax.params), self.tcfg, device="cpu")
        self.port = self.port_engine(event_sink=self.events.extend)

    def port_engine(self, event_sink=None, **overrides):
        return engine.MiniEngine(engine.EngineConfig(model=self.tcfg,
                                                     **{**self.base, **overrides}),
                                 event_sink=event_sink, params=self.params, device="cpu")


def assert_pools_equal(jax_eng, port_eng):
    """Every page but the garbage page 0 holds the same bytes."""
    for j, p in ((jax_eng.k_cache, port_eng.k_cache), (jax_eng.v_cache, port_eng.v_cache)):
        assert p.dtype == FP8
        np.testing.assert_array_equal(port_bytes(p)[:, 1:], np.asarray(j).view(np.uint8)[:, 1:])


@pytest.mark.parametrize("mode", [dict(), dict(ragged_attention=True), dict(decode_burst=8)],
                         ids=["padded", "ragged", "burst8"])
def test_fp8_engine_matches_jax(mode):
    pair = Pair(**mode)
    prompt = np.random.default_rng(3).integers(1, 250, 22).tolist()
    jr = pair.jax.generate("r", prompt, max_new_tokens=9)
    tr = pair.port.generate("r", prompt, max_new_tokens=9)
    assert tr == jr
    assert_pools_equal(pair.jax, pair.port)
    again = [pair.jax.add_request("r2", prompt[:16] + [7, 9], max_new_tokens=1),
             pair.port.add_request("r2", prompt[:16] + [7, 9], max_new_tokens=1)]
    assert again[1].cached_len == again[0].cached_len == 16
    assert again[1].output == again[0].output
    assert normalize(pair.events) == normalize(pair.jax_events)
    if mode.get("decode_burst"):  # bursts quantize their tail as single steps do
        single = pair.port_engine(decode_burst=1)
        assert single.generate("r", prompt, max_new_tokens=9) == tr


def test_fp8_logits_close_to_bf16_cache():
    """JAX's own bound (tests/test_kv_fp8.py): one prefill step over an fp8
    pool vs a bf16 pool, the same bf16 weights (the JAX tiny model's)."""
    cfg = llama.LlamaConfig.tiny()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_llama.init_params(jax.random.PRNGKey(1), jax_llama.LlamaConfig.tiny()))
    params = llama.params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(5)
    tokens = t(rng.integers(1, cfg.vocab_size - 1, (2, 16)).astype(np.int64))
    table = t(rng.permutation(16)[:8].reshape(2, 4).astype(np.int32))
    ctx, new = torch.zeros(2, dtype=torch.int32), torch.full((2,), 16, dtype=torch.int32)
    outs = {}
    for name, dtype in (("bf16", None), ("fp8", FP8)):
        k, v = llama.init_kv_cache(cfg, 16, dtype=dtype, device="cpu")
        outs[name], _, _ = llama.forward(params, cfg, tokens, k, v, table, ctx, new)
    err = float((outs["fp8"] - outs["bf16"]).abs().max())
    spread = float(outs["bf16"].abs().max())
    assert err < 0.25 * spread, (err, spread)
    a, b = outs["fp8"].flatten(), outs["bf16"].flatten()
    assert float(a @ b / (a.norm() * b.norm())) > 0.999


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_refusals_match_jax(tmp_path):
    mla_j = jax_llama.LlamaConfig(**DS_TINY, dtype=jnp.float32)
    mla_t = llama.LlamaConfig(**DS_TINY, dtype=torch.float32)
    with pytest.raises(ValueError, match="MLA"):
        jax_engine.MiniEngine(jax_engine.EngineConfig(model=mla_j, kv_cache_dtype="f8_e4m3"))
    with pytest.raises(ValueError, match="MLA"):
        engine.MiniEngine(engine.EngineConfig(model=mla_t, kv_cache_dtype="f8_e4m3"),
                          device="cpu")
    tiny = llama.LlamaConfig(**TINY, dtype=torch.float32)
    for bad in ("f8_e5m2", "fp8", "float16"):
        with pytest.raises(ValueError, match="kv_cache_dtype must be one of"):
            engine.MiniEngine(engine.EngineConfig(model=tiny, kv_cache_dtype=bad), device="cpu")
        with pytest.raises(ValueError, match="kv_cache_dtype must be one of"):
            jax_engine._resolve_kv_dtype(bad)
    for name in ("bf16", "bfloat16", "f8_e4m3", "float8_e4m3fn"):
        eng = engine.MiniEngine(engine.EngineConfig(model=tiny, num_pages=8,
                                                    kv_cache_dtype=name), device="cpu")
        assert str(eng.k_cache.dtype).removeprefix("torch.") == \
            jnp.dtype(jax_engine._resolve_kv_dtype(name)).name
    # An offload spec of another dtype would resume another element type.
    for dtype in ("bfloat16", "float32"):
        with pytest.raises(ValueError, match="dtype"):
            engine.MiniEngine(
                engine.EngineConfig(model=tiny, kv_cache_dtype="f8_e4m3"), device="cpu",
                offload_spec=spec.SharedStorageOffloadSpec(
                    root=str(tmp_path), dtype=dtype, **spec_kw(TINY)))


# --------------------------------------------------------------------------
# fp8 stores across the packages
# --------------------------------------------------------------------------

def fp8_spec(package, root):
    return package.SharedStorageOffloadSpec(root=str(root), dtype="float8_e4m3fn",
                                            **spec_kw(TINY))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fp8_store_restores_across_packages(tmp_path, writer):
    jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32)
    tcfg = llama.LlamaConfig(**TINY, dtype=torch.float32)
    cfg_kw = dict(num_pages=64, max_pages_per_seq=16, model_name="tiny",
                  kv_cache_dtype="f8_e4m3")

    def jax_pod(pod):
        return jax_engine.MiniEngine(
            jax_engine.EngineConfig(model=jcfg, pod_identifier=pod, **cfg_kw), seed=0,
            offload_spec=fp8_spec(jax_spec, tmp_path))

    first = jax_pod("pod-j")
    params = llama.params_from_jax(jax.tree_util.tree_map(np.asarray, first.params), tcfg,
                                   device="cpu")

    def port_pod(pod):
        return engine.MiniEngine(
            engine.EngineConfig(model=tcfg, pod_identifier=pod, **cfg_kw), params=params,
            device="cpu", offload_spec=fp8_spec(spec, tmp_path))

    src, dst = (first, port_pod("pod-t")) if writer == "jax" else (port_pod("pod-t"),
                                                                   jax_pod("pod-j2"))
    assert (fp8_spec(spec, tmp_path).build_mapper().base_dir
            == fp8_spec(jax_spec, tmp_path).build_mapper().base_dir)
    prompt = np.random.default_rng(3).integers(1, 256, 22).tolist()  # 5 blocks + 2
    want = src.generate("w", prompt, max_new_tokens=4)
    src.flush_offload()
    hashes = src.processor.tokens_to_kv_block_keys(EMPTY_BLOCK_HASH, prompt, "tiny")
    assert dst.offload_manager.lookup(hashes) == 5
    req = dst.add_request("r", prompt, max_new_tokens=4)
    while not req.done:
        dst.step()
    assert req.cached_len == 5 * TINY["page_size"] and req.restored_blocks == 5
    assert req.output == want

    def page_bytes(eng, h):
        page = eng.block_manager.blocks[h].page
        if isinstance(eng.k_cache, torch.Tensor):
            return port_bytes(eng.k_cache[:, page]), port_bytes(eng.v_cache[:, page])
        return (np.asarray(eng.k_cache[:, page]).view(np.uint8),
                np.asarray(eng.v_cache[:, page]).view(np.uint8))

    for h in hashes:
        for got, ref in zip(page_bytes(dst, h), page_bytes(src, h)):
            np.testing.assert_array_equal(got, ref)
