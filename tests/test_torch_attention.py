"""The port's paged-KV ops against the JAX package.

- ``scatter_kv_pages`` / ``gather_kv_pages`` / ``gather_pages_flat`` are
  bit-equal to ``llmd_kv_cache_tpu.ops.kv_pages``.
- The plain ``paged_attention`` (the CPU path of both Hopper kernels'
  wrappers) matches the JAX ``ops.paged_attention`` and the JAX Pallas
  decode and prefill kernels run in interpret mode, at fp32 within 1e-5
  (only fp32 summation order differs).

Inputs come from numpy with a seed and go through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.ops import kv_pages as jax_kv_pages
from llmd_kv_cache_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from llmd_kv_cache_tpu.ops.pallas_paged_attention import (
    pallas_paged_decode_attention,
    pallas_paged_prefill_attention,
)
from llmd_kv_cache_tpu_torch.ops import kv_pages
from llmd_kv_cache_tpu_torch.ops.cuda_paged_attention import (
    cuda_paged_decode_attention,
    cuda_paged_prefill_attention,
    cuda_paged_ragged_attention,
)
from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

# fp32 on both sides: the packages differ only in summation order.
ATOL = RTOL = 1e-5


def make_pool(rng, num_pages, kv_heads, page_size, head_dim):
    """Random K/V pools: every page, the garbage page 0 included, holds
    values, so a read past a sequence's keys would show."""
    shape = (num_pages, kv_heads, page_size, head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def make_table(rng, lens, pages_per_seq, page_size, num_pages):
    """Distinct random physical pages (never page 0) per row."""
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((len(lens), pages_per_seq), np.int32)
    used = 0
    for b, n in enumerate(lens):
        n_pages = (n + page_size - 1) // page_size
        table[b, :n_pages] = perm[used:used + n_pages]
        used += n_pages
    return table


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# scatter / gather
# --------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("padded", [False, True])
def test_scatter_bit_equal(page_size, padded):
    rng = np.random.default_rng(page_size + padded)
    kv_heads, head_dim, batch, seq = 2, 8, 3, 2 * page_size + 3
    pages_per_seq = 4
    num_pages = 1 + batch * pages_per_seq
    cache, _ = make_pool(rng, num_pages, kv_heads, page_size, head_dim)
    table = np.arange(1, num_pages, dtype=np.int32).reshape(batch, pages_per_seq)
    ctx = np.array([0, 5, page_size - 1], np.int32)
    positions = (ctx[:, None] + np.arange(seq)[None]).astype(np.int32)
    new_lens = np.array([seq, seq - 4, 1] if padded else [seq] * 3, np.int32)
    valid = np.arange(seq)[None] < new_lens[:, None]
    new_kv = rng.normal(size=(batch, seq, kv_heads, head_dim)).astype(np.float32)

    ref = np.asarray(jax_kv_pages.scatter_kv_pages(
        jnp.asarray(cache), jnp.asarray(new_kv), jnp.asarray(table),
        jnp.asarray(positions), jnp.asarray(valid)))
    got_t = t(cache.copy())
    out = kv_pages.scatter_kv_pages(got_t, t(new_kv), t(table), t(positions), t(valid))
    assert out is got_t  # written in place
    got = got_t.numpy()
    # Padded slots all land on the garbage page's slot 0 in an unspecified
    # order; every real page must match bit for bit.
    first = 1 if padded else 0
    np.testing.assert_array_equal(got[first:], ref[first:])


@pytest.mark.parametrize("page_size", [4, 16])
def test_gather_bit_equal(page_size):
    rng = np.random.default_rng(7)
    cache, _ = make_pool(rng, 9, 2, page_size, 8)
    table = rng.integers(0, 9, size=(2, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        kv_pages.gather_kv_pages(t(cache), t(table)).numpy(),
        np.asarray(jax_kv_pages.gather_kv_pages(jnp.asarray(cache), jnp.asarray(table))))
    ids = np.array([3, 1, 8], np.int32)
    np.testing.assert_array_equal(
        kv_pages.gather_pages_flat(t(cache), t(ids)).numpy(),
        np.asarray(jax_kv_pages.gather_pages_flat(jnp.asarray(cache), jnp.asarray(ids))))


# --------------------------------------------------------------------------
# plain attention vs the JAX reference and the Pallas kernels (interpret)
# --------------------------------------------------------------------------

# (page_size, q_heads, kv_heads, head_dim, sliding_window, sinks)
ATTN_CASES = [
    pytest.param(4, 4, 2, 8, None, None, id="gqa-p4"),
    pytest.param(16, 8, 2, 16, None, None, id="gqa-p16"),
    pytest.param(4, 4, 4, 8, None, None, id="mha-p4"),
    pytest.param(4, 4, 2, 8, 6, None, id="swa-p4"),
    pytest.param(4, 4, 2, 8, 6, 3, id="swa-sinks-p4"),
    pytest.param(16, 8, 2, 16, 20, 5, id="swa-sinks-p16"),
    pytest.param(16, 4, 2, 128, None, None, id="gqa-hd128-p16"),
]


def decode_case(page_size, q_heads, kv_heads, head_dim, seed=0):
    """Four decode rows: page-crossing contexts and a padded ctx-0 row."""
    rng = np.random.default_rng(seed)
    pages_per_seq = 5
    lens = [page_size * 3 + 1, page_size, 2, 0]
    num_pages = 1 + len(lens) * pages_per_seq
    k, v = make_pool(rng, num_pages, kv_heads, page_size, head_dim)
    table = make_table(rng, lens, pages_per_seq, page_size, num_pages)
    q = rng.normal(size=(len(lens), q_heads, head_dim)).astype(np.float32)
    return q, k, v, table, np.array(lens, np.int32)


@pytest.mark.parametrize("page_size,q_heads,kv_heads,head_dim,window,sinks", ATTN_CASES)
def test_decode_plain_matches_jax(page_size, q_heads, kv_heads, head_dim, window, sinks):
    q, k, v, table, ctx = decode_case(page_size, q_heads, kv_heads, head_dim)
    live = ctx > 0
    # The wrapper's CPU path is the plain version.
    got = cuda_paged_decode_attention(t(q), t(k), t(v), t(table), t(ctx),
                                      sliding_window=window, sinks=sinks).numpy()
    # JAX wrappers drop sinks without a window, as the port's does.
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(ctx - 1)[:, None], jnp.asarray(ctx), sliding_window=window,
        attention_sinks=sinks if window else None))[:, 0]
    # A ctx-0 row has no key: both plain versions average every key.
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    pallas = np.asarray(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(ctx), sliding_window=window, sinks=sinks, interpret=True))
    np.testing.assert_allclose(got[live], pallas[live], atol=ATOL, rtol=RTOL)


def prefill_case(page_size, q_heads, kv_heads, head_dim, q_seq, seed=1):
    """Two rows: a chunk over a page-crossing cached prefix (padded) and a
    cold chunk; the new tokens' KV is already in the pool."""
    rng = np.random.default_rng(seed)
    ctx = np.array([page_size + 3, 0], np.int32)
    new = np.array([q_seq - 3, q_seq], np.int32)
    total = ctx + new
    pages_per_seq = int(max((total + page_size - 1) // page_size)) + 1
    num_pages = 1 + 2 * pages_per_seq
    k, v = make_pool(rng, num_pages, kv_heads, page_size, head_dim)
    table = make_table(rng, list(total), pages_per_seq, page_size, num_pages)
    q = rng.normal(size=(2, q_seq, q_heads, head_dim)).astype(np.float32)
    return q, k, v, table, ctx, total, new


@pytest.mark.parametrize("page_size,q_heads,kv_heads,head_dim,window,sinks", ATTN_CASES)
def test_prefill_plain_matches_jax(page_size, q_heads, kv_heads, head_dim, window, sinks):
    q_seq = 2 * page_size
    q, k, v, table, ctx, total, new = prefill_case(
        page_size, q_heads, kv_heads, head_dim, q_seq)
    got = cuda_paged_prefill_attention(t(q), t(k), t(v), t(table), t(ctx), t(total),
                                       sliding_window=window, sinks=sinks).numpy()
    positions = ctx[:, None] + np.arange(q_seq)[None]
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(positions), jnp.asarray(total), sliding_window=window,
        attention_sinks=sinks if window else None))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    pallas = np.asarray(pallas_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(ctx), jnp.asarray(total), q_tile=4, sliding_window=window,
        sinks=sinks, interpret=True))
    for b in range(2):  # valid query rows only
        np.testing.assert_allclose(got[b, :new[b]], pallas[b, :new[b]],
                                   atol=ATOL, rtol=RTOL)


def test_bf16_plain_matches_jax():
    """The bf16 numerics (bf16 operands, fp32 scores and softmax, p rounded
    to bf16 before PV) agree with the JAX reference within bf16 rounding."""
    q, k, v, table, ctx = decode_case(16, 8, 2, 16, seed=3)
    bf = torch.bfloat16
    got = cuda_paged_decode_attention(
        t(q).to(bf), t(k).to(bf), t(v).to(bf), t(table), t(ctx)).float().numpy()
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q, jnp.bfloat16)[:, None], jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(ctx - 1)[:, None], jnp.asarray(ctx)), np.float32)[:, 0]
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------------
# the wrappers' contract
# --------------------------------------------------------------------------

def test_wrappers_do_not_count_cpu_calls():
    q, k, v, table, ctx = decode_case(4, 4, 2, 8)
    before = (cuda_paged_decode_attention.launches,
              cuda_paged_prefill_attention.launches)
    cuda_paged_decode_attention(t(q), t(k), t(v), t(table), t(ctx))
    cuda_paged_prefill_attention(t(q)[:, None], t(k), t(v), t(table), t(ctx - 1),
                                 t(ctx))
    assert (cuda_paged_decode_attention.launches,
            cuda_paged_prefill_attention.launches) == before


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    never quietly computed by the plain version."""
    meta = dict(device="meta")
    q = torch.empty(2, 4, 8, **meta)
    k = torch.empty(9, 2, 4, 8, **meta)
    table = torch.empty(2, 3, dtype=torch.int32, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_paged_decode_attention(q, k, k, table, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_paged_prefill_attention(q[:, None], k, k, table, lens, lens)


def _decode_tail(q, k, v, table, ctx):
    # The decode kernels take a burst tail; without its tail_lens it is
    # refused, as the JAX wrapper refuses it.
    tail = k[:q.shape[0]].transpose(1, 2).contiguous()  # [batch, T, kv_heads, hd]
    cuda_paged_decode_attention(q, k, v, table, ctx, tail_k=tail, tail_v=tail)


def _ragged_tail(q, k, v, table, ctx):
    # The ragged kernels take a burst tail too; without its tail_lens it is
    # refused, as the JAX wrapper refuses it.
    starts = torch.arange(len(ctx) + 1, dtype=torch.int32)
    tail = k[:len(ctx)].transpose(1, 2).contiguous()
    cuda_paged_ragged_attention(q, k, v, table, starts, ctx, tail_k=tail, tail_v=tail)


def _fp8_cache(q, k, v, table, ctx):
    # fp8 pools have GQA kernels; a single KV head (MLA latent or MQA) has
    # no fp8 arm, as the JAX wrapper has none, and is refused off the CPU.
    pool = torch.empty(9, 1, 4, 8, device="meta", dtype=torch.float8_e4m3fn)
    cuda_paged_decode_attention(torch.empty(4, 4, 8, device="meta", dtype=torch.bfloat16),
                                pool, pool, table.to("meta"), ctx.to("meta"))


def _ragged_shared_kv(q, k, v, table, ctx):
    # The ragged shared_kv (MLA) arm is built for latent widths 576 and 640
    # with 16 heads; another shape off the CPU is refused before the device
    # is looked at.
    meta = dict(device="meta", dtype=torch.bfloat16)
    starts = torch.arange(len(ctx) + 1, dtype=torch.int32, device="meta")
    cuda_paged_ragged_attention(torch.empty(4, 16, 512, **meta),
                                torch.empty(9, 1, 16, 512, **meta), None, table.to("meta"),
                                starts, ctx.to("meta"), shared_kv=True)


def _unbuilt_latent_decode(q, k, v, table, ctx):
    # A latent width the kernel is not built for (576 and 640 are), on a
    # device other than the CPU: refused before the device is looked at.
    meta = dict(device="meta", dtype=torch.bfloat16)
    cuda_paged_decode_attention(torch.empty(4, 16, 512, **meta),
                                torch.empty(9, 1, 16, 512, **meta), None,
                                table.to("meta"), ctx.to("meta"), shared_kv=True)


def _unbuilt_latent_prefill(q, k, v, table, ctx):
    meta = dict(device="meta", dtype=torch.bfloat16)
    lens = ctx.to("meta")
    cuda_paged_prefill_attention(torch.empty(4, 8, 8, 576, **meta),
                                 torch.empty(9, 1, 16, 576, **meta), None,
                                 table.to("meta"), lens, lens, shared_kv=True)


@pytest.mark.parametrize("call,error,match", [
    pytest.param(_decode_tail, ValueError, "tail_k requires tail_lens", id="decode-tail"),
    pytest.param(_ragged_tail, ValueError, "tail_k requires tail_lens", id="ragged-tail"),
    pytest.param(_fp8_cache, ValueError, "fp8", id="fp8"),
    pytest.param(_ragged_shared_kv, NotImplementedError, "latent ragged kernel is built for",
                 id="ragged-shared-kv"),
    pytest.param(_unbuilt_latent_decode, NotImplementedError,
                 "latent decode kernel is built for", id="latent-decode-unbuilt-width"),
    pytest.param(_unbuilt_latent_prefill, NotImplementedError,
                 "latent prefill kernel is built for", id="latent-prefill-unbuilt-group"),
])
def test_unported_arms_raise(call, error, match):
    q, k, v, table, ctx = decode_case(4, 4, 2, 8)
    with pytest.raises(error, match=match):
        call(t(q), t(k), t(v), t(table), t(ctx))
