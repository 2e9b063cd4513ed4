"""The port's ragged mixed prefill+decode path against the JAX package.

- ``scatter_kv_pages_ragged`` is bit-equal to the JAX one (page 0, where
  padded slots land in an unspecified order, excepted).
- The plain ``paged_ragged_attention``, and ``cuda_paged_ragged_attention``
  on CPU tensors, match the JAX ``pallas_paged_ragged_attention`` run in
  interpret mode on the real slots, at fp32 within 1e-5 (only summation
  order differs): mixes that straddle 8-token tiles, pure decode, a pure
  prefill row, a continuation chunk and an empty row; sliding windows with
  and without sinks; GQA groups 1, 2, 4 and 8.
- ``forward_ragged`` matches the JAX ``forward_ragged(interpret=True)`` on
  the same weights (``params_from_jax``): logits per row and the updated
  caches.
- ``EngineConfig.ragged_attention=True`` gives the same greedy streams,
  ``cached_len`` values and event stream as the port's padded engine.

Inputs come from numpy with a seed. The JAX Pallas kernel compiles once
per shape and static arguments, so every mix of a case shares one shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.ops import kv_pages as jax_kv_pages
from llmd_kv_cache_tpu.ops.pallas_paged_attention import pallas_paged_ragged_attention
from llmd_kv_cache_tpu_torch.events.model import BlockRemovedEvent
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.ops import kv_pages
from llmd_kv_cache_tpu_torch.ops.cuda_paged_attention import cuda_paged_ragged_attention
from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_ragged_attention

# fp32 on both sides: the packages differ only in summation order.
ATOL = RTOL = 1e-5

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def row_starts_of(q_lens):
    return np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)


# --------------------------------------------------------------------------
# scatter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [4, 16])
def test_scatter_ragged_bit_equal(page_size):
    rng = np.random.default_rng(page_size)
    kv_heads, head_dim, pages_per_seq = 2, 8, 4
    q_lens, ctx = [1, 2 * page_size + 3, 0, 5], [page_size + 1, 3, 7, 0]
    rows = len(q_lens)
    num_pages = 1 + rows * pages_per_seq
    cache = rng.normal(size=(num_pages, kv_heads, page_size, head_dim)).astype(np.float32)
    table = rng.permutation(np.arange(1, num_pages)).reshape(rows, pages_per_seq)
    table = table.astype(np.int32)
    starts = row_starts_of(q_lens)
    total_q = int(starts[-1]) + 6  # six padded slots past the last row
    flat = np.arange(total_q)
    row_of = np.clip(np.searchsorted(starts, flat, side="right") - 1, 0, rows - 1)
    positions = (np.array(ctx)[row_of] + flat - starts[row_of]).astype(np.int32)
    valid = flat < starts[-1]
    new_kv = rng.normal(size=(total_q, kv_heads, head_dim)).astype(np.float32)

    ref = np.asarray(jax_kv_pages.scatter_kv_pages_ragged(
        jnp.asarray(cache), jnp.asarray(new_kv), jnp.asarray(table),
        jnp.asarray(row_of.astype(np.int32)), jnp.asarray(positions), jnp.asarray(valid)))
    got_t = t(cache.copy())
    out = kv_pages.scatter_kv_pages_ragged(got_t, t(new_kv), t(table), t(row_of),
                                           t(positions), t(valid))
    assert out is got_t  # written in place
    np.testing.assert_array_equal(got_t.numpy()[1:], ref[1:])
    assert not np.array_equal(got_t.numpy()[1:], cache[1:])  # it did write


# --------------------------------------------------------------------------
# attention vs the JAX Pallas ragged kernel (interpret mode)
# --------------------------------------------------------------------------

KV_HEADS, HEAD_DIM, PAGE, PAGES_PER_SEQ = 2, 8, 4, 16
ROWS, TOTAL_Q = 6, 48  # every mix has this shape: one compile per case

# name -> (q_lens, ctx_lens); each sums to at most TOTAL_Q, and the rest of
# the flat axis is padding.
MIXES = {
    # Rows straddle the Pallas kernel's 8-token blocks; row 3 is empty.
    "straddle": ([1, 7, 33, 0, 5, 1], [10, 3, 0, 20, 17, 40]),
    "decode": ([1, 1, 1, 1, 1, 1], [1, 4, 9, 30, 47, 60]),
    # A cold prefill row beside empty rows.
    "prefill": ([0, 0, 29, 0, 0, 0], [0, 0, 0, 0, 0, 0]),
    # A chunk over a cached prefix, with decode rows around it.
    "continuation": ([1, 1, 24, 1, 0, 1], [12, 35, 21, 6, 0, 2]),
}

# (group, sliding_window, sinks): each group, and SWA with and without sinks.
ATTN_CASES = [
    pytest.param(2, None, None, id="g2"),
    pytest.param(2, 6, None, id="g2-swa"),
    pytest.param(2, 6, 3, id="g2-swa-sinks"),
    pytest.param(1, 5, 2, id="g1-swa-sinks"),
    pytest.param(4, None, None, id="g4"),
    pytest.param(8, 9, None, id="g8-swa"),
]


def ragged_case(mix, group, seed=0):
    rng = np.random.default_rng(seed)
    q_lens, ctx = MIXES[mix]
    num_pages = 1 + ROWS * PAGES_PER_SEQ
    shape = (num_pages, KV_HEADS, PAGE, HEAD_DIM)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    table = rng.permutation(np.arange(1, num_pages)).reshape(ROWS, PAGES_PER_SEQ)
    q = rng.normal(size=(TOTAL_Q, KV_HEADS * group, HEAD_DIM)).astype(np.float32)
    return q, k, v, table.astype(np.int32), row_starts_of(q_lens), np.array(ctx, np.int32)


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("group,window,sinks", ATTN_CASES)
def test_ragged_attention_matches_jax(mix, group, window, sinks):
    q, k, v, table, starts, ctx = ragged_case(mix, group)
    real = int(starts[-1])
    ref = np.asarray(pallas_paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(ctx), sliding_window=window, sinks=sinks,
        interpret=True))
    args = (t(q), t(k), t(v), t(table), t(starts), t(ctx))
    plain = paged_ragged_attention(*args, sliding_window=window, sinks=sinks).numpy()
    # The wrapper's CPU path is the plain version.
    wrapped = cuda_paged_ragged_attention(*args, sliding_window=window,
                                          sinks=sinks).numpy()
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_allclose(plain[:real], ref[:real], atol=ATOL, rtol=RTOL)
    # Slots past the last row are zeros (the JAX kernel leaves them
    # unspecified).
    assert not plain[real:].any()


def test_ragged_wrapper_contract():
    q, k, v, table, starts, ctx = ragged_case("straddle", 2)
    args = (t(q), t(k), t(v), t(table), t(starts), t(ctx))
    # shared_kv (the K pool is also V) and burst tails reach the plain
    # version on the CPU (tests/test_torch_ragged_mla.py holds both against
    # JAX); a tail set missing a member is refused, as in JAX.
    assert torch.equal(cuda_paged_ragged_attention(*args, shared_kv=True),
                       paged_ragged_attention(t(q), t(k), t(k), *args[3:]))
    tail = t(k[:ROWS]).transpose(1, 2).contiguous()
    tail_lens = torch.ones(ROWS, dtype=torch.int32)
    assert torch.equal(
        cuda_paged_ragged_attention(*args, tail_k=tail, tail_v=tail, tail_lens=tail_lens),
        paged_ragged_attention(*args, tail_k=tail, tail_v=tail, tail_lens=tail_lens))
    with pytest.raises(ValueError, match="tail_lens"):
        cuda_paged_ragged_attention(*args, tail_k=tail, tail_v=tail)
    # fp8 pools are taken (the kernel's fp8 arm on the card): on the CPU the
    # plain version attends over the pages upcast to q's dtype.
    fp8 = torch.float8_e4m3fn
    k8, v8 = t(k).to(fp8), t(v).to(fp8)
    assert torch.equal(cuda_paged_ragged_attention(t(q), k8, v8, *args[3:]),
                       paged_ragged_attention(t(q), k8.float(), v8.float(), *args[3:]))
    # CPU calls run the plain version and count no launch.
    before = cuda_paged_ragged_attention.launches
    cuda_paged_ragged_attention(*args)
    assert cuda_paged_ragged_attention.launches == before
    # A tensor that is neither on the CPU nor on a card is refused.
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_paged_ragged_attention(*meta)


# --------------------------------------------------------------------------
# forward_ragged vs the JAX forward_ragged
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_models():
    """The JAX tiny model at fp32 and the port's copy of its weights."""
    jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32)
    tcfg = llama.LlamaConfig(**TINY, dtype=torch.float32)
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_forward_ragged_matches_jax(tiny_models):
    jcfg, jparams, tcfg, tparams = tiny_models
    rng = np.random.default_rng(0)
    num_pages, pages_per_seq, rows = 40, 8, 4
    jk, jv = jax_llama.init_kv_cache(jcfg, num_pages)
    tk, tv = llama.init_kv_cache(tcfg, num_pages, device="cpu")
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
        tlog, tk2, tv2 = llama.forward_ragged(
            tparams, tcfg, t(toks), tk, tv, t(table), t(starts), t(ctx))
        assert tk2 is tk and tv2 is tv  # the caches are updated in place
        assert tlog.shape == (rows, jcfg.vocab_size)
        jlog = np.asarray(jlog)
        live = np.array(q_lens) > 0  # an empty row's logits are ignored
        scale = float(np.abs(jlog[live]).max())
        np.testing.assert_allclose(tlog.numpy()[live], jlog[live], rtol=0,
                                   atol=1e-4 * scale)
        for got, ref in ((tk, jk), (tv, jv)):  # page 0 excepted
            np.testing.assert_allclose(got.numpy()[:, 1:], np.asarray(ref)[:, 1:],
                                       atol=ATOL, rtol=RTOL)

    # Cold prefill chunks of three rows (row 2 empty), padded flat axis;
    # then decode rows beside a continuation chunk.
    step([10, 6, 0, 3], [0, 0, 0, 0], pad=5)
    step([1, 5, 0, 1], [10, 6, 0, 3], pad=1)


# --------------------------------------------------------------------------
# the ragged engine against the padded engine
# --------------------------------------------------------------------------

def normalize(events):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in events]


class Engines:
    """The port's padded engine and its ragged engine on the same weights
    (fp32: bf16 argmax near-ties flip between differently shaped calls)."""

    def __init__(self, **cfg_kw):
        tcfg = llama.LlamaConfig(**TINY, dtype=torch.float32)
        params = llama.init_params(tcfg, seed=0, device="cpu")
        base = dict(model=tcfg, max_pages_per_seq=16, model_name="tiny",
                    pod_identifier="pod-0")
        base.update(cfg_kw)
        self.events = {False: [], True: []}
        self.eng = {
            ragged: engine.MiniEngine(
                engine.EngineConfig(**base, ragged_attention=ragged),
                event_sink=self.events[ragged].extend, params=params, device="cpu")
            for ragged in (False, True)}

    def enqueue(self, *args, **kwargs):
        padded = self.eng[False].enqueue(*args, **kwargs)
        ragged = self.eng[True].enqueue(*args, **kwargs)
        return padded, ragged

    def step(self):
        emitted = self.eng[False].step()
        assert self.eng[True].step() == emitted
        return emitted

    def run(self, reqs, max_steps=200):
        for _ in range(max_steps):
            self.step()
            if all(p.done for p, _ in reqs):
                break
        for p, r in reqs:
            assert p.done and r.done
            assert (r.output, r.cached_len) == (p.output, p.cached_len)

    def assert_same_state(self):
        assert normalize(self.events[True]) == normalize(self.events[False])
        padded, ragged = self.eng[False], self.eng[True]
        assert ragged.block_manager.num_free() == padded.block_manager.num_free()
        assert ragged.block_manager.num_cached_blocks() == \
            padded.block_manager.num_cached_blocks()


def prompts(seed, lengths, prefix_len=13):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 256, prefix_len).tolist()
    return [prefix + rng.integers(1, 256, n).tolist() for n in lengths]


def test_ragged_engine_rides_prefill_with_decode_rows():
    """max_batch below the running requests (two decode dispatches a step,
    the prefill chunk in the first), chunked prefill, prefix reuse."""
    pair = Engines(num_pages=96, max_batch=2, max_prefill_tokens=8)
    assert (pair.eng[True].cfg.ragged_attention
            and not pair.eng[False].cfg.ragged_attention)
    ps = prompts(1, (7, 3, 12, 0, 20, 5))
    reqs = [pair.enqueue(f"r{i}", p, max_new_tokens=4 + i)
            for i, p in enumerate(ps[:-1])]
    pair.run(reqs)
    reuse = pair.enqueue("reuse", ps[-1], max_new_tokens=3)
    assert reuse[1].cached_len == 12  # the shared prefix's 3 full blocks
    pair.run([reuse])
    pair.assert_same_state()


def test_ragged_engine_arrivals_mid_decode():
    """Requests that arrive while others decode: each new prompt's chunks
    ride beside the running decode rows; a one-token request finishes at
    its prefill."""
    pair = Engines(num_pages=96, max_batch=3, max_prefill_tokens=4)
    ps = prompts(2, (5, 9, 2, 14, 1))
    reqs = [pair.enqueue("a", ps[0], max_new_tokens=12)]
    for i, p in enumerate(ps[1:]):
        for _ in range(2):
            pair.step()
        reqs.append(pair.enqueue(f"b{i}", p, max_new_tokens=1 if i == 1 else 6))
    pair.run(reqs)
    pair.assert_same_state()


def test_ragged_engine_evicts_in_an_undersized_pool():
    pair = Engines(num_pages=10, max_prefill_tokens=8)
    for i, p in enumerate(prompts(3, (12, 12, 12, 12), prefix_len=0)):
        pair.run([pair.enqueue(f"r{i}", p, max_new_tokens=2)])
    assert any(isinstance(e, BlockRemovedEvent) for e in pair.events[True])
    assert pair.eng[True].block_manager.evictions == \
        pair.eng[False].block_manager.evictions > 0
    pair.assert_same_state()


def test_ragged_engine_abort_mid_prefill():
    pair = Engines(num_pages=64, max_batch=4, max_prefill_tokens=4)
    ps = prompts(4, (6, 15))
    decoding = pair.enqueue("d", ps[0], max_new_tokens=10)
    for _ in range(6):
        pair.step()
    long = pair.enqueue("long", ps[1], max_new_tokens=4)
    pair.step()  # one chunk of the long prompt rides beside "d"
    assert long[1].prefill_pos is not None and long[1].computed_len > 0
    assert [e.abort_request("long") for e in pair.eng.values()] == [True, True]
    pair.run([decoding])
    pair.assert_same_state()
    late = pair.enqueue("late", ps[1], max_new_tokens=3)
    pair.run([late])
    pair.assert_same_state()
