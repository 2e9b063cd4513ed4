"""The forward on fused trees, against the JAX package.

The padded forward of every tree family of ``tests/test_torch_fused.py``
fused (and the Qwen2-bias and DeepSeek-router GQA trees fused at t = 2 in
one process, split as JAX splits them), the ragged forward (JAX's Pallas
kernel in interpret mode), a decode burst and the hybrid two-pool forward
equal JAX's fused forward at fp32 within 1e-5 of the largest logit; the
pools within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu_torch.models import llama

from tests.test_torch_fused import (
    CANONICAL_ONLY,
    INTERLEAVED,
    assert_trees_bit_equal,
    fused_pair,
    to_numpy,
)
from tests.test_torch_swa import config_pair, jax_params

FWD_TOL = 1e-5  # of the largest |logit|, fp32 on both sides


def assert_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL * scale)


def padded_steps(rng, vocab):
    """Two rows prefilled in chunks of 6 (the second row shorter), then a
    decode step with one live row."""
    steps, ctx = [], np.zeros(2, np.int32)
    for start in (0, 6, 12):
        new = np.array([6, max(0, min(6, 11 - start))], np.int32)
        steps.append((rng.integers(0, vocab, (2, 6)).astype(np.int32), ctx.copy(), new))
        ctx = ctx + new
    steps.append((rng.integers(0, vocab, (2, 1)).astype(np.int32), ctx,
                  np.array([1, 0], np.int32)))
    return steps


FORWARD = [pytest.param(name, 1, id=name) for name in INTERLEAVED + CANONICAL_ONLY]
FORWARD += [pytest.param(name, 2, id=f"{name}-t2") for name in ("bias", "deepseek-gqa")]


@pytest.mark.parametrize("name,t", FORWARD)
def test_forward_on_fused_trees_matches_jax(name, t):
    """The padded forward of a fused tree (t = 2: the whole interleaved tree
    in one process, split as JAX splits it) against JAX's fused forward;
    the pools too, and the unfused tree's logits."""
    jcfg, tcfg, tree, jfused, tfused = fused_pair(name, t, jnp.float32, seed=3)
    jparams = jax_params(jfused)
    table = np.arange(1, 11, dtype=np.int32).reshape(2, 5)
    jk, jv = jax_llama.init_kv_cache(jcfg, 12)
    tk, tv = llama.init_kv_cache(tcfg, 12, device="cpu")
    uk, uv = llama.init_kv_cache(tcfg, 12, device="cpu")
    unfused = llama.params_from_jax(tree, tcfg, device="cpu")
    for toks, ctx, new in padded_steps(np.random.default_rng(3), 256):
        jlog, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(toks), jk, jv,
                                         jnp.asarray(table), jnp.asarray(ctx), jnp.asarray(new))
        args = (torch.from_numpy(toks),)
        rest = (torch.from_numpy(table), torch.from_numpy(ctx), torch.from_numpy(new))
        tlog = llama.forward(tfused, tcfg, *args, tk, tv, *rest)[0].numpy()
        ulog = llama.forward(unfused, tcfg, *args, uk, uv, *rest)[0].numpy()
        jlog = np.asarray(jlog)
        for b in range(2):
            if new[b]:
                assert_close(tlog[b, :new[b]], jlog[b, :new[b]])
                assert_close(ulog[b, :new[b]], jlog[b, :new[b]])
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)


def test_forward_ragged_on_a_fused_tree_matches_jax():
    """A mixed dispatch of the fused Qwen2-bias tree (two decode rows, one
    5-token chunk over a cached prefix) against JAX's ``forward_ragged``
    (its Pallas kernel in interpret mode) on the same fused tree."""
    jcfg, tcfg, _, jfused, tfused = fused_pair("bias", 1, jnp.float32, seed=4)
    jparams = jax_params(jfused)
    rng = np.random.default_rng(4)
    q_lens, ctx = [1, 5, 1], np.array([9, 6, 3], np.int32)
    tables = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    jk, jv = jax_llama.init_kv_cache(jcfg, 13)
    tk, tv = llama.init_kv_cache(tcfg, 13, device="cpu")
    pre = rng.integers(0, 256, (3, 9)).astype(np.int32)
    zeros = np.zeros(3, np.int32)
    _, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(pre), jk, jv,
                                  jnp.asarray(tables), jnp.asarray(zeros), jnp.asarray(ctx))
    llama.forward(tfused, tcfg, torch.from_numpy(pre), tk, tv, torch.from_numpy(tables),
                  torch.from_numpy(zeros), torch.from_numpy(ctx))
    starts = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    flat = np.zeros((1, 8), np.int32)
    flat[0, :starts[-1]] = rng.integers(0, 256, starts[-1])
    jlog, jk, jv = jax_llama.forward_ragged(
        jparams, jcfg, jnp.asarray(flat), jk, jv, jnp.asarray(tables), jnp.asarray(starts),
        jnp.asarray(ctx), interpret=True)
    tlog = llama.forward_ragged(tfused, tcfg, torch.from_numpy(flat), tk, tv,
                                torch.from_numpy(tables), torch.from_numpy(starts),
                                torch.from_numpy(ctx))[0].numpy()
    assert_close(tlog, np.asarray(jlog)[:3])
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["tiny", "deepseek"])
def test_decode_burst_on_a_fused_tree_matches_jax(name):
    jcfg, tcfg, _, jfused, tfused = fused_pair(name, 1, jnp.float32, seed=5)
    jparams = jax_params(jfused)
    rng = np.random.default_rng(5)
    table = np.arange(1, 19, dtype=np.int32).reshape(3, 6)
    lens = np.array([9, 4, 0], np.int32)
    prompt = rng.integers(0, 256, (3, 9)).astype(np.int32)
    jk, jv = jax_llama.init_kv_cache(jcfg, 20)
    tk, tv = llama.init_kv_cache(tcfg, 20, device="cpu")
    zeros = np.zeros(3, np.int32)
    _, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(prompt), jk, jv,
                                  jnp.asarray(table), jnp.asarray(zeros), jnp.asarray(lens))
    llama.forward(tfused, tcfg, torch.from_numpy(prompt), tk, tv, torch.from_numpy(table),
                  torch.from_numpy(zeros), torch.from_numpy(lens))
    last, active = np.array([7, 9, 0], np.int32), np.array([4, 3, 0], np.int32)
    jt, jk, jv = jax_llama.forward_decode_steps(
        jparams, jcfg, jnp.asarray(last), jk, jv, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(active), 4)
    tt = llama.forward_decode_steps(tfused, tcfg, torch.from_numpy(last), tk, tv,
                                    torch.from_numpy(table), torch.from_numpy(lens),
                                    torch.from_numpy(active), 4)[0].numpy()
    for r in range(2):
        assert tt[r, :active[r]].tolist() == np.asarray(jt)[r, :active[r]].tolist()
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)


def test_forward_hybrid_on_a_fused_tree_matches_jax():
    jcfg, tcfg = config_pair("hybrid")
    tree = to_numpy(jax_llama.init_params(jax.random.PRNGKey(6), jcfg))
    jfused = to_numpy(jax_llama.fuse_params(jax_params(tree), jcfg))
    tfused = llama.fuse_params(llama.params_from_jax(tree, tcfg, device="cpu"), tcfg)
    assert_trees_bit_equal(tfused, jfused)
    rng = np.random.default_rng(6)
    t0 = np.arange(1, 11, dtype=np.int32)[None]
    t1 = np.arange(1, 11, dtype=np.int32)[None]
    jpools = jax_llama.init_kv_cache_hybrid(jcfg, 12, 12)
    tpools = llama.init_kv_cache_hybrid(tcfg, 12, 12, device="cpu")
    ctx = np.zeros(1, np.int32)
    for n in (14, 6):
        toks = rng.integers(0, 256, (1, n)).astype(np.int32)
        new = np.full(1, n, np.int32)
        jout = jax_llama.forward_hybrid(jax_params(jfused), jcfg, jnp.asarray(toks), *jpools,
                                        jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(ctx),
                                        jnp.asarray(new))
        jlog, jpools = np.asarray(jout[0]), jout[1:]
        tlog = llama.forward_hybrid(tfused, tcfg, torch.from_numpy(toks), *tpools,
                                    torch.from_numpy(t0), torch.from_numpy(t1),
                                    torch.from_numpy(ctx), torch.from_numpy(new))[0].numpy()
        assert_close(tlog, jlog)
        ctx = ctx + n
