"""The port's dense paged Llama against the JAX ``models.llama``.

Parameters come from the JAX ``init_params`` through ``params_from_jax``;
logits of a prefill chunk over a cached prefix and of a decode step must be
allclose to the JAX ``forward``. Compared at fp32 (bf16 argmax near-ties
flip between differently compiled programs), within 1e-4 relative to the
largest logit: the two packages differ only in fp32 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu_torch.models import llama

TOL = 1e-4


def configs(dtype):
    """(JAX config, port config) pairs: the JAX tiny model and a head_dim-128
    GQA model at page size 16."""
    jax_dtype, torch_dtype = dtype
    tiny = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)
    hd128 = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, head_dim=128, intermediate_size=256, page_size=16)
    return [(jax_llama.LlamaConfig(**kw, dtype=jax_dtype),
             llama.LlamaConfig(**kw, dtype=torch_dtype)) for kw in (tiny, hd128)]


FP32 = (jnp.float32, torch.float32)
CASES = [pytest.param(*pair, id=name)
         for pair, name in zip(configs(FP32), ("tiny", "gqa-hd128"))]


def jax_tree_to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def assert_logits_close(got, ref):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("jcfg,tcfg", CASES)
def test_prefill_over_cached_prefix_and_decode_match_jax(jcfg, tcfg):
    rng = np.random.default_rng(0)
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = llama.params_from_jax(jax_tree_to_numpy(jparams), tcfg, device="cpu")
    page = jcfg.page_size
    num_pages, pages_per_seq = 24, 8
    jk, jv = jax_llama.init_kv_cache(jcfg, num_pages)
    tk, tv = llama.init_kv_cache(tcfg, num_pages, device="cpu")
    # Two rows with distinct pages; page 0 is the garbage page.
    table = np.arange(1, 1 + 2 * pages_per_seq, dtype=np.int32).reshape(2, pages_per_seq)

    def step(tokens, ctx, new, last_only=False):
        nonlocal jk, jv
        jlog, jk, jv = jax_llama.forward(
            jparams, jcfg, jnp.asarray(tokens), jk, jv, jnp.asarray(table),
            jnp.asarray(ctx), jnp.asarray(new), last_only=last_only)
        tlog, tk2, tv2 = llama.forward(
            tparams, tcfg, torch.from_numpy(tokens), tk, tv, torch.from_numpy(table),
            torch.from_numpy(ctx), torch.from_numpy(new), last_only=last_only)
        assert tk2 is tk and tv2 is tv  # the caches are updated in place
        return np.asarray(jlog), tlog.numpy()

    # Chunk 1: a cold prefill (row 1 shorter, padded).
    seq1 = 2 * page + 2
    toks = rng.integers(0, jcfg.vocab_size, size=(2, seq1)).astype(np.int32)
    ctx = np.zeros(2, np.int32)
    new = np.array([seq1, seq1 - 5], np.int32)
    ref, got = step(toks, ctx, new)
    for b in range(2):
        assert_logits_close(got[b, :new[b]], ref[b, :new[b]])

    # Chunk 2 over the cached prefix, last-position logits only.
    ctx = ctx + new
    seq2 = page + 3
    toks = rng.integers(0, jcfg.vocab_size, size=(2, seq2)).astype(np.int32)
    new = np.array([seq2, 2], np.int32)
    ref, got = step(toks, ctx, new, last_only=True)
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert_logits_close(got, ref)
    # Everything both caches hold, outside the garbage page, agrees.
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               rtol=1e-5, atol=1e-5)

    # Decode: one live row and one padded row (new_len 0).
    ctx = ctx + new
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    new = np.array([1, 0], np.int32)
    ref, got = step(toks, ctx, new)
    assert_logits_close(got[:1], ref[:1])
    tlog, _, _ = llama.forward_decode(
        tparams, tcfg, torch.from_numpy(toks), tk, tv, torch.from_numpy(table),
        torch.from_numpy(ctx), torch.from_numpy(new))
    assert_logits_close(tlog.numpy()[:1], ref[:1])


def test_entry_points_agree_with_forward():
    jcfg, tcfg = configs(FP32)[0]
    tparams = llama.params_from_jax(
        jax_tree_to_numpy(jax_llama.init_params(jax.random.PRNGKey(1), jcfg)),
        tcfg, device="cpu")
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 8)))
    ctx, new = torch.zeros(1, dtype=torch.int32), torch.full((1,), 8, dtype=torch.int32)
    outs = []
    for fn, kw in ((llama.forward, {}), (llama.forward, {"plain_attention": True}),
                   (llama.forward_prefill, {})):
        k, v = llama.init_kv_cache(tcfg, 10, device="cpu")
        outs.append(fn(tparams, tcfg, toks, k, v, table, ctx, new, **kw)[0])
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="one token"):
        llama.forward_decode(tparams, tcfg, toks, k, v, table, ctx, new)


def test_params_from_jax_moves_bf16_bits_exactly():
    jcfg, tcfg = configs((jnp.bfloat16, torch.bfloat16))[0]
    tree = jax_tree_to_numpy(jax_llama.init_params(jax.random.PRNGKey(3), jcfg))
    got = llama.params_from_jax(tree, tcfg, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    assert got["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(got["embed"].view(torch.int16).numpy(),
                                  tree["embed"].view(np.int16))
    for name, leaf in tree["layers"][1].items():
        np.testing.assert_array_equal(
            got["layers"][1][name].float().numpy(), leaf.astype(np.float32))


def test_params_from_jax_refuses_layers_outside_the_dense_slice():
    jcfg, tcfg = configs(FP32)[0]
    tree = jax_tree_to_numpy(jax_llama.init_params(jax.random.PRNGKey(0), jcfg))
    tree["layers"][0]["q_norm"] = np.ones(16, np.float32)
    with pytest.raises(NotImplementedError, match="q_norm"):
        llama.params_from_jax(tree, tcfg, device="cpu")


def test_init_params_is_seeded_and_shaped_like_jax():
    jcfg, tcfg = configs(FP32)[0]
    a = llama.init_params(tcfg, seed=5, device="cpu")
    b = llama.init_params(tcfg, seed=5, device="cpu")
    ref = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), ref) == {
        "embed": tuple(a["embed"].shape), "final_norm": tuple(a["final_norm"].shape),
        "lm_head": tuple(a["lm_head"].shape),
        "layers": [{k: tuple(x.shape) for k, x in layer.items()}
                   for layer in a["layers"]]}
    torch.testing.assert_close(a["embed"], b["embed"], rtol=0, atol=0)
    assert float(a["embed"].abs().max()) <= 0.04 + 1e-6  # truncated at 2 sigma
