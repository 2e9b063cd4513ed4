"""Qwen3's QK-norm and Qwen2's QKV biases in the port, against the JAX package.

The JAX tree carries random QK-norm weights (not the ones ``init_params``
gives, so that applying them is visible) and random ``bq``/``bk``/``bv``;
``params_from_jax`` carries them across. At fp32, within
``tests/test_torch_model.py``'s 1e-4 of the largest logit, ``forward``
(prefill chunks and a decode step), ``forward_ragged`` and
``forward_decode_steps`` equal JAX's, and the engines' streams, ``cached_len``
and event bytes equal JAX's on the padded, ragged and burst schedulers.
``init_params`` lays out ``q_norm``/``k_norm`` as JAX does, and the tree
checks refuse a QK-norm config without its weights, biases that come
partly, and QK-norm weights on a config without ``qk_norm``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu_torch.models import llama

from tests.test_torch_swa import (
    TINY,
    Pair,
    assert_logits_close,
    chunked_steps,
    config_pair,
    jax_params,
    jax_tree,
    prompts,
    run_padded,
)

# (family, tree options): Qwen3 (QK-norm), Qwen2 (biases), both, and
# QK-norm under a sliding window.
VARIANTS = {
    "qwen3": ("qwen3", dict(norms=True)),
    "qwen2-biases": ("tiny", dict(biases=True)),
    "qwen3-biases": ("qwen3", dict(norms=True, biases=True)),
    "qwen3-swa": (dict(TINY, qk_norm=True, sliding_window=8, swa_layers=(0, 1)),
                  dict(norms=True)),
}


@pytest.mark.parametrize("family,tree_kw", VARIANTS.values(), ids=VARIANTS)
@pytest.mark.parametrize("chunk", [5, 32])
def test_forward_matches_jax(family, tree_kw, chunk):
    jcfg, tcfg = config_pair(family)
    tree = jax_tree(jcfg, seed=chunk, **tree_kw)
    table = np.arange(1, 33, dtype=np.int32).reshape(2, 16)
    rng = np.random.default_rng(chunk)
    (jk, jv), (tk, tv) = run_padded(jcfg, tcfg, tree, table,
                                    chunked_steps(rng, jcfg.vocab_size, (23, 14), chunk))
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family,tree_kw", VARIANTS.values(), ids=VARIANTS)
def test_norms_and_biases_are_applied(family, tree_kw):
    """Dropping the QK-norm weights (back to ones) or the biases moves the
    logits: the port reads every leaf it was given."""
    jcfg, tcfg = config_pair(family)
    tree = jax_tree(jcfg, seed=3, **tree_kw)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, 12)))
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    ctx, new = torch.zeros(1, dtype=torch.int32), torch.full((1,), 12, dtype=torch.int32)

    def logits(t):
        k, v = llama.init_kv_cache(tcfg, 6, device="cpu")
        return llama.forward(llama.params_from_jax(t, tcfg, device="cpu"), tcfg, toks, k, v,
                             table, ctx, new)[0]

    base = logits(tree)
    for layer in tree["layers"]:
        for name in ("q_norm", "k_norm"):
            if name in layer:
                layer[name] = np.ones_like(layer[name])
        for name in ("bq", "bk", "bv"):
            layer.pop(name, None)
    assert (logits(tree) - base).abs().max() > 1e-4


@pytest.mark.parametrize("family,tree_kw", VARIANTS.values(), ids=VARIANTS)
def test_forward_ragged_matches_jax(family, tree_kw):
    """Two decode rows beside a 7-token chunk over a cached prefix, against
    the JAX ``forward_ragged`` (Pallas ragged kernel in interpret mode)."""
    jcfg, tcfg = config_pair(family)
    tree = jax_tree(jcfg, seed=4, **tree_kw)
    rng = np.random.default_rng(4)
    q_lens, ctx = [1, 7, 1], np.array([9, 5, 14], np.int32)
    tables = np.arange(1, 25, dtype=np.int32).reshape(3, 8)
    tables = np.concatenate([tables, np.zeros((3, 8), np.int32)], axis=1)
    jparams, tparams = jax_params(tree), llama.params_from_jax(tree, tcfg, device="cpu")
    jk, jv = jax_llama.init_kv_cache(jcfg, 25)
    tk, tv = llama.init_kv_cache(tcfg, 25, device="cpu")
    pre = rng.integers(0, 256, (3, 16)).astype(np.int32)
    zeros = np.zeros(3, np.int32)
    _, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(pre), jk, jv, jnp.asarray(tables),
                                  jnp.asarray(zeros), jnp.asarray(ctx))
    llama.forward(tparams, tcfg, torch.from_numpy(pre), tk, tv, torch.from_numpy(tables),
                  torch.from_numpy(zeros), torch.from_numpy(ctx))
    starts = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    flat = np.zeros((1, 16), np.int32)
    flat[0, :starts[-1]] = rng.integers(0, 256, starts[-1])
    jlog, _, _ = jax_llama.forward_ragged(
        jparams, jcfg, jnp.asarray(flat), jk, jv, jnp.asarray(tables), jnp.asarray(starts),
        jnp.asarray(ctx), interpret=True)
    tlog = llama.forward_ragged(tparams, tcfg, torch.from_numpy(flat), tk, tv,
                                torch.from_numpy(tables), torch.from_numpy(starts),
                                torch.from_numpy(ctx))[0].numpy()
    assert_logits_close(tlog, np.asarray(jlog))


@pytest.mark.parametrize("family,tree_kw", VARIANTS.values(), ids=VARIANTS)
def test_decode_steps_match_jax(family, tree_kw):
    jcfg, tcfg = config_pair(family)
    tree = jax_tree(jcfg, seed=5, **tree_kw)
    rng = np.random.default_rng(5)
    table = np.arange(1, 33, dtype=np.int32).reshape(2, 16)
    lens = np.array([10, 4], np.int32)
    prompt = rng.integers(0, 256, (2, 10)).astype(np.int32)
    jparams, tparams = jax_params(tree), llama.params_from_jax(tree, tcfg, device="cpu")
    jk, jv = jax_llama.init_kv_cache(jcfg, 34)
    tk, tv = llama.init_kv_cache(tcfg, 34, device="cpu")
    zeros = np.zeros(2, np.int32)
    _, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(prompt), jk, jv,
                                  jnp.asarray(table), jnp.asarray(zeros), jnp.asarray(lens))
    llama.forward(tparams, tcfg, torch.from_numpy(prompt), tk, tv, torch.from_numpy(table),
                  torch.from_numpy(zeros), torch.from_numpy(lens))
    last, active = np.array([3, 4], np.int32), np.array([6, 2], np.int32)
    jt, jk, _ = jax_llama.forward_decode_steps(
        jparams, jcfg, jnp.asarray(last), jk, jv, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(active), 6)
    tt = llama.forward_decode_steps(
        tparams, tcfg, torch.from_numpy(last), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(active), 6)[0].numpy()
    for r in range(2):
        assert tt[r, :active[r]].tolist() == np.asarray(jt)[r, :active[r]].tolist()
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)


SCHEDULERS = {
    "padded": {},
    "ragged": {"port_kw": {"ragged_attention": True}},
    "burst4": {"decode_burst": 4},
}


@pytest.mark.parametrize("variant", ["qwen3", "qwen2-biases"])
@pytest.mark.parametrize("scheduler", SCHEDULERS.values(), ids=SCHEDULERS)
def test_engine_streams_and_events_match_jax(variant, scheduler):
    family, tree_kw = VARIANTS[variant]
    pair = Pair(family, tree_kw=tree_kw, num_pages=96, max_batch=3, max_prefill_tokens=8,
                **scheduler)
    reqs = [pair.both("enqueue", f"r{i}", p, max_new_tokens=5 + i)
            for i, p in enumerate(prompts(11, (6, 2, 9)))]
    pair.run(reqs)
    jr, tr = pair.both("add_request", "again", prompts(11, (6,))[0] + [1, 2], max_new_tokens=3)
    assert tr.cached_len == jr.cached_len >= 20
    pair.run([(jr, tr)])
    pair.assert_same_events()


def test_init_params_lays_out_qk_norm_like_jax():
    jcfg, tcfg = config_pair("qwen3")
    ref = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    got = llama.init_params(tcfg, seed=1, device="cpu")
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), ref) == {
        "embed": tuple(got["embed"].shape), "final_norm": tuple(got["final_norm"].shape),
        "lm_head": tuple(got["lm_head"].shape),
        "layers": [{k: tuple(x.shape) for k, x in layer.items()} for layer in got["layers"]]}
    for layer in got["layers"]:
        assert layer["q_norm"].dtype == torch.float32
        torch.testing.assert_close(layer["k_norm"], torch.ones(16), rtol=0, atol=0)


def test_params_from_jax_carries_norms_and_biases_bit_exactly():
    jcfg, tcfg = config_pair("qwen3")
    tree = jax_tree(jcfg, seed=2, norms=True, biases=True)
    got = llama.params_from_jax(tree, tcfg, device="cpu")
    for src, dst in zip(tree["layers"], got["layers"]):
        for name in ("q_norm", "k_norm", "bq", "bk", "bv"):
            np.testing.assert_array_equal(dst[name].numpy(), src[name])


def test_params_from_jax_refuses_incomplete_trees():
    jcfg, tcfg = config_pair("qwen3")
    tree = jax_tree(jcfg)
    del tree["layers"][1]["k_norm"]
    with pytest.raises(ValueError, match="q_norm and k_norm"):
        llama.params_from_jax(tree, tcfg, device="cpu")
    jcfg, tcfg = config_pair("tiny")
    tree = jax_tree(jcfg, biases=True)
    del tree["layers"][0]["bv"]
    with pytest.raises(ValueError, match="bq, bk and bv"):
        llama.params_from_jax(tree, tcfg, device="cpu")
    tree = jax_tree(config_pair("qwen3")[0])
    with pytest.raises(NotImplementedError, match="k_norm"):
        llama.params_from_jax(tree, tcfg, device="cpu")
