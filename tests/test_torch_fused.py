"""Fused projections in the port, against the JAX package.

- The layout transforms (``_interleave_concat``, ``_deinterleave_split``,
  ``split_fused_out``, ``fuse_params``, ``unfuse_params``) give, bit for
  bit, JAX's results at t = 1, 2 and 4 on the tiny GQA, Qwen2-bias, Qwen3,
  ``mixtral_tiny`` and a DeepSeek-router GQA trees; the MLA trees (with and
  without q-LoRA, and the tiny DeepSeek-V3 MoE) at t = 1, where both
  configs refuse t > 1 with JAX's message. Round trips give the original
  tree back; both marker refusals carry JAX's messages.
- ``fuse_profitable`` and ``maybe_fuse_params`` decide as JAX's at tp 1, 2
  and 4.
- (The forward on fused trees: ``tests/test_torch_fused_forward.py``.)
- The engine's gate (``EngineConfig.fuse_projections``) fuses, interleaves,
  re-lays a pre-fused tree out and refuses as JAX's engine does, for every
  (model, tp, fuse_projections) case: tp none, 1, 2, 4 and None / True /
  False over GQA models below, at and above the crossover and an MLA one.

Inputs come from numpy with a seed; weights are JAX trees carried across by
``params_from_jax``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.parallel import mesh as jax_mesh
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.parallel import mesh

from tests.test_torch_moe import DEEPSEEK, MIXTRAL
from tests.test_torch_swa import FAMILIES, Pair, config_pair, jax_params, prompts

MLA = dict(FAMILIES["tiny"], num_kv_heads=4, kv_lora_rank=16, qk_rope_head_dim=8)
# The DeepSeek-V3 router and shared expert over GQA attention: its dense
# layer 0, shared experts and attention all fuse at any interleave.
DEEPSEEK_GQA = dict(DEEPSEEK, num_kv_heads=2, kv_lora_rank=0, qk_rope_head_dim=0)
TREES = {"tiny": FAMILIES["tiny"], "bias": FAMILIES["tiny"], "qwen3": FAMILIES["qwen3"],
         "mixtral": MIXTRAL, "deepseek-gqa": DEEPSEEK_GQA, "mla": MLA, "mla-qlora": MLA,
         "deepseek": DEEPSEEK}
INTERLEAVED = ["tiny", "bias", "qwen3", "mixtral", "deepseek-gqa"]
CANONICAL_ONLY = ["mla", "mla-qlora", "deepseek"]


def tree_of(name, dtype=jnp.bfloat16, seed=0):
    """(JAX config, port config, the JAX ``init_params`` tree as numpy):
    Qwen2 biases, Qwen3 norms, a DeepSeek router's bias and an MLA
    checkpoint's q-LoRA and latent-norm leaves drawn from a seed, so that
    each leaf is carried and applied. Each call gets its own containers
    over the cached leaves."""
    jcfg, tcfg, tree = _tree_of(name, dtype, seed)
    return jcfg, tcfg, jax.tree_util.tree_map(lambda a: a, tree)


@functools.lru_cache(maxsize=None)
def _tree_of(name, dtype, seed):
    jcfg, tcfg = config_pair(TREES[name])
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32 if dtype == jnp.float32
                               else torch.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 11)

    def draw(shape, scale, like):
        return (rng.standard_normal(shape) * scale).astype(like)

    for layer in tree["layers"]:
        wdt = layer["wq"].dtype
        if name == "bias":
            for b, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
                layer[b] = draw(layer[w].shape[1], 0.05, wdt)
        if "q_norm" in layer:
            for k in ("q_norm", "k_norm"):
                layer[k] = (1.0 + draw(layer[k].shape, 0.3, np.float32)).astype(np.float32)
        if "router_bias" in layer:
            layer["router_bias"] = draw(layer["router_bias"].shape, 0.5, np.float32)
        if name == "mla-qlora":
            layer["latent_norm"] = (1.0 + draw(16, 0.3, np.float32)).astype(np.float32)
            layer["w_dq"] = draw((64, 32), 0.1, wdt)
            layer["q_latent_norm"] = (1.0 + draw(32, 0.3, np.float32)).astype(np.float32)
            layer["wq"] = draw((32, layer["wq"].shape[1]), 0.1, wdt)
    return jcfg, tcfg, tree


def bits(x):
    """A leaf's raw bits (bf16 has no numpy dtype on the torch side)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def assert_trees_bit_equal(got, want):
    """Every leaf of the port's tree bit-equal to the JAX tree's, the same
    keys on every level, the marker the same int."""
    assert set(got) == set(want)
    assert got.get("fused_interleave") == want.get("fused_interleave")
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
    assert len(got["layers"]) == len(want["layers"])
    for li, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert set(g) == set(w), li
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), (li, k)
            np.testing.assert_array_equal(bits(g[k]), bits(w[k]), err_msg=f"layer {li} {k}")


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def fused_pair(name, t, dtype=jnp.bfloat16, seed=0):
    """Both packages' configs at interleave ``t`` and their fused trees."""
    jcfg, tcfg, tree = tree_of(name, dtype, seed)
    jcfg = dataclasses.replace(jcfg, fused_interleave=t)
    tcfg = dataclasses.replace(tcfg, fused_interleave=t)
    return (jcfg, tcfg, tree, to_numpy(jax_llama.fuse_params(jax_params(tree), jcfg)),
            llama.fuse_params(llama.params_from_jax(tree, tcfg, device="cpu"), tcfg))


# ---------------------------------------------------------------------------
# The layout transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("name", INTERLEAVED)
def test_fuse_params_is_jaxs(name, t):
    _, _, _, want, got = fused_pair(name, t)
    assert_trees_bit_equal(got, want)
    assert want["fused_interleave"] == t


@pytest.mark.parametrize("name", CANONICAL_ONLY)
def test_fuse_params_of_mla_trees_is_jaxs(name):
    """Canonical order only: ``w_mla_in`` from ``wq`` (or q-LoRA's ``w_dq``,
    its ``wq`` kept over the normed q latent), ``w_dkv`` and ``w_kr``; a
    DeepSeek-V3 MoE's dense layer 0 fuses ``w_gate_up``, its expert layers
    only the shared expert."""
    _, _, tree, want, got = fused_pair(name, 1)
    assert_trees_bit_equal(got, want)
    keys = [set(layer) for layer in got["layers"]]
    assert all("w_mla_in" in k and "w_dkv" not in k for k in keys)
    assert all(("wq" in k) == (name == "mla-qlora") for k in keys)
    if name == "deepseek":
        assert "w_gate_up" in keys[0]
        assert all({"w_gate_up_sh", "w_gate", "w_up"} <= k and "w_gate_up" not in k
                   for k in keys[1:])


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("name", CANONICAL_ONLY)
def test_mla_refuses_an_interleave_as_jax(name, t):
    with pytest.raises(ValueError) as want:
        config_pair(TREES[name], fused_interleave=t)
    with pytest.raises(ValueError) as got:
        llama.LlamaConfig(**{k: v for k, v in TREES[name].items()
                             if k not in ("dtype", "fused_interleave")}, fused_interleave=t)
    assert str(got.value) == str(want.value) == (
        "fused_interleave > 1 is not supported for MLA configs")


def test_fused_interleave_below_one_is_refused_as_jax():
    with pytest.raises(ValueError) as want:
        jax_llama.LlamaConfig(**TREES["tiny"], fused_interleave=0)
    with pytest.raises(ValueError) as got:
        llama.LlamaConfig(**TREES["tiny"], fused_interleave=0)
    assert str(got.value) == str(want.value)


ROUND_TRIPS = [pytest.param(name, t, id=f"{name}-t{t}")
               for name in INTERLEAVED for t in (1, 2, 4)]
ROUND_TRIPS += [pytest.param(name, 1, id=f"{name}-t1") for name in CANONICAL_ONLY]


@pytest.mark.parametrize("name,t", ROUND_TRIPS)
def test_unfuse_params_is_jaxs_and_round_trips(name, t):
    jcfg, tcfg, tree, jfused, tfused = fused_pair(name, t)
    want = to_numpy(jax_llama.unfuse_params(jax_params(jfused), jcfg))
    got = llama.unfuse_params(tfused, tcfg)
    assert_trees_bit_equal(got, want)
    assert "fused_interleave" not in got
    assert_trees_bit_equal(got, tree)  # the original tree back
    # fuse_params on a fused tree changes nothing, the marker included.
    again = llama.fuse_params(tfused, dataclasses.replace(tcfg, fused_interleave=1))
    assert_trees_bit_equal(again, jfused)


@pytest.mark.parametrize("t", [1, 2, 4])
def test_split_and_interleave_helpers_are_jaxs(t):
    rng = np.random.default_rng(t)
    widths = (64, 32, 32)
    parts = [rng.standard_normal((8, n)).astype(np.float32) for n in widths]
    want = np.asarray(jax_llama._interleave_concat([jnp.asarray(p) for p in parts], t))
    got = llama._interleave_concat([torch.from_numpy(p) for p in parts], t)
    np.testing.assert_array_equal(got.numpy(), want)
    for g, w in zip(llama._deinterleave_split(got, widths, t),
                    jax_llama._deinterleave_split(jnp.asarray(want), widths, t)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bias = rng.standard_normal(128).astype(np.float32)
    np.testing.assert_array_equal(
        llama._interleave_concat([torch.from_numpy(bias)] * 2, t, axis=0).numpy(),
        np.asarray(jax_llama._interleave_concat([jnp.asarray(bias)] * 2, t, axis=0)))
    y = rng.standard_normal((2, 3, sum(widths))).astype(np.float32)
    for g, w in zip(llama.split_fused_out(torch.from_numpy(y), widths, t),
                    jax_llama.split_fused_out(jnp.asarray(y), widths, t)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_an_interleave_that_does_not_divide_a_width_is_refused_as_jax():
    parts = [np.zeros((4, 6), np.float32), np.zeros((4, 4), np.float32)]
    with pytest.raises(ValueError) as want:
        jax_llama._interleave_concat([jnp.asarray(p) for p in parts], 4)
    with pytest.raises(ValueError) as got:
        llama._interleave_concat([torch.from_numpy(p) for p in parts], 4)
    assert str(got.value) == str(want.value)


def test_unfuse_marker_refusals_match_jax():
    jcfg, tcfg, _, jfused, tfused = fused_pair("tiny", 2)
    cases = {
        "no marker": ({k: v for k, v in jfused.items() if k != "fused_interleave"},
                      {k: v for k, v in tfused.items() if k != "fused_interleave"}, 2),
        "mismatch": (jfused, tfused, 1),
    }
    for label, (jtree, ttree, t) in cases.items():
        with pytest.raises(ValueError) as want:
            jax_llama.unfuse_params(jax_params(jtree),
                                    dataclasses.replace(jcfg, fused_interleave=t))
        with pytest.raises(ValueError) as got:
            llama.unfuse_params(ttree, dataclasses.replace(tcfg, fused_interleave=t))
        assert str(got.value) == str(want.value), label
    # A canonical tree unfuses to itself, less any marker.
    _, _, tree = tree_of("tiny")
    plain = llama.params_from_jax(tree, tcfg, device="cpu")
    assert_trees_bit_equal(llama.unfuse_params(dict(plain, fused_interleave=3), tcfg), tree)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("hidden", [2048, 4096, 8192, 16384])
def test_fuse_profitable_and_maybe_fuse_are_jaxs(hidden, tp):
    kw = dict(FAMILIES["tiny"], hidden_size=hidden)
    jcfg, tcfg = jax_llama.LlamaConfig(**kw), llama.LlamaConfig(**kw)
    assert llama.fuse_profitable(tcfg, tp) == jax_llama.fuse_profitable(jcfg, tp)
    if tp == 1:
        tree = {"layers": [{"wq": torch.zeros(1, 4), "wk": torch.zeros(1, 2),
                            "wv": torch.zeros(1, 2)}]}
        fused = llama.maybe_fuse_params(tree, tcfg)
        assert ("w_qkv" in fused["layers"][0]) == jax_llama.fuse_profitable(jcfg)


def test_params_from_jax_takes_fused_trees_where_fuse_params_puts_them():
    for name in ("bias", "deepseek", "mla-qlora"):
        _, tcfg, _, jfused, _ = fused_pair(name, 1)
        got = llama.params_from_jax(jfused, tcfg, device="cpu")
        assert_trees_bit_equal(got, jfused)
    _, tcfg, _, jfused, _ = fused_pair("deepseek", 1)
    misplaced = to_numpy(jfused)
    misplaced["layers"][1]["w_gate_up"] = misplaced["layers"][0]["w_gate_up"]  # expert layer
    with pytest.raises(NotImplementedError, match="w_gate_up"):
        llama.params_from_jax(misplaced, tcfg, device="cpu")
    _, tcfg, tree, jfused, _ = fused_pair("tiny", 1)
    both = to_numpy(jfused)
    both["layers"][0]["wk"] = tree["layers"][0]["wk"]
    with pytest.raises(ValueError, match="beside the leaves they replace"):
        llama.params_from_jax(both, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# The engine's gate
# ---------------------------------------------------------------------------

GATE = dict(vocab_size=256, num_layers=1, num_heads=8, num_kv_heads=4, head_dim=16,
            intermediate_size=128, page_size=4)
GATE_MODELS = {"gqa-2048": dict(GATE, hidden_size=2048), "gqa-4096": dict(GATE, hidden_size=4096),
               "gqa-8192": dict(GATE, hidden_size=8192),
               "mla-4096": dict(GATE, hidden_size=4096, num_kv_heads=8, kv_lora_rank=16,
                                qk_rope_head_dim=8)}
GATE_ENGINE = dict(num_pages=8, max_pages_per_seq=2)


def group(rank, size):
    return mesh.TPGroup(rank=rank, size=size, process_group=None,
                        device=torch.device("cpu"), backend="gloo")


def jax_mesh_of(n):
    return jax_mesh.make_mesh({"tp": n}, jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def gate_tree(model):
    return to_numpy(jax_llama.init_params(jax.random.PRNGKey(0),
                                          config_pair(GATE_MODELS[model])[0]))


def gate_engines(model, tp, fuse, prefused=False):
    """JAX's engine and the port's (rank 0 of its group) over one tree, or
    the exception each raised."""
    jcfg, tcfg = config_pair(GATE_MODELS[model])
    tree = gate_tree(model)
    if prefused:
        tree = to_numpy(jax_llama.maybe_fuse_params(jax_params(tree), jcfg))
    out = []
    for build in (
            lambda: jax_engine.MiniEngine(
                jax_engine.EngineConfig(model=jcfg, fuse_projections=fuse, **GATE_ENGINE),
                params=jax_params(tree), mesh=None if tp is None else jax_mesh_of(tp)),
            lambda: engine.MiniEngine(
                engine.EngineConfig(model=tcfg, fuse_projections=fuse, **GATE_ENGINE),
                params=llama.params_from_jax(tree, tcfg, device="cpu"), device="cpu",
                tp=None if tp is None else group(0, tp))):
        try:
            out.append(build())
        except ValueError as exc:
            out.append(exc)
    assert tcfg.fused_interleave == 1  # the caller's config is not changed
    return out


def jax_shard0(eng):
    """The shard of each JAX leaf on the mesh's first device (the whole
    leaf without a mesh), as numpy."""
    def first(a):
        if eng.mesh is None:
            return np.asarray(a)
        device = eng.mesh.devices.flat[0]
        return next(np.asarray(s.data) for s in a.addressable_shards if s.device == device)

    return {k: (v if k == "fused_interleave" else jax.tree_util.tree_map(first, v))
            for k, v in eng.params.items()}


@pytest.mark.parametrize("fuse", [None, True, False], ids=["auto", "true", "false"])
@pytest.mark.parametrize("tp", [None, 1, 2, 4], ids=["no-mesh", "tp1", "tp2", "tp4"])
@pytest.mark.parametrize("model", list(GATE_MODELS))
def test_engine_gate_decides_as_jax(model, tp, fuse):
    """Fused or not, the interleave, rank 0's leaves bit-equal to JAX's
    shard on device 0, or the same refusal."""
    jeng, teng = gate_engines(model, tp, fuse)
    if isinstance(jeng, Exception):
        assert isinstance(teng, ValueError) and str(teng) == str(jeng)
        return
    assert not isinstance(teng, Exception), teng
    assert teng.cfg.model.fused_interleave == jeng.cfg.model.fused_interleave
    assert_trees_bit_equal(teng.params, jax_shard0(jeng))


@pytest.mark.parametrize("tp", [2, 4])
def test_engine_relays_a_prefused_tree_out_as_jax(tp):
    """A canonical tree pre-fused by ``maybe_fuse_params`` (hidden 8192) is
    unfused and fused again in the engine's interleaved order: rank 0 holds
    JAX's shard; served as it came, a rank's shard would straddle q/k/v."""
    jeng, teng = gate_engines("gqa-8192", tp, True, prefused=True)
    assert teng.params["fused_interleave"] == jeng.params["fused_interleave"] == tp
    assert_trees_bit_equal(teng.params, jax_shard0(jeng))


@pytest.mark.parametrize("fuse", [None, True])
def test_engines_with_fused_trees_serve_as_jax(fuse):
    """A hidden-4096 model (auto fuses) and the tiny model with fusion
    asked for: the port's engine streams equal JAX's on the padded and
    burst schedulers, the engine's tree fused."""
    family = dict(FAMILIES["tiny"], hidden_size=4096) if fuse is None else "tiny"
    for kw in ({}, {"decode_burst": 4}):
        pair = Pair(family, num_pages=64, max_batch=3, max_prefill_tokens=8,
                    fuse_projections=fuse, **kw)
        assert "w_qkv" in pair.port.params["layers"][0]
        reqs = [pair.both("enqueue", f"r{i}", p, max_new_tokens=5)
                for i, p in enumerate(prompts(8, (7, 3, 12)))]
        pair.run(reqs)
        pair.assert_same_events()
