"""Mixture-of-experts MLPs in the port, against the JAX package.

Both packages get the same weights (the JAX ``init_params`` tree through
``params_from_jax``, a DeepSeek router's bias made non-zero so that the
bias-corrected choice engages) and the same numpy inputs from a seed, at
fp32. Two configurations: ``mixtral_tiny`` (the softmax router, top 2 of
4, capacity dispatch) and a tiny DeepSeek-V3 (the sigmoid group-limited
router over 8 experts in 4 groups, top 2 within the best 2 groups, one
shared expert, layer 0 dense: ``tests/test_hf_loader.py``'s converted
config, built directly). Held here:

- the config checks' messages, ``mixtral_tiny``, ``init_params``' keys and
  shapes, and ``params_from_jax``'s refusals;
- ``_moe_router``, ``_moe_dense``, ``_moe_capacity`` (assignments dropping
  at capacity factor 0.5, padded positions masked by ``valid``) and
  ``_moe_deepseek`` (with and without ``norm_topk_prob``) against the JAX
  functions, rtol/atol 1e-5; exact router ties resolved to JAX's expert;
- ``forward`` logits within ``tests/test_torch_model.py``'s 1e-4 of the
  largest logit, and padded positions taking no capacity slot;
- the engines: token streams, ``cached_len`` and event bytes equal JAX's on
  the padded and burst schedulers for both models, and on the ragged one
  for ``mixtral_tiny`` at a capacity that binds, with the capacity taken
  from the flat length JAX pads to (a control engine taking it from the
  unpadded length gives other tokens);
- an MoE model under tensor parallelism splits its experts' inner width,
  and one whose width does not split raises JAX's ``ValueError``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.parallel.mesh import TPGroup

from tests.test_torch_swa import (
    Pair,
    assert_logits_close,
    chunked_steps,
    config_pair,
    jax_params,
    prompts,
    run_padded,
)

FN_TOL = dict(rtol=1e-5, atol=1e-5)
MIXTRAL = {k: v for k, v in dataclasses.asdict(jax_llama.LlamaConfig.mixtral_tiny()).items()
           if k not in ("dtype", "fused_interleave")}
# DeepSeek-V3 at the tiny size, as hf_loader converts tests/test_hf_loader.py's
# DeepseekV3Config (first_k_dense_replace 1: layer 0 dense).
DEEPSEEK = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=3,
                num_heads=4, num_kv_heads=4, head_dim=16, kv_lora_rank=16,
                qk_rope_head_dim=8, norm_eps=1e-5, rope_theta=10000.0, page_size=4,
                num_experts=8, num_experts_per_token=2, moe_dispatch="dense",
                moe_layers=(1, 2), n_shared_experts=1, moe_intermediate_size=32,
                moe_router=("deepseek_v3", 4, 2, 1, 2.5))
MODELS = {"mixtral": MIXTRAL, "mixtral-drops": dict(MIXTRAL, moe_capacity_factor=0.5),
          "qwen3-moe-unnormed": dict(MIXTRAL, moe_router=("softmax_topk", 0)),
          "deepseek": DEEPSEEK,
          "deepseek-unnormed": dict(DEEPSEEK, moe_router=("deepseek_v3", 4, 2, 0, 2.5))}


@functools.lru_cache(maxsize=None)
def _family_tree(family, seed):
    jcfg = config_pair(MODELS[family])[0]
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(seed),
                                                                    jcfg))
    rng = np.random.default_rng(seed + 7)
    for layer in tree["layers"]:
        if "router_bias" in layer:
            layer["router_bias"] = (rng.standard_normal(layer["router_bias"].shape)
                                    * 0.5).astype(np.float32)
    return tree


def moe_tree(jcfg, seed=0):
    """The JAX ``init_params`` tree as numpy (one tree a family and seed:
    the router and dispatch variants share its shapes); a DeepSeek router's
    bias drawn at 0.5 (the selection then differs from the unbiased
    scores')."""
    family = "deepseek" if jcfg.moe_router and jcfg.moe_router[0] == "deepseek_v3" else "mixtral"
    return jax.tree_util.tree_map(np.copy, _family_tree(family, seed))


def expert_layer(name, seed=0):
    """(JAX config, port config, the first expert layer as JAX arrays and as
    port tensors)."""
    jcfg, tcfg = config_pair(MODELS[name])
    tree = moe_tree(jcfg, seed)
    li = next(i for i, layer in enumerate(tree["layers"]) if "router" in layer)
    layer = tree["layers"][li]
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in layer.items()},
            llama.params_from_jax(tree, tcfg, device="cpu")["layers"][li])


def hidden(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# LlamaConfig, init_params, params_from_jax
# ---------------------------------------------------------------------------

BAD_CONFIGS = {
    "k-over-experts": dict(MIXTRAL, num_experts_per_token=5),
    "deepseek-capacity": dict(DEEPSEEK, moe_dispatch="capacity"),
    "groups-do-not-divide": dict(DEEPSEEK, moe_router=("deepseek_v3", 3, 2, 1, 2.5)),
    "one-expert-groups": dict(DEEPSEEK, moe_router=("deepseek_v3", 8, 2, 1, 2.5)),
    "router-form": dict(MIXTRAL, moe_router=("softmax_topk", 1, 2)),
    "router-kind": dict(MIXTRAL, moe_router=("sigmoid", 1)),
    "moe-layers-range": dict(DEEPSEEK, moe_layers=(1, 3)),
}


@pytest.mark.parametrize("fields", BAD_CONFIGS.values(), ids=BAD_CONFIGS)
def test_config_refusals_match_jax(fields):
    with pytest.raises(ValueError) as want:
        jax_llama.LlamaConfig(**fields)
    with pytest.raises(ValueError) as got:
        llama.LlamaConfig(**fields)
    assert str(got.value) == str(want.value)


def test_mixtral_tiny_is_jaxs():
    want = dataclasses.asdict(jax_llama.LlamaConfig.mixtral_tiny())
    got = dataclasses.asdict(llama.LlamaConfig.mixtral_tiny())
    want.pop("dtype"), got.pop("dtype")
    assert {k: v for k, v in want.items() if k in got} == got


@pytest.mark.parametrize("name", ["mixtral", "deepseek"])
def test_init_params_lays_out_experts_like_jax(name):
    jcfg, tcfg = config_pair(MODELS[name])
    ref = jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype)),
                                 jax_llama.init_params(jax.random.PRNGKey(0), jcfg))
    got = llama.init_params(tcfg, seed=1, device="cpu")

    def desc(t):
        return tuple(t.shape), str(t.dtype).removeprefix("torch.")

    assert [{k: desc(t) for k, t in layer.items()} for layer in got["layers"]] == ref["layers"]
    assert [tcfg.moe_layer(i) for i in range(tcfg.num_layers)] == [
        "router" in layer for layer in ref["layers"]]
    for layer in got["layers"]:
        if "router_bias" in layer:
            torch.testing.assert_close(layer["router_bias"], torch.zeros(8), rtol=0, atol=0)


def test_params_from_jax_takes_expert_leaves_on_expert_layers_only():
    jcfg, tcfg = config_pair(DEEPSEEK)
    tree = moe_tree(jcfg)
    got = llama.params_from_jax(tree, tcfg, device="cpu")
    for src, dst in zip(tree["layers"], got["layers"]):
        assert set(dst) == set(src)
        for name in src:
            np.testing.assert_array_equal(dst[name].numpy(), src[name])
    dense_router = moe_tree(jcfg)
    dense_router["layers"][0]["router"] = dense_router["layers"][1]["router"]
    with pytest.raises(NotImplementedError, match="router"):
        llama.params_from_jax(dense_router, tcfg, device="cpu")
    no_bias = moe_tree(jcfg)
    del no_bias["layers"][2]["router_bias"]
    with pytest.raises(ValueError, match="router_bias"):
        llama.params_from_jax(no_bias, tcfg, device="cpu")
    # The fused serving layout of the shared expert is carried on expert
    # layers, and refused on the dense layer, where fuse_params never puts it.
    fused = moe_tree(jcfg)
    layer = fused["layers"][1]
    layer["w_gate_up_sh"] = np.concatenate([layer.pop("w_gate_sh"), layer.pop("w_up_sh")], 1)
    np.testing.assert_array_equal(
        llama.params_from_jax(fused, tcfg, device="cpu")["layers"][1]["w_gate_up_sh"].numpy(),
        layer["w_gate_up_sh"])
    fused["layers"][0]["w_gate_up_sh"] = layer["w_gate_up_sh"]
    with pytest.raises(NotImplementedError, match="not in the ported slices"):
        llama.params_from_jax(fused, tcfg, device="cpu")
    # The softmax router's layers take no DeepSeek leaf.
    mcfg, mtcfg = config_pair(MIXTRAL)
    extra = moe_tree(mcfg)
    extra["layers"][0]["router_bias"] = np.zeros(4, np.float32)
    with pytest.raises(NotImplementedError, match="router_bias"):
        llama.params_from_jax(extra, mtcfg, device="cpu")


# ---------------------------------------------------------------------------
# The MoE functions
# ---------------------------------------------------------------------------

SOFTMAX_MODELS = ["mixtral", "mixtral-drops", "qwen3-moe-unnormed"]


@pytest.mark.parametrize("name", SOFTMAX_MODELS)
def test_router_matches_jax(name):
    jcfg, tcfg, jlayer, tlayer = expert_layer(name, seed=1)
    x = hidden(1, (2, 9, 64))
    want = jax_llama._moe_router(jnp.asarray(x), jlayer, jcfg, None)
    got = llama._moe_router(torch.from_numpy(x), tlayer, tcfg)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FN_TOL)


@pytest.mark.parametrize("name", ["mixtral", "qwen3-moe-unnormed"])
def test_dense_dispatch_matches_jax(name):
    jcfg, tcfg, jlayer, tlayer = expert_layer(name, seed=2)
    x = hidden(2, (2, 7, 64))
    want = jax_llama._moe_dense(jnp.asarray(x), jlayer, jcfg, None)
    got = llama._moe_dense(torch.from_numpy(x), tlayer, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("name", SOFTMAX_MODELS)
@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "padded"])
def test_capacity_dispatch_matches_jax(name, masked):
    jcfg, tcfg, jlayer, tlayer = expert_layer(name, seed=3)
    x = hidden(3, (2, 11, 64))
    valid = np.arange(11)[None, :] < np.array([[11], [6]]) if masked else None
    want = jax_llama._moe_capacity(jnp.asarray(x), jlayer, jcfg, None,
                                   valid=None if valid is None else jnp.asarray(valid))
    got = llama._moe_capacity(torch.from_numpy(x), tlayer, tcfg,
                              valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


def test_capacity_drops_assignments():
    """At capacity factor 0.5 some assignments drop: the capacity dispatch
    differs from the exact dense one, which it equals when nothing can drop
    (factor 2 with top 2 of 4: C = T, an expert's most)."""
    x = torch.from_numpy(hidden(4, (1, 16, 64)))
    outs = {}
    for name in ("mixtral-drops", "mixtral"):
        _, tcfg, _, tlayer = expert_layer(name, seed=4)
        outs[name] = (llama._moe_capacity(x, tlayer, tcfg), llama._moe_dense(x, tlayer, tcfg))
    torch.testing.assert_close(*outs["mixtral"], **FN_TOL)
    assert (outs["mixtral-drops"][0] - outs["mixtral-drops"][1]).abs().max() > 1e-3
    assert llama.moe_capacity(expert_layer("mixtral-drops")[1], 16) == 4


@pytest.mark.parametrize("name", ["deepseek", "deepseek-unnormed"])
def test_deepseek_matches_jax(name):
    jcfg, tcfg, jlayer, tlayer = expert_layer(name, seed=5)
    x = hidden(5, (2, 9, 64))
    want = jax_llama._moe_deepseek(jnp.asarray(x), jlayer, jcfg)
    got = llama._moe_deepseek(torch.from_numpy(x), tlayer, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


def exact_inputs(seed, tokens, columns):
    """Integer hidden states and a router of multiples of 1/64: every
    product and sum is exact in fp32, so equal columns score bit-equal in
    either package, whatever its summation order."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (1, tokens, 64)).astype(np.float32)
    router = (rng.integers(-8, 9, (64, columns)) / 64).astype(np.float32)
    return x, router


def test_softmax_router_tie_goes_to_jaxs_expert():
    """Experts 1 and 3 have equal router columns, so they tie on every
    token; where they share the second place, top 2 must take expert 1, as
    ``jax.lax.top_k`` does."""
    jcfg, tcfg, jlayer, tlayer = expert_layer("mixtral", seed=6)
    x, router = exact_inputs(6, 32, 4)
    router[:, 3] = router[:, 1]
    want = np.asarray(jax_llama._moe_router(jnp.asarray(x), dict(jlayer, router=jnp.asarray(
        router)), jcfg, None)[0])
    got = llama._moe_router(torch.from_numpy(x), dict(tlayer, router=torch.from_numpy(router)),
                            tcfg)[0].numpy()
    logits = (x @ router)[0]
    ranked = -np.sort(-logits, axis=-1)
    # Experts 1 and 3 alone share the second place: the tie decides the choice.
    boundary = ((ranked[:, 1] == logits[:, 1]) & (ranked[:, 0] > ranked[:, 1])
                & (ranked[:, 2] > ranked[:, 3]))
    assert boundary.sum() >= 3
    np.testing.assert_array_equal(got, want)
    assert set(want[0, boundary, 1].tolist()) == {1}


def test_deepseek_router_ties_go_to_jaxs_choice():
    """Experts 0-3 (groups 0 and 1) have equal router columns. Biases lift
    group 2 above them (expert 4 up, expert 5 down) and sink group 3, so
    groups 0 and 1 tie for the second group slot, and experts 0 and 1 for
    the second expert: JAX takes group 0 and expert 0. The bias moves only
    the choice (the weights are the unbiased scores), so nudging it towards
    expert 1 or group 1 shows what each tie decides."""
    jcfg, tcfg, jlayer, tlayer = expert_layer("deepseek", seed=7)
    x, router = exact_inputs(7, 8, 8)
    router[:, 1:4] = router[:, :1]
    bias = np.array([0, 0, 0, 0, 2.0, -1.0, -0.5, -0.5], np.float32)

    def port(b):
        layer = dict(tlayer, router=torch.from_numpy(router), router_bias=torch.from_numpy(b))
        return llama._moe_deepseek(torch.from_numpy(x), layer, tcfg)

    want = jax_llama._moe_deepseek(
        jnp.asarray(x), dict(jlayer, router=jnp.asarray(router), router_bias=jnp.asarray(bias)),
        jcfg)
    got = port(bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    for nudged in (1, 2):  # expert 1 over expert 0; group 1 over group 0
        b = bias.copy()
        b[nudged] += 1e-3
        assert (port(b) - got).abs().max() > 1e-6


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,chunk", [("mixtral", 16), ("mixtral-drops", 5),
                                        ("deepseek", 5)])
def test_forward_matches_jax(name, chunk):
    """Prefill chunks of two rows (one padded past its end) and a decode
    step with one live row, logits at the valid positions."""
    jcfg, tcfg = config_pair(MODELS[name])
    tree = moe_tree(jcfg, seed=chunk)
    table = np.arange(1, 33, dtype=np.int32).reshape(2, 16)
    rng = np.random.default_rng(chunk)
    (jk, jv), (tk, tv) = run_padded(jcfg, tcfg, tree, table,
                                    chunked_steps(rng, jcfg.vocab_size, (23, 14), chunk))
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)


def test_padded_positions_take_no_capacity():
    """A row's logits at its valid positions do not depend on what fills
    its padding (which would otherwise compete for expert slots), as JAX's
    ``test_padded_positions_cannot_steal_capacity`` holds."""
    _, tcfg = config_pair(dict(MIXTRAL, moe_capacity_factor=1.0))
    params = llama.init_params(tcfg, seed=0, device="cpu")
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    ctx, new = torch.zeros(1, dtype=torch.int32), torch.full((1,), 5, dtype=torch.int32)

    def run(pad):
        tokens = torch.full((1, 16), pad)
        tokens[0, :5] = torch.tensor([1, 2, 3, 4, 5])
        k, v = llama.init_kv_cache(tcfg, 8, device="cpu")
        return llama.forward(params, tcfg, tokens, k, v, table, ctx, new)[0][0, :5]

    torch.testing.assert_close(run(0), run(77), rtol=0, atol=0)


def test_decode_steps_match_jax():
    """``forward_decode_steps`` (frozen rows masked out of the capacity)
    against the JAX burst: tokens and pools."""
    jcfg, tcfg = config_pair(MODELS["mixtral-drops"])
    tree = moe_tree(jcfg, seed=8)
    jparams, tparams = jax_params(tree), llama.params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(8)
    table = np.arange(1, 49, dtype=np.int32).reshape(3, 16)
    lens = np.array([9, 14, 5], np.int32)
    pre = rng.integers(0, 256, (3, 16)).astype(np.int32)
    zeros = np.zeros(3, np.int32)
    jk, jv = jax_llama.init_kv_cache(jcfg, 60)
    tk, tv = llama.init_kv_cache(tcfg, 60, device="cpu")
    _, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(pre), jk, jv, jnp.asarray(table),
                                  jnp.asarray(zeros), jnp.asarray(lens))
    llama.forward(tparams, tcfg, torch.from_numpy(pre), tk, tv, torch.from_numpy(table),
                  torch.from_numpy(zeros), torch.from_numpy(lens))
    last = rng.integers(0, 256, 3).astype(np.int32)
    active = np.array([4, 1, 0], np.int32)
    jt, jk, jv = jax_llama.forward_decode_steps(
        jparams, jcfg, jnp.asarray(last), jk, jv, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(active), steps=4)
    tt = llama.forward_decode_steps(
        tparams, tcfg, torch.from_numpy(last).long(), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(active), 4)[0]
    for r in range(3):
        assert tt[r, :active[r]].tolist() == np.asarray(jt)[r, :active[r]].tolist()
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

ENGINE = dict(num_pages=96, max_batch=3, max_prefill_tokens=8)


@pytest.mark.parametrize("name", ["mixtral-drops", "deepseek"])
@pytest.mark.parametrize("scheduler", [{}, {"decode_burst": 4}], ids=["padded", "burst4"])
def test_engine_streams_and_events_match_jax(name, scheduler):
    """Three prompts on a shared prefix decoded to 5-7 tokens, then one
    more resuming the prefix: streams, cached lengths and events."""
    pair = Pair(MODELS[name], tree=moe_tree(config_pair(MODELS[name])[0]), **ENGINE,
                **scheduler)
    pair.run([pair.both("enqueue", f"r{i}", p, max_new_tokens=5 + i)
              for i, p in enumerate(prompts(11, (6, 2, 9)))])
    jr, tr = pair.both("add_request", "again", prompts(11, (6,))[0] + [1, 2], max_new_tokens=3)
    assert tr.cached_len == jr.cached_len >= 20
    pair.run([(jr, tr)])
    pair.assert_same_events()


def ragged_traffic(step, add_request, enqueue):
    """One request prefilled by ``add_request`` and decoding, a second
    enqueued beside it: its 4-token chunks ride beside the first one's
    decode row (5 flat tokens), then both decode (2). Every dispatch has 2
    rows and pads to JAX's 8 flat tokens: the JAX ragged kernel compiles
    (interpret mode) once. Returns the two requests once the second is
    done (the first still decoding)."""
    p0, p1 = prompts(12, (3, 14), prefix_len=5)
    r0 = add_request("r0", p0, max_new_tokens=40)
    r1 = enqueue("r1", p1, max_new_tokens=6)
    while not (r1[0] if isinstance(r1, tuple) else r1).done:
        step()
    return r0, r1


def test_ragged_engine_takes_jaxs_capacity(monkeypatch):
    """Both engines on the ragged scheduler at a capacity that binds (factor
    0.5: C = ceil(T / 4)). The dispatches' flat lengths (a decode row beside
    a 4-token chunk, two decode rows) fall short of 8, so JAX pads them and
    computes C from 8 (2 slots an expert); the port does not pad, and passes
    that length as the capacity's T: the streams, cached lengths and events
    equal JAX's at every step. A control engine whose capacity comes from
    the unpadded length (1 slot for two decode rows) drops other
    assignments and gives other tokens."""
    fields = MODELS["mixtral-drops"]
    pair = Pair(fields, tree=moe_tree(config_pair(fields)[0]), ragged_attention=True,
                num_pages=96, max_batch=2, max_prefill_tokens=4)
    flat = []
    inner = llama.forward_ragged

    def logged(params, cfg, tokens, *args, **kwargs):
        flat.append((tokens.shape[1], kwargs["capacity_tokens"]))
        return inner(params, cfg, tokens, *args, **kwargs)

    monkeypatch.setattr(engine, "forward_ragged", logged)
    (jr0, tr0), (jr1, tr1) = ragged_traffic(
        pair.step, lambda *a, **k: pair.both("add_request", *a, **k),
        lambda *a, **k: pair.both("enqueue", *a, **k))
    for jr, tr in ((jr0, tr0), (jr1, tr1)):
        assert (tr.output, tr.cached_len) == (jr.output, jr.cached_len)
    pair.assert_same_events()
    assert {5, 2} <= {t for t, _ in flat} and {pad for _, pad in flat} == {8}

    control = engine.MiniEngine(dataclasses.replace(pair.port.cfg), params=pair.port.params,
                                device="cpu")
    monkeypatch.setattr(engine, "jax_flat_bucket", lambda tokens: tokens)
    c0, c1 = ragged_traffic(control.step, control.add_request, control.enqueue)
    assert (c0.output, c1.output) != (jr0.output, jr1.output)


def test_tensor_parallel_refuses_moe():
    """Tensor parallelism takes an MoE model whose experts' inner width
    splits over the ranks (each rank holds its half of every expert), and
    refuses one whose width does not, with JAX's message."""
    group = TPGroup(rank=0, size=2, process_group=None, device=torch.device("cpu"),
                    backend="gloo")
    _, tcfg = config_pair(MIXTRAL)
    eng = engine.MiniEngine(engine.EngineConfig(model=tcfg, max_pages_per_seq=16),
                            device="cpu", tp=group)
    assert tuple(eng.params["layers"][0]["w_gate"].shape) == (4, 64, 64)
    assert tuple(eng.params["layers"][0]["w_down"].shape) == (4, 64, 64)
    _, odd = config_pair(dict(DEEPSEEK, moe_intermediate_size=33))
    with pytest.raises(ValueError, match=r"moe_intermediate_size \(33\) must divide by the "
                                         r"tp axis \(2\): Megatron shards are uniform"):
        engine.MiniEngine(engine.EngineConfig(model=odd, max_pages_per_seq=16), device="cpu",
                          tp=group)


def test_forward_logits_of_deepseek_match_jax_with_bias():
    """The router bias moves the choice: the port's logits follow JAX's with
    the bias and differ from the same tree with a zero bias."""
    jcfg, tcfg = config_pair(DEEPSEEK)
    tree = moe_tree(jcfg, seed=9)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 256, (1, 12)).astype(np.int32)
    table = np.arange(1, 5, dtype=np.int32)[None]
    ctx, new = np.zeros(1, np.int32), np.full(1, 12, np.int32)

    def port(t):
        k, v = llama.init_kv_cache(tcfg, 8, device="cpu")
        return llama.forward(llama.params_from_jax(t, tcfg, device="cpu"), tcfg,
                             torch.from_numpy(toks), k, v, torch.from_numpy(table),
                             torch.from_numpy(ctx), torch.from_numpy(new))[0].numpy()

    jk, jv = jax_llama.init_kv_cache(jcfg, 8)
    want = np.asarray(jax_llama.forward(jax_params(tree), jcfg, jnp.asarray(toks), jk, jv,
                                        jnp.asarray(table), jnp.asarray(ctx),
                                        jnp.asarray(new))[0])
    got = port(tree)
    assert_logits_close(got, want)
    unbiased = jax.tree_util.tree_map(lambda a: a, tree)
    for layer in unbiased["layers"]:
        if "router_bias" in layer:
            layer["router_bias"] = np.zeros_like(layer["router_bias"])
    assert np.abs(port(unbiased) - got).max() > 1e-4
