"""The port's tensor-parallel serving against the JAX package.

- (i) ``parallel.serve.validate_tp_config`` raises the JAX errors, with the
  JAX messages, on the configs of ``tests/test_tp_serve.py`` and on uneven
  Megatron widths; ``mesh_tp_size`` and ``mesh_fingerprint_fields`` give
  the JAX values.
- (ii) For tp 2 and 4, each rank's ``shard_params`` equals, bit for bit,
  the shard JAX's ``shard_params(make_mesh({"tp": n}), tree)`` places on
  device r, for the dense, QKV-bias, QK-norm and MLA trees; so does
  ``shard_kv_pool`` of a GQA pool and of an MLA latent pool (whole).
- (iii) The two sharded wrappers (their CPU path: the plain versions), run
  for rank 0 and rank 1 on the rank's operands and concatenated on the head
  axis, equal JAX's ``sharded_paged_decode_attention`` /
  ``sharded_paged_prefill_attention`` on the 8-device CPU mesh (Pallas in
  interpret mode): GQA, the replicated single-head ``shared_kv`` pool, SWA
  with sinks and the decode tail. Local head counts that do not match the
  group raise.
- (iv) A spawned gloo pair on the CPU (its ranks: ``test_torch_tp_ranks``)
  serves the tp tiny GQA and MLA configs of ``tests/test_tp_serve.py`` at
  fp32: the tokens equal JAX's tp
  2 engine's (``use_pallas_decode=True``) and the port's tp 1 engine's,
  rank 0's events equal the tp 1 engine's and rank 1 emits none, and the
  MLA latent pools are bit-equal across the ranks.
- (v) Every combination tensor-parallel serving refuses raises.

Inputs come from numpy with a seed; weights are the JAX tree carried over
by ``params_from_jax``. Attention compares at fp32 within 1e-5 (only the
summation order differs).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.ops.pallas_paged_attention import (
    sharded_paged_decode_attention as jax_sharded_decode,
)
from llmd_kv_cache_tpu.ops.pallas_paged_attention import (
    sharded_paged_prefill_attention as jax_sharded_prefill,
)
from llmd_kv_cache_tpu.parallel import mesh as jax_mesh
from llmd_kv_cache_tpu.parallel import serve as jax_serve
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops
from llmd_kv_cache_tpu_torch.parallel import mesh, serve

from test_torch_attention import make_table, t
from test_torch_engine import normalize
from test_torch_tp_ranks import ENGINE, serve_rank, traffic

ATTN_TOL = 1e-5

# tests/test_tp_serve.py:35-41 and :137-142.
GQA_TP = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
              head_dim=16, intermediate_size=128, page_size=4)
MLA_TP = dict(GQA_TP, num_kv_heads=4, kv_lora_rank=16, qk_rope_head_dim=8)


def jax_mesh_of(n):
    return jax_mesh.make_mesh({"tp": n}, jax.devices()[:n])


def group(rank, size):
    """A rank's group on the CPU, never joined: shapes and checks only."""
    return mesh.TPGroup(rank=rank, size=size, process_group=None,
                        device=torch.device("cpu"), backend="gloo")


def configs(**kw):
    return jax_llama.LlamaConfig(**kw), llama.LlamaConfig(**kw)


# --------------------------------------------------------------------------
# (i) validation
# --------------------------------------------------------------------------

VALIDATE = [
    pytest.param(dict(GQA_TP, num_heads=6, num_kv_heads=6, kv_lora_rank=16,
                      qk_rope_head_dim=8), 4, id="mla-num-heads"),  # test_tp_serve.py:195
    pytest.param(dict(GQA_TP), 4, id="num-kv-heads"),  # LlamaConfig.tiny(), :207
    pytest.param(dict(GQA_TP, intermediate_size=130), 4, id="gqa-width"),
    pytest.param(dict(MLA_TP, intermediate_size=130), 4, id="mla-width"),
    pytest.param(dict(GQA_TP), 2, id="gqa-ok"),
    pytest.param(dict(MLA_TP), 4, id="mla-ok"),
]


@pytest.mark.parametrize("kw,tp", VALIDATE)
def test_validate_tp_config_matches_jax(kw, tp):
    jcfg, tcfg = configs(**kw)
    try:
        jax_serve.validate_tp_config(jcfg, jax_mesh_of(tp))
        want = None
    except ValueError as exc:
        want = str(exc)
    if want is None:
        serve.validate_tp_config(tcfg, group(0, tp))
    else:
        with pytest.raises(ValueError) as got:
            serve.validate_tp_config(tcfg, group(0, tp))
        assert str(got.value) == want


def test_tp_size_and_fingerprint_match_jax():
    assert serve.mesh_tp_size(None) == jax_serve.mesh_tp_size(None) == 1
    for n in (1, 2, 4):
        assert serve.mesh_tp_size(group(0, n)) == jax_serve.mesh_tp_size(jax_mesh_of(n))
        assert mesh.mesh_fingerprint_fields(n) == jax_mesh.mesh_fingerprint_fields(
            jax_mesh_of(n))
    assert mesh.mesh_fingerprint_fields() == jax_mesh.mesh_fingerprint_fields(None)


# --------------------------------------------------------------------------
# (ii) the Megatron shards
# --------------------------------------------------------------------------

def _tree(kind):
    """A JAX tree of one layer family (bf16 projections) as numpy leaves."""
    rng = np.random.default_rng(7)
    kw = {"dense": GQA_TP, "bias": GQA_TP, "qk_norm": dict(GQA_TP, qk_norm=True),
          "mla": MLA_TP}[kind]
    jcfg, tcfg = configs(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(1), jcfg))
    for layer in tree["layers"]:
        if kind == "bias":
            for name, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
                layer[name] = rng.normal(size=layer[w].shape[1]).astype(layer[w].dtype)
        if kind == "qk_norm":  # perturbed, so a wrong slice would show
            for name in ("q_norm", "k_norm"):
                layer[name] = rng.uniform(0.5, 1.5, layer[name].shape).astype(np.float32)
        if kind == "mla":  # a checkpoint's latent_norm and q-LoRA leaves
            layer["latent_norm"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
            layer["w_dq"] = rng.normal(size=(64, 32)).astype(layer["wq"].dtype)
            layer["q_latent_norm"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
            layer["wq"] = rng.normal(size=(32, layer["wq"].shape[1])).astype(layer["wq"].dtype)
    return tree, tcfg


def _bits(x):
    """A leaf's raw bits (bf16 has no numpy dtype on the torch side)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "bias", "qk_norm", "mla"])
def test_shard_params_equal_jax_shards(kind, tp):
    tree, tcfg = _tree(kind)
    jmesh = jax_mesh_of(tp)
    placed = jax_mesh.shard_params(jmesh, jax.tree_util.tree_map(jnp.asarray, tree))
    full = llama.params_from_jax(tree, tcfg, device="cpu")
    for r in range(tp):
        device = jmesh.devices.flat[r]
        mine = mesh.shard_params(full, group(r, tp))
        want = jax.tree_util.tree_map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == device), placed)
        assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, mine))
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree_util.tree_leaves(mine)):
            assert tuple(g.shape) == w.shape, path
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))


@pytest.mark.parametrize("kind", ["dense", "mla"])
def test_shard_params_places_the_shard_on_the_group_device(kind):
    """A full tree on the host: every leaf of the rank's shard lands on the
    group's device (``meta`` here, standing in for a card), a copy of the
    host shard's shape; on the host device the sharded leaves are copies
    that share no storage with the full tree."""
    tree, tcfg = _tree(kind)
    full = llama.params_from_jax(tree, tcfg, device="cpu")
    axes = {k: v for k, v in mesh.param_split_axes().items() if k != "layers"}
    host = mesh.shard_params(full, group(1, 2))
    placed = mesh.shard_params(full, mesh.TPGroup(rank=1, size=2, process_group=None,
                                                  device=torch.device("meta"),
                                                  backend="gloo"))
    for got, want in zip(jax.tree_util.tree_leaves(placed), jax.tree_util.tree_leaves(host)):
        assert got.device.type == "meta" and got.shape == want.shape
    full_ptrs = {x.untyped_storage().data_ptr() for x in jax.tree_util.tree_leaves(full)}
    for k, axis in axes.items():
        assert (host[k].untyped_storage().data_ptr() in full_ptrs) == (axis is None), k
    for layer, whole in zip(host["layers"], full["layers"]):
        layer_axes = mesh.param_split_axes(**mesh._layer_flags(whole))["layers"]
        for k, x in layer.items():
            shared = x.untyped_storage().data_ptr() == whole[k].untyped_storage().data_ptr()
            assert shared == (layer_axes[k] is None), k


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kw", [GQA_TP, MLA_TP], ids=["gqa", "mla"])
def test_shard_kv_pool_equals_jax(kw, tp):
    kw = dict(kw, num_kv_heads=4)
    jcfg, tcfg = configs(**kw)
    rng = np.random.default_rng(tp)
    jk, jv = jax_llama.init_kv_cache(jcfg, 6)
    k = rng.normal(size=jk.shape).astype(np.float32)
    v = rng.normal(size=jv.shape).astype(np.float32)
    jmesh = jax_mesh_of(tp)
    pk, pv = jax_serve.shard_kv_pool(jmesh, jnp.asarray(k), jnp.asarray(v))
    for r in range(tp):
        device = jmesh.devices.flat[r]
        gk, gv = serve.shard_kv_pool(group(r, tp), t(k), t(v))
        for got, placed in ((gk, pk), (gv, pv)):
            want = next(np.asarray(s.data) for s in placed.addressable_shards
                        if s.device == device)
            np.testing.assert_array_equal(got.numpy(), want)
        local = llama.init_kv_cache(tcfg, 6, device="cpu", tp_size=tp)
        assert tuple(local[0].shape) == tuple(gk.shape)
        assert tuple(local[1].shape) == tuple(gv.shape)


# --------------------------------------------------------------------------
# (iii) the sharded wrappers
# --------------------------------------------------------------------------

def attention_case(q_heads, kv_heads, width, q_seq=None, seed=0, tail=0):
    """Three rows over page-crossing contexts: q ``[b, heads, width]`` (or
    ``[b, q_seq, heads, width]``), pools of random pages, a table, the
    rows' contexts and, with ``tail``, a decode-burst tail of that many
    slots with 0, 1 and ``tail`` valid tokens."""
    rng = np.random.default_rng(seed)
    page, pages_per_seq = 4, 6
    lens = [13, 5, 19]
    num_pages = 1 + len(lens) * pages_per_seq
    shape = (num_pages, kv_heads, page, width)
    k, v = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    table = make_table(rng, [pages_per_seq * page] * len(lens), pages_per_seq, page, num_pages)
    q_shape = (len(lens), q_heads, width) if q_seq is None else (len(lens), q_seq, q_heads,
                                                                  width)
    q = rng.normal(size=q_shape).astype(np.float32)
    out = dict(q=q, k=k, v=v, table=table, ctx=np.array(lens, np.int32))
    if tail:
        out["tail_k"] = rng.normal(size=(len(lens), tail, kv_heads, width)).astype(np.float32)
        out["tail_v"] = rng.normal(size=(len(lens), tail, kv_heads, width)).astype(np.float32)
        out["tail_lens"] = np.array([0, 1, tail], np.int32)
    return out


def rank_slice(a, axis, rank, tp):
    """Rank ``rank``'s heads of axis ``axis`` (a single head stays whole)."""
    if a.shape[axis] == 1:
        return a
    n = a.shape[axis] // tp
    return np.take(a, range(rank * n, (rank + 1) * n), axis=axis)


DECODE_CASES = [
    pytest.param(4, 2, 16, {}, 0, False, id="gqa"),
    pytest.param(4, 2, 16, dict(sliding_window=6, sinks=3), 0, False, id="gqa-swa-sinks"),
    pytest.param(4, 2, 16, {}, 5, False, id="gqa-tail"),
    pytest.param(4, 1, 24, {}, 0, True, id="shared-kv"),
    pytest.param(4, 1, 24, dict(sliding_window=6, sinks=3), 5, True, id="shared-kv-swa-tail"),
]


@pytest.mark.parametrize("q_heads,kv_heads,width,window,tail,shared", DECODE_CASES)
def test_sharded_decode_matches_jax(q_heads, kv_heads, width, window, tail, shared):
    c = attention_case(q_heads, kv_heads, width, tail=tail)
    tp, before = 2, ops.sharded_paged_decode_attention.launches
    v = c["k"] if shared else c["v"]
    tails = {}
    if tail:
        tails = dict(tail_k=c["tail_k"], tail_v=c["tail_k"] if shared else c["tail_v"],
                     tail_lens=c["tail_lens"])
    outs = []
    for r in range(tp):
        local = {k: t(rank_slice(a, 2, r, tp)) for k, a in tails.items() if k != "tail_lens"}
        if tail:
            local["tail_lens"] = t(c["tail_lens"])
        outs.append(ops.sharded_paged_decode_attention(
            group(r, tp), t(rank_slice(c["q"], 1, r, tp)), t(rank_slice(c["k"], 1, r, tp)),
            t(rank_slice(v, 1, r, tp)), t(c["table"]), t(c["ctx"]), q_heads=q_heads,
            kv_heads=kv_heads, shared_kv=shared, **window, **local).numpy())
    assert ops.sharded_paged_decode_attention.launches == before  # CPU: plain, no launch
    ref = np.asarray(jax_sharded_decode(
        jax_mesh_of(tp), jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(v),
        jnp.asarray(c["table"]), jnp.asarray(c["ctx"]), shared_kv=shared, interpret=True,
        **window, **{k: jnp.asarray(a) for k, a in tails.items()}))
    np.testing.assert_allclose(np.concatenate(outs, axis=1), ref, atol=ATTN_TOL, rtol=ATTN_TOL)


PREFILL_CASES = [
    pytest.param(4, 2, 16, {}, False, id="gqa"),
    pytest.param(4, 2, 16, dict(sliding_window=6, sinks=3), False, id="gqa-swa-sinks"),
    pytest.param(4, 1, 24, {}, True, id="shared-kv"),
]


@pytest.mark.parametrize("q_heads,kv_heads,width,window,shared", PREFILL_CASES)
def test_sharded_prefill_matches_jax(q_heads, kv_heads, width, window, shared):
    c = attention_case(q_heads, kv_heads, width, q_seq=4, seed=1)
    tp, before = 2, ops.sharded_paged_prefill_attention.launches
    ctx, total = c["ctx"] - 4, c["ctx"]  # 4 new tokens over each row's prefix
    v = c["k"] if shared else c["v"]
    outs = [ops.sharded_paged_prefill_attention(
        group(r, tp), t(rank_slice(c["q"], 2, r, tp)), t(rank_slice(c["k"], 1, r, tp)),
        t(rank_slice(v, 1, r, tp)), t(c["table"]), t(ctx), t(total), q_heads=q_heads,
        kv_heads=kv_heads, shared_kv=shared, **window).numpy() for r in range(tp)]
    assert ops.sharded_paged_prefill_attention.launches == before
    ref = np.asarray(jax_sharded_prefill(
        jax_mesh_of(tp), jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(v),
        jnp.asarray(c["table"]), jnp.asarray(ctx), jnp.asarray(total), q_tile=4,
        shared_kv=shared, interpret=True, **window))
    np.testing.assert_allclose(np.concatenate(outs, axis=2), ref, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("q_heads_local,pool_heads,kv_heads,match", [
    pytest.param(4, 1, 2, "2 of 4 query heads", id="unsharded-q"),
    pytest.param(2, 2, 2, "1 of 2 kv heads", id="unsharded-pool"),
    pytest.param(2, 1, 4, "2 of 4 kv heads", id="pool-of-one-for-gqa"),
    pytest.param(2, 2, 3, "do not split into 2 ranks", id="uneven"),
])
def test_sharded_wrappers_check_local_heads(q_heads_local, pool_heads, kv_heads, match):
    c = attention_case(q_heads_local, pool_heads, 16)
    args = (t(c["q"]), t(c["k"]), t(c["v"]), t(c["table"]), t(c["ctx"]))
    with pytest.raises(ValueError, match=match):
        ops.sharded_paged_decode_attention(group(0, 2), *args, q_heads=4, kv_heads=kv_heads)
    q4 = t(c["q"][:, None])
    with pytest.raises(ValueError, match=match):
        ops.sharded_paged_prefill_attention(group(1, 2), q4, *args[1:], t(c["ctx"]),
                                            q_heads=4, kv_heads=kv_heads)


# --------------------------------------------------------------------------
# (iv) a gloo pair on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [GQA_TP, MLA_TP], ids=["gqa", "mla"])
def test_gloo_pair_serves_like_jax_and_tp1(kw):
    jcfg = jax_llama.LlamaConfig(**kw, dtype=jnp.float32)
    jparams = jax_llama.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    # The pair runs (a thread waits on it) while this process serves JAX's
    # tp 2 engine and the port's tp 1 engine.
    with concurrent.futures.ThreadPoolExecutor(1) as waiter:
        pair = waiter.submit(mesh.spawn_tp, serve_rank, 2, backend="gloo",
                             devices=["cpu", "cpu"], args=(kw, tree), timeout_s=240,
                             collective_timeout_s=120)
        jax_eng = jax_engine.MiniEngine(
            jax_engine.EngineConfig(model=jcfg, use_pallas_decode=True, **ENGINE),
            params=jparams, mesh=jax_mesh_of(2))
        jax_outs = traffic(jax_eng)
        tcfg = llama.LlamaConfig(**kw, dtype=torch.float32)
        events = []
        tp1 = engine.MiniEngine(engine.EngineConfig(model=tcfg, **ENGINE),
                                event_sink=events.extend,
                                params=llama.params_from_jax(tree, tcfg, device="cpu"),
                                device="cpu")
        tp1_outs = traffic(tp1)
        rank0, rank1 = pair.result()  # spawn_tp's own deadline bounds the wait
    assert rank0["outs"] == rank1["outs"] == tp1_outs == jax_outs
    assert any(cached for _, cached in list(tp1_outs.values())[1:])  # a prefix was reused
    assert normalize(rank0["events"]) == normalize(events) and rank1["events"] == []
    if kw is MLA_TP:  # the latent is computed whole on every rank
        assert rank0["k_heads"] == 1
        np.testing.assert_array_equal(rank0["k_cache"], rank1["k_cache"])
    else:
        assert rank0["k_heads"] == rank1["k_heads"] == kw["num_kv_heads"] // 2


# --------------------------------------------------------------------------
# (v) refusals
# --------------------------------------------------------------------------

REFUSED = [
    pytest.param({}, dict(ragged_attention=True), "ragged_attention=True", id="ragged"),
    pytest.param({}, dict(decode_burst=4), "decode_burst=4", id="burst"),
    pytest.param(dict(sliding_window=8, swa_layers=(1,)), {}, "hybrid", id="hybrid"),
    pytest.param({}, dict(kv_cache_dtype="f8_e4m3"), "kv_cache_dtype='f8_e4m3'", id="fp8"),
]


@pytest.mark.parametrize("model_kw,engine_kw,match", REFUSED)
def test_tp_refusals(model_kw, engine_kw, match):
    cfg = llama.LlamaConfig(**GQA_TP, **model_kw)
    with pytest.raises(ValueError, match=f"tensor-parallel serving \\(tp=2\\).*{match}"):
        engine.MiniEngine(engine.EngineConfig(model=cfg, num_pages=16, max_pages_per_seq=4,
                                              **engine_kw), device="cpu", tp=group(0, 2))


def test_tp_refuses_offload_roles_and_bad_configs(tmp_path):
    from llmd_kv_cache_tpu_torch.offload.spec import SharedStorageOffloadSpec

    cfg = llama.LlamaConfig(**GQA_TP)
    base = dict(model=cfg, num_pages=16, max_pages_per_seq=4)
    spec = SharedStorageOffloadSpec(root=str(tmp_path), model_name="m", dtype="bfloat16")
    with pytest.raises(ValueError, match="offload_spec"):
        engine.MiniEngine(engine.EngineConfig(**base), device="cpu", offload_spec=spec,
                          tp=group(0, 2))
    with pytest.raises(ValueError, match="role='prefill'"):
        engine.MiniEngine(engine.EngineConfig(**base, role="prefill"), device="cpu",
                          offload_spec=spec, tp=group(0, 2))
    eng = engine.MiniEngine(engine.EngineConfig(**base), device="cpu", tp=group(1, 2))
    with pytest.raises(ValueError, match="role='decode'"):
        eng.set_role("decode")
    assert eng.cfg.role == "both"
    with pytest.raises(ValueError, match="num_kv_heads"):  # validate_tp_config's
        engine.MiniEngine(engine.EngineConfig(**base), device="cpu", tp=group(0, 4))
    qkv = llama.params_from_jax(_tree("dense")[0], cfg, device="cpu")
    qkv["layers"][0]["router"] = torch.zeros(64, 4)
    with pytest.raises(NotImplementedError, match="router"):
        mesh.shard_params(qkv, group(0, 2))
    narrow = dataclasses.replace(cfg, vocab_size=255)
    with pytest.raises(ValueError, match="embed"):
        mesh.shard_params(llama.init_params(narrow, device="cpu"), group(0, 2))
