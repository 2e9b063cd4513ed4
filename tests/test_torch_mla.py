"""The port's absorbed-MLA path against the JAX package.

- ``LlamaConfig`` refuses the same MLA, RoPE-scaling and latent_pad
  configurations as the JAX ``__post_init__``, with the same messages.
- ``_rope`` with llama3 and yarn scaling matches the JAX ``_rope``.
- The plain version behind the latent wrappers (what they run for CPU
  tensors: the K pool passed as V) matches the Pallas ``_decode_kernel``
  (reached through ``pallas_paged_decode_attention`` at ``kv_heads == 1``,
  for both ``shared_stream`` values, and for MQA with a separate V) and the
  ``shared_kv`` arm of ``_prefill_kernel``, both in interpret mode.
- ``forward`` logits of ``deepseek_tiny`` (with and without ``latent_pad``,
  with ``latent_norm`` and q-LoRA leaves under yarn scaling) match the JAX
  ``forward``; the port's ``MiniEngine`` gives the JAX engine's greedy
  tokens, ``cached_len`` and event stream (``mla_attention``), and its
  tokens do not depend on ``latent_pad``.

Inputs come from numpy with a seed; weights are the JAX tree carried over
by ``params_from_jax``. Everything runs at fp32 (bf16 argmax near-ties flip
between differently compiled programs); each tolerance is stated where it
is used. Pallas interpret mode compiles once per shape, so cases share
shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.ops.pallas_paged_attention import (
    pallas_paged_decode_attention,
    pallas_paged_prefill_attention,
)
from llmd_kv_cache_tpu_torch.core.hma import SPEC_MLA
from llmd_kv_cache_tpu_torch.events.model import BlockStoredEvent
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.ops.cuda_paged_attention import (
    cuda_paged_decode_attention,
    cuda_paged_latent_decode_attention,
    cuda_paged_latent_prefill_attention,
    cuda_paged_prefill_attention,
)

from test_torch_attention import make_table, t
from test_torch_engine import normalize

# Attention outputs at fp32: only summation order differs.
ATTN_TOL = 1e-5
# Logits at fp32, relative to the largest logit (as tests/test_torch_model.py).
LOGITS_TOL = 1e-4

DS_TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               num_kv_heads=4, head_dim=16, intermediate_size=128, page_size=4,
               kv_lora_rank=16, qk_rope_head_dim=8)


def pair_of_configs(**overrides):
    kw = {**DS_TINY, **overrides}
    return (jax_llama.LlamaConfig(**kw, dtype=jnp.float32),
            llama.LlamaConfig(**kw, dtype=torch.float32))


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

INVALID = [
    pytest.param(dict(kv_lora_rank=16, qk_rope_head_dim=0), id="mla-no-rope-dims"),
    pytest.param(dict(kv_lora_rank=16, qk_rope_head_dim=7), id="mla-odd-rope-dims"),
    pytest.param(dict(rope_scaling=("yarn", 4.0)), id="yarn-short"),
    pytest.param(dict(rope_scaling=("linear", 2.0, 1.0, 4.0, 8192.0)), id="unknown-kind"),
    pytest.param(dict(softmax_scale_mult=0.5), id="scale-mult-without-mla"),
    pytest.param(dict(kv_lora_rank=16, qk_rope_head_dim=8, mla_decode_stream="alias"),
                 id="bad-stream"),
    pytest.param(dict(mla_decode_stream="reuse"), id="stream-without-mla"),
    pytest.param(dict(latent_pad=8), id="pad-without-mla"),
    pytest.param(dict(kv_lora_rank=16, qk_rope_head_dim=8, latent_pad=-8), id="negative-pad"),
]


@pytest.mark.parametrize("kw", INVALID)
def test_config_validation_matches_jax(kw):
    base = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=4, head_dim=16, intermediate_size=128, page_size=4)
    with pytest.raises(ValueError) as jax_err:
        jax_llama.LlamaConfig(**base, **kw)
    with pytest.raises(ValueError) as port_err:
        llama.LlamaConfig(**base, **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_config_properties_match_jax():
    for kw in (dict(DS_TINY, latent_pad=8, mla_decode_stream="reuse"),
               dict(DS_TINY, kv_lora_rank=0, qk_rope_head_dim=0)):
        jcfg, tcfg = jax_llama.LlamaConfig(**kw), llama.LlamaConfig(**kw)
        assert (tcfg.is_mla, tcfg.kv_cache_heads, tcfg.kv_cache_head_dim) == \
            (jcfg.is_mla, jcfg.kv_cache_heads, jcfg.kv_cache_head_dim)
    assert llama.LlamaConfig.deepseek_tiny() == llama.LlamaConfig(**DS_TINY)


# --------------------------------------------------------------------------
# RoPE scaling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scaling", [
    pytest.param((), id="plain"),
    pytest.param(("llama3", 8.0, 1.0, 4.0, 8192.0), id="llama3"),
    # DeepSeek-V2-Lite's yarn: factor 40, beta 32/1, 4096 original
    # positions, attention factor 1.0 (mscale = mscale_all_dim).
    pytest.param(("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0), id="yarn-v2-lite"),
    pytest.param(("yarn", 4.0, 32.0, 1.0, 2048.0, 1.1386), id="yarn-att"),
])
@pytest.mark.parametrize("hd", [16, 64])
def test_rope_scaling_matches_jax(scaling, hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 5, 3, hd)).astype(np.float32)
    positions = np.array([[0, 1, 17, 300, 1023], [2, 64, 511, 700, 1500]], np.int32)
    ref = np.asarray(jax_llama._rope(jnp.asarray(x), jnp.asarray(positions), 10000.0,
                                     scaling))
    got = llama._rope(t(x), t(positions), 10000.0, scaling).numpy()
    # fp32 angles up to 1500 rad: a one-ulp difference in a frequency moves
    # an angle by ~1e-4 rad at most here, hence 2e-4 on values of |x| ~ 1-3.
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


# --------------------------------------------------------------------------
# attention over the latent: the plain version vs the Pallas kernels
# --------------------------------------------------------------------------

def latent_decode_case(width, q_heads, page_size=4, seed=0, separate_v=False):
    """Five decode rows over one KV head: page-crossing contexts, a
    one-token row and a padded ctx-0 row."""
    rng = np.random.default_rng(seed)
    lens = [page_size * 3 + 1, page_size, 2, 9, 0]
    pages_per_seq = 5
    num_pages = 1 + len(lens) * pages_per_seq
    shape = (num_pages, 1, page_size, width)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32) if separate_v else k
    table = make_table(rng, lens, pages_per_seq, page_size, num_pages)
    q = rng.normal(size=(len(lens), q_heads, width)).astype(np.float32)
    return q, k, v, table, np.array(lens, np.int32)


@pytest.mark.parametrize("stream", ["copy", "reuse"])
@pytest.mark.parametrize("width", [24, 128])
@pytest.mark.parametrize("q_heads", [4, 16])
def test_shared_kv_decode_matches_pallas(q_heads, width, stream):
    q, k, _, table, ctx = latent_decode_case(width, q_heads)
    live = ctx > 0
    before = cuda_paged_latent_decode_attention.launches
    got = cuda_paged_decode_attention(t(q), t(k), t(k[..., :0]), t(table), t(ctx),
                                      shared_kv=True).numpy()
    assert cuda_paged_latent_decode_attention.launches == before  # CPU: plain, no launch
    ref = np.asarray(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(table),
        jnp.asarray(ctx), shared_kv=True, shared_stream=stream, interpret=True))
    np.testing.assert_allclose(got[live], ref[live], atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("window,sinks", [(None, None), (6, 3)])
def test_mqa_decode_matches_pallas(window, sinks):
    """kv_heads == 1 with a separate V pool (MQA) takes the same route: the
    JAX wrapper's per-head kernel, the port's latent wrapper."""
    q, k, v, table, ctx = latent_decode_case(16, 8, seed=1, separate_v=True)
    live = ctx > 0
    got = cuda_paged_decode_attention(t(q), t(k), t(v), t(table), t(ctx),
                                      sliding_window=window, sinks=sinks).numpy()
    ref = np.asarray(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(ctx), sliding_window=window, sinks=sinks, interpret=True))
    np.testing.assert_allclose(got[live], ref[live], atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("width,q_heads", [(24, 4), (128, 16)])
def test_shared_kv_prefill_matches_pallas(width, q_heads):
    rng = np.random.default_rng(width)
    page_size, q_seq = 4, 8
    ctx = np.array([page_size + 3, 0], np.int32)
    new = np.array([q_seq - 3, q_seq], np.int32)
    total = ctx + new
    pages_per_seq = int(max((total + page_size - 1) // page_size)) + 1
    num_pages = 1 + 2 * pages_per_seq
    k = rng.normal(size=(num_pages, 1, page_size, width)).astype(np.float32)
    table = make_table(rng, list(total), pages_per_seq, page_size, num_pages)
    q = rng.normal(size=(2, q_seq, q_heads, width)).astype(np.float32)
    before = cuda_paged_latent_prefill_attention.launches
    got = cuda_paged_prefill_attention(t(q), t(k), t(k[..., :0]), t(table), t(ctx),
                                       t(total), shared_kv=True).numpy()
    assert cuda_paged_latent_prefill_attention.launches == before
    ref = np.asarray(pallas_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(table),
        jnp.asarray(ctx), jnp.asarray(total), q_tile=4, shared_kv=True, interpret=True))
    for b in range(2):  # valid query rows only
        np.testing.assert_allclose(got[b, :new[b]], ref[b, :new[b]],
                                   atol=ATTN_TOL, rtol=ATTN_TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def jax_tree_to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def add_checkpoint_leaves(tree, cfg, seed=0, q_lora_rank=32):
    """The leaves a DeepSeek checkpoint adds (``params_from_hf``): the
    latent's ``latent_norm`` and q-LoRA's ``w_dq`` / ``q_latent_norm``, with
    ``wq`` then taking the q latent."""
    rng = np.random.default_rng(seed)
    h, dr = cfg.hidden_size, cfg.qk_rope_head_dim
    for layer in tree["layers"]:
        layer["latent_norm"] = rng.uniform(0.5, 1.5, cfg.kv_lora_rank).astype(np.float32)
        layer["w_dq"] = (rng.normal(size=(h, q_lora_rank)) * 0.1).astype(np.float32)
        layer["q_latent_norm"] = rng.uniform(0.5, 1.5, q_lora_rank).astype(np.float32)
        layer["wq"] = (rng.normal(size=(q_lora_rank, cfg.num_heads * (cfg.head_dim + dr)))
                       * 0.1).astype(np.float32)
    return tree


MODEL_CASES = [
    pytest.param({}, False, id="deepseek-tiny"),
    pytest.param(dict(latent_pad=8), False, id="latent-pad"),
    pytest.param(dict(rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0),
                      softmax_scale_mult=1.3), True, id="latent-norm-q-lora-yarn"),
]


@pytest.mark.parametrize("overrides,checkpoint_leaves", MODEL_CASES)
def test_forward_matches_jax(overrides, checkpoint_leaves):
    jcfg, tcfg = pair_of_configs(**overrides)
    tree = jax_tree_to_numpy(jax_llama.init_params(jax.random.PRNGKey(0), jcfg))
    if checkpoint_leaves:
        tree = add_checkpoint_leaves(tree, jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = llama.params_from_jax(tree, tcfg, device="cpu")
    page, num_pages, pages_per_seq = jcfg.page_size, 24, 8
    jk, jv = jax_llama.init_kv_cache(jcfg, num_pages)
    tk, tv = llama.init_kv_cache(tcfg, num_pages, device="cpu")
    assert tuple(tk.shape) == jk.shape and tuple(tv.shape) == jv.shape
    assert tv.shape[-1] == 0  # the V pool of an MLA model is never read
    table = np.arange(1, 1 + 2 * pages_per_seq, dtype=np.int32).reshape(2, pages_per_seq)
    rng = np.random.default_rng(0)

    def step(tokens, ctx, new, last_only=False):
        nonlocal jk, jv
        jlog, jk, jv = jax_llama.forward(
            jparams, jcfg, jnp.asarray(tokens), jk, jv, jnp.asarray(table),
            jnp.asarray(ctx), jnp.asarray(new), last_only=last_only)
        tlog, tk2, _ = llama.forward(
            tparams, tcfg, torch.from_numpy(tokens), tk, tv, torch.from_numpy(table),
            torch.from_numpy(ctx), torch.from_numpy(new), last_only=last_only)
        assert tk2 is tk  # the latent pool is updated in place
        return np.asarray(jlog), tlog.numpy()

    def close(got, ref):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=LOGITS_TOL * float(np.abs(ref).max()))

    # A cold chunk (row 1 padded), then a chunk of the same shape (one JAX
    # compile) over the cached prefix.
    seq = 2 * page + 2
    ctx = np.zeros(2, np.int32)
    for new in (np.array([seq, seq - 5], np.int32), np.array([page + 3, 2], np.int32)):
        ref, got = step(rng.integers(0, 256, (2, seq)).astype(np.int32), ctx, new)
        for b in range(2):
            close(got[b, :new[b]], ref[b, :new[b]])
        ctx = ctx + new
    # Every latent both pools hold, outside the garbage page, agrees.
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               rtol=1e-5, atol=1e-5)
    # A decode step: one live row, one padded row; and through forward_decode.
    toks = rng.integers(0, 256, (2, 1)).astype(np.int32)
    new = np.array([1, 0], np.int32)
    tk_before = tk.clone()
    ref, got = step(toks, ctx, new)
    close(got[:1], ref[:1])
    tk.copy_(tk_before)
    tlog, _, _ = llama.forward_decode(
        tparams, tcfg, torch.from_numpy(toks), tk, tv, torch.from_numpy(table),
        torch.from_numpy(ctx), torch.from_numpy(new))
    close(tlog.numpy()[:1], ref[:1])


def test_mla_params_and_cache_shapes_match_jax():
    jcfg, tcfg = pair_of_configs(latent_pad=8)
    ref = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    got = llama.init_params(tcfg, seed=1, device="cpu")
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), ref) == {
        "embed": tuple(got["embed"].shape), "final_norm": tuple(got["final_norm"].shape),
        "lm_head": tuple(got["lm_head"].shape),
        "layers": [{k: tuple(x.shape) for k, x in layer.items()}
                   for layer in got["layers"]]}
    k, v = llama.init_kv_cache(tcfg, 5, device="cpu")
    assert tuple(k.shape) == (2, 5, 1, 4, 16 + 8 + 8) and tuple(v.shape) == (2, 5, 1, 4, 0)
    tree = add_checkpoint_leaves(jax_tree_to_numpy(ref), jcfg)
    assert set(llama.params_from_jax(tree, tcfg, device="cpu")["layers"][0]) == \
        set(tree["layers"][0])
    tree["layers"][0]["wk"] = np.zeros((64, 64), np.float32)  # a GQA leaf
    with pytest.raises(NotImplementedError, match="wk"):
        llama.params_from_jax(tree, tcfg, device="cpu")


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class Pair:
    """A JAX engine and a port engine serving the same MLA weights."""

    def __init__(self, cfg_overrides=(), **engine_kw):
        jcfg, tcfg = pair_of_configs(**dict(cfg_overrides))
        base = dict(max_pages_per_seq=16, model_name="ds", pod_identifier="pod-m")
        base.update(engine_kw)
        self.jax_events, self.events = [], []
        self.jax = jax_engine.MiniEngine(
            jax_engine.EngineConfig(model=jcfg, **base),
            event_sink=self.jax_events.extend, seed=0)
        params = llama.params_from_jax(jax_tree_to_numpy(self.jax.params), tcfg,
                                       device="cpu")
        self.port = engine.MiniEngine(
            engine.EngineConfig(model=tcfg, **base),
            event_sink=self.events.extend, params=params, device="cpu")


def test_engine_matches_jax():
    pair = Pair(num_pages=96, max_batch=3, max_prefill_tokens=8)
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, 256, 13).tolist()
    prompts = [prefix + rng.integers(1, 256, n).tolist() for n in (7, 3, 12, 0)]
    first = [pair.jax.add_request("w", prefix + [5], max_new_tokens=3),
             pair.port.add_request("w", prefix + [5], max_new_tokens=3)]
    while not all(r.done for r in first):
        assert pair.port.step() == pair.jax.step()
    reqs = [(pair.jax.enqueue(f"r{i}", p, max_new_tokens=4 + i),
             pair.port.enqueue(f"r{i}", p, max_new_tokens=4 + i))
            for i, p in enumerate(prompts)]
    for _ in range(60):
        assert pair.port.step() == pair.jax.step()
        if all(jr.done for jr, _ in reqs):
            break
    for jr, tr in reqs:
        assert tr.done and jr.done
        assert (tr.output, tr.cached_len, tr.block_hashes) == \
            (jr.output, jr.cached_len, jr.block_hashes)
    assert any(tr.cached_len == 12 for _, tr in reqs)  # the prefix was reused
    assert normalize(pair.events) == normalize(pair.jax_events)
    stored = [e for e in pair.events if isinstance(e, BlockStoredEvent)]
    assert stored and all(e.kv_cache_spec_kind == SPEC_MLA for e in stored)


def test_mla_latent_pad_is_semantics_invariant():
    """latent_pad (the TPU's lane-aligned cache layout) changes no served
    token: zero key dims score zero and the output keeps [:rank]. As
    tests/test_pallas_decode_engine.py checks it for the JAX engine, here
    for the port, padded and not, against the JAX engine."""
    prompt = list(range(40, 60))
    pair = Pair(num_pages=64)
    outs = {"jax": pair.jax.generate("r", prompt, max_new_tokens=6),
            "port": pair.port.generate("r", prompt, max_new_tokens=6)}
    padded = engine.MiniEngine(
        engine.EngineConfig(model=pair_of_configs(latent_pad=104)[1], num_pages=64,
                            max_pages_per_seq=16, model_name="ds", pod_identifier="pod-m"),
        params=pair.port.params, device="cpu")  # 16 + 8 + 104 = 128
    assert padded.k_cache.shape[-1] == 128
    outs["port padded"] = padded.generate("r", prompt, max_new_tokens=6)
    assert len({tuple(v) for v in outs.values()}) == 1, outs

