"""Tensor parallelism over fused projections and expert layers, against the
JAX package.

- (``shard_params`` against JAX's shards: ``tests/test_torch_tp_moe_shards.py``.)
- A spawned gloo pair on the CPU (its ranks: ``torch_tp_moe_ranks``) serves
  ``mixtral_tiny`` with ``fuse_projections=True``, the DeepSeek-V3 MoE and
  the fused DeepSeek-router GQA model at tp 2 and fp32: the tokens equal
  JAX's tp 2 engine's and the port's tp 1 engine's, rank 0's events the
  tp 1 engine's and rank 1 emits none.
- A control pair whose ranks split their local fused outputs with the
  whole tree's interleave (t = tp, JAX's global split) decodes other
  tokens: the per-rank split is what the tokens rest on.

Inputs come from numpy with a seed; weights are JAX trees carried over by
``params_from_jax``.
"""

import concurrent.futures

import jax
import numpy as np
import pytest

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.parallel import mesh

from test_torch_tp_ranks import ENGINE, traffic
from tests.test_torch_engine import normalize
from tests.test_torch_fused import DEEPSEEK_GQA, TREES, jax_mesh_of, to_numpy
from tests.test_torch_swa import config_pair, jax_params
from torch_tp_moe_ranks import serve_moe_rank

MOE_TP = {"mixtral-fused": ("mixtral", True), "deepseek": ("deepseek", None),
          "deepseek-gqa-fused": ("deepseek-gqa", True)}


def serve_pair(name, fuse, control=False):
    """The gloo pair's results, JAX's tp 2 engine's tokens and the port's
    tp 1 engine's tokens and events, all over one fp32 tree."""
    kw = {k: v for k, v in TREES[name].items() if k not in ("dtype", "fused_interleave")}
    jcfg, tcfg = config_pair(TREES[name])
    tree = to_numpy(jax_llama.init_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    for layer in tree["layers"]:
        if "router_bias" in layer:
            layer["router_bias"] = (rng.standard_normal(layer["router_bias"].shape)
                                    * 0.5).astype(np.float32)
    with concurrent.futures.ThreadPoolExecutor(1) as waiter:
        pair = waiter.submit(mesh.spawn_tp, serve_moe_rank, 2, backend="gloo",
                             devices=["cpu", "cpu"], args=(kw, tree, fuse, control),
                             timeout_s=240, collective_timeout_s=120)
        jax_outs = None
        if not control:
            jax_eng = jax_engine.MiniEngine(
                jax_engine.EngineConfig(model=jcfg, use_pallas_decode=True,
                                        fuse_projections=fuse, **ENGINE),
                params=jax_params(tree), mesh=jax_mesh_of(2))
            jax_outs = traffic(jax_eng)
        events = []
        tp1 = engine.MiniEngine(engine.EngineConfig(model=tcfg, **ENGINE),
                                event_sink=events.extend,
                                params=llama.params_from_jax(tree, tcfg, device="cpu"),
                                device="cpu")
        tp1_outs = traffic(tp1)
        ranks = pair.result()
    return ranks, jax_outs, tp1_outs, events


@pytest.mark.parametrize("name", list(MOE_TP))
def test_gloo_pair_serves_moe_like_jax_and_tp1(name):
    family, fuse = MOE_TP[name]
    (rank0, rank1), jax_outs, tp1_outs, events = serve_pair(family, fuse)
    assert rank0["outs"] == rank1["outs"] == tp1_outs == jax_outs
    assert any(cached for _, cached in list(tp1_outs.values())[1:])  # a prefix was reused
    assert normalize(rank0["events"]) == normalize(events) and rank1["events"] == []
    fused = fuse is True
    assert ("w_qkv" in rank0["keys"]) == fused and ("wq" in rank0["keys"]) == (not fused)
    assert rank0["interleave"] == (2 if fused else 1)
    assert rank0["marker"] == (2 if fused else None)


def test_splitting_a_ranks_block_with_the_trees_interleave_gives_other_tokens():
    """The sound pair's tokens are the tp 1 engine's
    (``test_gloo_pair_serves_moe_like_jax_and_tp1[mixtral-fused]``)."""
    (bad0, bad1), _, tp1_outs, _ = serve_pair("mixtral", True, control=True)
    assert bad0["outs"] == bad1["outs"] != tp1_outs
    assert bad0["interleave"] == bad0["marker"] == 2


def test_deepseek_gqa_family_is_a_valid_jax_config():
    """The DeepSeek-router GQA config (no MLA) is one JAX takes."""
    jcfg, tcfg = config_pair(DEEPSEEK_GQA)
    assert not jcfg.is_mla and tcfg.deepseek_router
    assert tcfg.moe_layer(1) and not tcfg.moe_layer(0)
