"""``shard_params`` over fused and expert trees, against the JAX package.

For tp 2 and 4, each rank's ``shard_params`` equals, bit for bit, the shard
JAX's ``shard_params(make_mesh({"tp": n}), tree)`` places on device r, for
the fused trees (interleaved at t = tp, as the engines fuse them; with
Qwen2 biases), ``mixtral_tiny``'s experts unfused and fused, the tiny
DeepSeek-V3 MoE (MLA attention, router bias, shared expert: MLA stays
unfused under tp) and a DeepSeek-router GQA model fused (its shared expert
as ``w_gate_up_sh``); the ``fused_interleave`` marker is carried. Every
leaf family of JAX's ``param_pspecs`` (without ``ep``) has the split axis
its PartitionSpec gives.
"""

import dataclasses

import jax
import numpy as np
import pytest

from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.parallel import mesh as jax_mesh
from llmd_kv_cache_tpu_torch.models import llama
from llmd_kv_cache_tpu_torch.parallel import mesh

from tests.test_torch_fused import assert_trees_bit_equal, group, jax_mesh_of, tree_of
from tests.test_torch_swa import jax_params

# (tree family, fused at t = tp)
SHARDED = {"fused": ("tiny", True), "fused-bias": ("bias", True),
           "mixtral": ("mixtral", False), "mixtral-fused": ("mixtral", True),
           "deepseek": ("deepseek", False), "deepseek-gqa-fused": ("deepseek-gqa", True)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", list(SHARDED))
def test_shard_params_equal_jax_shards(kind, tp):
    name, fused = SHARDED[kind]
    jcfg, tcfg, tree = tree_of(name)
    jparams = jax_params(tree)
    full = llama.params_from_jax(tree, tcfg, device="cpu")
    if fused:
        jcfg = dataclasses.replace(jcfg, fused_interleave=tp)
        tcfg = dataclasses.replace(tcfg, fused_interleave=tp)
        jparams = jax_llama.fuse_params(jparams, jcfg)
        full = llama.fuse_params(full, tcfg)
    jmesh = jax_mesh_of(tp)
    placed = jax_mesh.shard_params(jmesh, jparams)
    assert placed.get("fused_interleave") == (tp if fused else None)
    for r in range(tp):
        device = jmesh.devices.flat[r]
        want = {k: (v if k == "fused_interleave" else jax.tree_util.tree_map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == device), v)) for k, v in placed.items()}
        assert_trees_bit_equal(mesh.shard_params(full, group(r, tp)), want)


def test_split_axes_cover_every_family_jax_shards():
    """Every leaf JAX's ``param_pspecs`` names (without ``ep``) has a split
    axis here, the one its PartitionSpec shards (None: replicated)."""
    import itertools

    names = ("moe_layer", "qk_norm", "mla_layer", "qkv_bias", "latent_norm", "q_lora",
             "shared_expert", "router_bias", "fused")
    for values in itertools.product((False, True), repeat=len(names)):
        flags = dict(zip(names, values))
        if flags["mla_layer"] and flags["fused"]:
            continue  # JAX's MLA family has no fused leaves: MLA serves unfused under tp
        specs = jax_mesh.param_pspecs(True, False, **flags)
        axes = mesh.param_split_axes(**{k: v for k, v in flags.items()})
        assert set(axes["layers"]) == set(specs["layers"]), flags
        for key, spec in {**specs["layers"], **{k: v for k, v in specs.items()
                                                  if k != "layers"}}.items():
            got = axes["layers"][key] if key in specs["layers"] else axes[key]
            want = next((i for i, a in enumerate(spec) if a == "tp"), None)
            assert got == want, (flags, key)
