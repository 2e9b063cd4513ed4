"""Tensor-parallel serving: the shards of a ``MiniEngine``'s state.

Port of ``llmd_kv_cache_tpu/parallel/serve.py``. Parameters take the
Megatron layout (``mesh.shard_params``, the JAX ``shard_engine_params``
with the group in place of the mesh); a GQA pool holds ``num_kv_heads /
tp`` kv heads on each rank, while a single-head pool (absorbed MLA's
latent) is whole on every rank, which is what lets each rank attend its
local query heads with no collective in attention. Page tables, token
blocks and the scheduler stay the same on every rank: paging is control
plane, run alike on each.

Requirements, with the JAX messages: ``num_kv_heads % tp == 0`` for GQA
(every rank owns whole kv heads, so no GQA group straddles ranks), MLA
instead ``num_heads % tp == 0`` (it shards the head axis), and the
Megatron widths divisible by tp. MoE (the ``ep`` axis) is not ported.
"""

from __future__ import annotations

import torch

from ..ops.paged_attention import tp_pool_heads


def mesh_tp_size(group) -> int:
    """The tp size of a group (1 for none)."""
    return 1 if group is None else group.size


def validate_tp_config(cfg, group) -> None:
    """Raises ``ValueError`` (the JAX messages) when the model ``cfg`` does
    not split into the group's tp ranks."""
    tp = mesh_tp_size(group)
    if cfg.is_mla:
        # MLA shards the *head* axis (wq/w_uk/w_uv/wo); the single shared
        # latent head replicates, so kv-head divisibility does not apply.
        if cfg.num_heads % tp != 0:
            raise ValueError(
                f"num_heads ({cfg.num_heads}) must divide by the tp axis "
                f"({tp}) so every shard owns whole query heads (MLA "
                f"shards the absorbed up-projections per head)")
    elif cfg.num_kv_heads % tp != 0:
        raise ValueError(
            f"num_kv_heads ({cfg.num_kv_heads}) must divide by the tp axis "
            f"({tp}) so every shard owns whole kv heads")
    # Width divisibility: the Megatron column/row splits are uniform.
    if tp > 1:
        widths = {"intermediate_size": cfg.intermediate_size}
        if not cfg.is_mla:
            widths["num_heads*head_dim"] = cfg.num_heads * cfg.head_dim
            widths["num_kv_heads*head_dim"] = cfg.num_kv_heads * cfg.head_dim
        for name, width in widths.items():
            if width % tp:
                raise ValueError(
                    f"{name} ({width}) must divide by the tp axis "
                    f"({tp}): Megatron shards are uniform")


def shard_kv_pool(group, k_cache: torch.Tensor, v_cache: torch.Tensor):
    """The rank's part of one full paged pool ``[layers, pages, kv_heads,
    page_size, width]``, as the JAX ``shard_kv_pool`` places them: copies
    of its ``tp_pool_heads`` heads, or a pool of one head (absorbed MLA's
    latent) itself, whole. (An engine allocates its part directly:
    ``init_kv_cache(..., tp_size=)``, by the same rule.)"""
    tp = mesh_tp_size(group)
    n = tp_pool_heads(k_cache.shape[2], tp)
    if n == k_cache.shape[2]:
        return k_cache, v_cache

    def part(pool):
        return pool.narrow(2, group.rank * n, n).contiguous()

    return part(k_cache), part(v_cache)
