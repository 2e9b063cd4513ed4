"""Tensor-parallel serving: the tp group, the Megatron parameter layout and
the engine's shards (``mesh``, ``serve``).

Port of the serving parts of ``llmd_kv_cache_tpu/parallel/``. JAX runs tp
as one controller over a named mesh, with collectives XLA inserts; here
each rank is a process over ``torch.distributed`` with one ``MiniEngine``,
and the two all-reduces a layer (after ``wo`` and after ``w_down``), the
vocab-sharded embedding's and the ``lm_head`` gather are explicit.
"""

from .mesh import (
    TPGroup,
    init_tp_group,
    mesh_fingerprint_fields,
    param_split_axes,
    shard_params,
    spawn_tp,
)
from .serve import mesh_tp_size, shard_kv_pool, validate_tp_config

__all__ = [
    "TPGroup",
    "init_tp_group",
    "mesh_fingerprint_fields",
    "mesh_tp_size",
    "param_split_axes",
    "shard_kv_pool",
    "shard_params",
    "spawn_tp",
    "validate_tp_config",
]
