"""Tensor-parallel groups and the Megatron parameter layout, in PyTorch.

Port of the tp parts of ``llmd_kv_cache_tpu/parallel/mesh.py``. JAX names a
device mesh and lets XLA insert the collectives from each leaf's
PartitionSpec. Here a tensor-parallel group is ``size`` processes over
``torch.distributed``, one rank a process (``TPGroup``): each rank holds its
slice of every sharded leaf (``shard_params``, the split axis of each leaf
from ``param_split_axes``, the layout of the JAX ``param_pspecs``) and runs
the collectives itself: ``TPGroup.all_reduce_`` (after ``wo`` and after
``w_down``, and the vocab-sharded embedding's masked lookup) and
``TPGroup.gather_vocab`` (the ``lm_head`` logits).

The backend is the caller's choice, never switched after a failure:
``nccl`` when each rank has a card of its own, ``gloo`` when the ranks
share one card (NCCL refuses two ranks on one device) or run on the CPU.
Gloo reduces CUDA tensors through the host and has no all-gather for them,
so the vocab gather is an all-reduce into a zero-filled full-vocab buffer
on every backend (exact: every element is one rank's value plus zeros).

``spawn_tp`` starts the ranks as fresh processes (``spawn``: a parent that
has initialised CUDA cannot fork), joined through a ``file://`` rendezvous
in a new temporary directory, each with a timeout on its collectives, and
waits for every rank's result up to a deadline: a rank that fails or dies
fails the call, and the others are stopped.

Not ported: the ``ep`` axis and the MoE leaves (the port has no MoE), the
fused-projection layout (``fused_interleave``), and the ``dp``/``sp``/``pp``
axes, which the fingerprint fields report as 1.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One rank's view of its tensor-parallel group: its ``rank`` of
    ``size``, the ``torch.distributed`` process group (None for a group
    that was never initialised, as the CPU tests' checks use), the rank's
    ``device`` and the group's ``backend``."""

    rank: int
    size: int
    process_group: Any
    device: torch.device
    backend: str

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sums ``x`` over the ranks, in place, and returns it. Every rank
        ends with the same bits."""
        if self.size > 1:
            dist.all_reduce(x, group=self.process_group)
        return x

    def gather_vocab(self, local: torch.Tensor) -> torch.Tensor:
        """The full-vocabulary tensor from each rank's contiguous vocab
        slice on the last axis (``[..., V / size]`` -> ``[..., V]``, rank r's
        slice at ``[r V / size, (r + 1) V / size)``), as an all-reduce into
        zeros."""
        if self.size == 1:
            return local
        n = local.shape[-1]
        full = local.new_zeros(tuple(local.shape[:-1]) + (n * self.size,))
        full[..., self.rank * n:(self.rank + 1) * n] = local
        return self.all_reduce_(full)


def init_tp_group(rank: int, size: int, *, backend: str, init_method: str, device,
                  timeout_s: float = 300.0) -> TPGroup:
    """Joins this process to a group of ``size`` ranks as ``rank``
    (``torch.distributed.init_process_group`` with ``init_method``, e.g. a
    ``file://`` path no earlier group used, and a ``timeout_s`` on every
    collective) and returns its ``TPGroup`` on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return TPGroup(rank=rank, size=size, process_group=dist.group.WORLD, device=device,
                   backend=backend)


def _rank_main(fn, rank, size, backend, device, init_method, timeout_s, args, results):
    """A spawned rank: joins the group, runs ``fn(group, *args)`` and puts
    ``(rank, True, pickled result)`` or ``(rank, False, traceback)`` on
    ``results``. The result is pickled here, by value: a queue would pass a
    tensor as a shared-memory handle, which dies with this process."""
    try:
        group = init_tp_group(rank, size, backend=backend, init_method=init_method,
                              device=device, timeout_s=timeout_s)
        try:
            out = pickle.dumps(fn(group, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent reports it and stops the other ranks
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_tp(fn: Callable, size: int, *, backend: str, devices: Sequence, args: tuple = (),
             timeout_s: float = 600.0, collective_timeout_s: float = 300.0) -> list:
    """Runs ``fn(group, *args)`` on ``size`` spawned ranks, rank r on
    ``devices[r]``, and returns their results in rank order.

    ``fn`` must be importable by name (a module-level function; the ranks
    import its module, so a script's ``main()`` stays behind its
    ``__name__`` guard). The ranks meet through a ``file://`` rendezvous in
    a fresh temporary directory, so concurrent groups never clash. Raises
    ``RuntimeError`` with the rank's traceback when a rank fails, or when a
    rank exits with no result, and ``TimeoutError`` past ``timeout_s``; the
    other ranks are then killed. ``collective_timeout_s`` bounds each
    collective a rank waits in."""
    import multiprocessing

    if len(devices) != size:
        raise ValueError(f"{size} ranks need {size} devices, got {len(devices)}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tp-rendezvous-") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, size, backend, str(devices[r]), init_method,
                                   collective_timeout_s, args, results))
                 for r in range(size)]
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout_s
        quiet_exits: set[int] = set()
        try:
            while len(out) < size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"tp ranks {sorted(set(range(size)) - set(out))} gave no result in "
                        f"{timeout_s:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(1.0, remaining))
                except queue.Empty:
                    # A rank that exited may have put its result (or its
                    # traceback) just after the wait: fail only when a later
                    # wait found the queue empty too.
                    for r, p in enumerate(procs):
                        if r in out or p.exitcode is None:
                            continue
                        if r in quiet_exits:
                            raise RuntimeError(
                                f"tp rank {r} exited with code {p.exitcode} and no result")
                        quiet_exits.add(r)
                    continue
                if not ok:
                    raise RuntimeError(f"tp rank {rank} failed:\n{payload}")
                out[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                p.join(timeout=30 if len(out) == size else 0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
            results.close()
    return [out[r] for r in range(size)]


def param_split_axes(qkv_bias: bool = False, qk_norm: bool = False, mla_layer: bool = False,
                     latent_norm: bool = False, q_lora: bool = False) -> dict:
    """The axis each leaf splits on over tp, None for a replicated leaf: the
    JAX ``param_pspecs`` for one layer family, one axis a leaf.

    Column-parallel ``wq``/``wk``/``wv``/``w_gate``/``w_up`` (output
    features, axis 1) and their QKV biases (axis 0), row-parallel
    ``wo``/``w_down`` (input features, axis 0), the vocab-sharded ``embed``
    (rows) and ``lm_head`` (columns); the norms replicate, Qwen3's per-head
    ``q_norm``/``k_norm`` too. An MLA layer shards on the head axis: ``wq``
    (head-major columns: whole heads a rank), ``w_uk``/``w_uv`` (leading
    head axis), while the latent's ``w_dkv``/``w_kr``/``latent_norm`` and
    q-LoRA's ``w_dq``/``q_latent_norm`` replicate: every rank computes the
    same latent and writes it to its whole copy of the pool."""
    layer = {"attn_norm": None, "wq": 1, "wo": 0, "mlp_norm": None}
    if mla_layer:
        layer.update({"w_dkv": None, "w_kr": None, "w_uk": 0, "w_uv": 0})
        if latent_norm:
            layer["latent_norm"] = None
        if q_lora:
            layer.update({"w_dq": None, "q_latent_norm": None})
    else:
        layer.update({"wk": 1, "wv": 1})
        if qkv_bias:
            layer.update({"bq": 0, "bk": 0, "bv": 0})
    if qk_norm:
        layer.update({"q_norm": None, "k_norm": None})
    layer.update({"w_gate": 1, "w_up": 1, "w_down": 0})
    return {"embed": 0, "layers": layer, "final_norm": None, "lm_head": 1}


def _layer_flags(layer: dict) -> dict:
    """The layer family of one layer's keys (the JAX ``_layer_flags`` less
    the MoE and fused flags, which the port has no layers of)."""
    return dict(qkv_bias="bq" in layer, qk_norm="q_norm" in layer, mla_layer="w_uk" in layer,
                latent_norm="latent_norm" in layer, q_lora="w_dq" in layer)


def _shard(t: torch.Tensor, axis: Optional[int], group, name: str):
    """A leaf's part on ``group.device``: the whole leaf, or a copy of the
    rank's slice on ``axis``."""
    if axis is None:
        return t.to(group.device)
    if t.shape[axis] % group.size:
        raise ValueError(f"{name} has {t.shape[axis]} rows on axis {axis}, which do not split "
                         f"into {group.size} equal shards")
    n = t.shape[axis] // group.size
    return t.narrow(axis, group.rank * n, n).to(group.device, copy=True,
                                                memory_format=torch.contiguous_format)


def shard_params(params: dict, group) -> dict:
    """The rank's shard of a full parameter tree (``init_params``,
    ``params_from_jax``), placed on ``group.device``: each sharded leaf's
    ``group.rank``-th of ``group.size`` equal contiguous slices on its
    split axis (a copy, so the full tree can be freed), each replicated
    leaf whole. The tree may lie on the CPU (or be memory-mapped), so a
    rank's card holds only its shard: the way to serve a model that one
    card cannot hold. Equal to what the JAX ``shard_params(make_mesh({"tp":
    size}), tree)`` places on the mesh's device ``rank``. A leaf outside the
    ported layer families raises ``NotImplementedError``, a width that does
    not split evenly ``ValueError``."""
    top = param_split_axes()
    if set(params) - set(top):
        raise NotImplementedError(
            f"parameters {sorted(set(params) - set(top))} are not in the ported layout")
    layers = []
    for li, layer in enumerate(params["layers"]):
        axes = param_split_axes(**_layer_flags(layer))["layers"]
        unknown = set(layer) - set(axes)
        if unknown:
            raise NotImplementedError(
                f"layer {li} has leaves {sorted(unknown)} that tensor-parallel serving does "
                "not shard (MoE and fused projections are not ported)")
        layers.append({k: _shard(v, axes[k], group, f"layers[{li}].{k}")
                       for k, v in layer.items()})
    return {k: (layers if k == "layers" else _shard(v, top[k], group, k))
            for k, v in params.items()}


def mesh_fingerprint_fields(tp_size: int = 1) -> dict[str, int]:
    """Mesh-axis world sizes for the offload cache fingerprint, as the JAX
    ``mesh_fingerprint_fields`` gives them for a mesh of ``tp_size`` tp
    ranks and no other axis (``tp_size`` 1: no mesh)."""
    return {"tp_size": tp_size, "pp_size": 1, "dp_size": 1, "sp_size": 1}
