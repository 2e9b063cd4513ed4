"""Engine checkpoint and resume for the port.

Port of ``llmd_kv_cache_tpu/models/checkpoint.py``: save and restore a
serving engine's parameters and identity, so that a restarted pod resumes
with the same weights and cache fingerprints (the same block keys: it
re-attaches to its offload store, and the indexer's entries stay valid).

A checkpoint is a directory: ``params/model.safetensors`` (the tree's
leaves by flat name, ``layers.3.wq``, through the in-repo codec) and
``engine_meta.json``, JAX's identity file with the same keys and values
(``model_name``, ``hash_seed``, the model config with tuples as lists and
``dtype`` left out, and ``"dtype": "bfloat16"``), published last and
atomically: it is the checkpoint's validity marker. The params are
safetensors where JAX writes Orbax, which the card's machine does not have.

The saved tree is always the canonical one: a fused tree is unfused on
save, by its own ``fused_interleave`` marker rather than the caller's
config, and the saved config says ``fused_interleave=1``. On load the
leaves' shapes and dtypes are held to the config's shape table
(``llama.param_layout``) before any tensor is read. A tensor-parallel
rank's tree holds only its columns; saving one raises (save the full tree
before it is sharded). A checkpoint loads into ``MiniEngine(tp=)`` like any
host tree: each rank places its own shard (``parallel.mesh.shard_params``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import asdict, fields

import torch
import torch.distributed as dist

from ..parallel.mesh import _layer_flags, param_split_axes
from ..utils.atomic_io import atomic_write_bytes, fsync_dir
from ..utils.logging import get_logger
from ..utils.safetensors import SafetensorsFile, save_file
from .llama import (
    LlamaConfig,
    Params,
    flatten_params,
    param_layout,
    resolve_device,
    unflatten_params,
    unfuse_params,
)

logger = get_logger("models.checkpoint")

_META_FILE = "engine_meta.json"
_PARAMS_FILE = os.path.join("params", "model.safetensors")


def _expected_leaves(cfg: LlamaConfig, have: dict) -> tuple[dict, set]:
    """``(flat name -> (shape, dtype), optional names)``: the leaves the
    tree must hold, ``param_layout``'s, and those a converted checkpoint
    adds that ``init_params`` does not make, where ``have`` (flat name ->
    shape) has them: Qwen2's QKV biases, q-LoRA's ``w_dq``/``q_latent_norm``
    (``wq`` then reads the q latent), and DeepSeek's ``latent_norm``, the
    one that may be absent."""
    want = {k: (tuple(shape), dtype) for k, (shape, dtype, _) in flatten_params(
        param_layout(cfg)).items()}
    hd, f32 = cfg.head_dim, torch.float32
    for li in range(cfg.num_layers):
        p = f"layers.{li}."
        if cfg.is_mla:
            want[p + "latent_norm"] = ((cfg.kv_lora_rank,), f32)
            if p + "w_dq" in have:
                q = have[p + "w_dq"][-1]
                want[p + "w_dq"] = ((cfg.hidden_size, q), cfg.dtype)
                want[p + "q_latent_norm"] = ((q,), f32)
                want[p + "wq"] = ((q,) + want[p + "wq"][0][1:], cfg.dtype)
        elif p + "bq" in have:
            for k, n in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                         ("bv", cfg.num_kv_heads)):
                want[p + k] = ((n * hd,), cfg.dtype)
    optional = {k for k in want if k.endswith(".latent_norm")}
    return want, optional


def _tree_faults(cfg: LlamaConfig, have: dict) -> list[str]:
    """What keeps ``have`` (flat name -> (shape, dtype)) from being the
    canonical tree of ``cfg``: missing, extra and mismatched leaves."""
    want, optional = _expected_leaves(cfg, {k: s for k, (s, _) in have.items()})
    faults = [f"{k} missing" for k in want if k not in have and k not in optional]
    faults += [f"{k} is not a leaf of this model" for k in have if k not in want]
    faults += [f"{k} is {list(have[k][0])} {have[k][1]}, the config gives "
               f"{list(want[k][0])} {want[k][1]}"
               for k in have if k in want and tuple(have[k]) != want[k]]
    return faults


def _shard_ways(cfg: LlamaConfig, params: Params) -> int:
    """The tp group size whose one rank's shard ``params`` is (1: not a
    shard): each leaf that differs from the config's shape only on its tp
    split axis, by the same whole factor."""
    want, _ = _expected_leaves(cfg, {k: tuple(v.shape) for k, v in
                                     flatten_params(params).items()})
    ways = set()
    for name, t in flatten_params(params).items():
        shape = tuple(t.shape)
        if name not in want or shape == want[name][0]:
            continue
        if name.startswith("layers."):
            li = int(name.split(".")[1])
            axis = param_split_axes(**_layer_flags(params["layers"][li]))["layers"].get(
                name.split(".")[2])
        else:
            axis = param_split_axes().get(name)
        full = want[name][0]
        if (axis is None or len(shape) != len(full) or shape[axis] == 0
                or full[axis] % shape[axis]
                or shape[:axis] + shape[axis + 1:] != full[:axis] + full[axis + 1:]):
            return 1
        ways.add(full[axis] // shape[axis])
    return ways.pop() if len(ways) == 1 else 1


def _dtype_name(dtype: torch.dtype) -> str:
    """JAX's spelling of a dtype: ``bfloat16``, not ``torch.bfloat16``."""
    return str(dtype).removeprefix("torch.")


def save_engine_checkpoint(path: str, params: Params, model_cfg: LlamaConfig,
                           model_name: str, hash_seed: str = "") -> None:
    """Save params + engine identity to ``path`` (a directory).

    The checkpoint stores the canonical (unfused) layout: a fused tree
    (``llama.fuse_params``) is unfused with the interleave its own
    ``fused_interleave`` marker records, which a periodic save that passes
    the pre-init config (``fused_interleave`` 1) would otherwise contradict.
    The leaves are written one at a time, each reaching the host in
    pieces (``utils.safetensors.save_file``). A tree whose leaves do not fit
    ``model_cfg`` raises ``ValueError`` before anything is written; a tensor-
    parallel rank's shard raises naming the rank (its process group's rank
    when one is initialised)."""
    path = os.path.abspath(path)
    ways = _shard_ways(model_cfg, params)
    if ways > 1:
        rank = (f"rank {dist.get_rank()} of {dist.get_world_size()}"
                if dist.is_available() and dist.is_initialized() else "a rank")
        raise ValueError(
            f"cannot save the tree of tensor-parallel {rank}: it holds one rank's columns of "
            f"a {ways}-way shard; save the full tree before it is sharded")
    marker = params.get("fused_interleave")
    unfuse_cfg = model_cfg
    if marker is not None and int(marker) != model_cfg.fused_interleave:
        unfuse_cfg = dataclasses.replace(model_cfg, fused_interleave=int(marker))
    params = unfuse_params(params, unfuse_cfg)
    # The saved tree is canonical, and the saved config says so.
    model_cfg = dataclasses.replace(model_cfg, fused_interleave=1)
    flat = flatten_params(params)
    faults = _tree_faults(model_cfg, {k: (tuple(v.shape), v.dtype) for k, v in flat.items()})
    if faults:
        raise ValueError(f"the tree does not fit its config: {'; '.join(faults[:4])}")
    # A save over an older checkpoint unpublishes it first, so that no crash
    # leaves its identity beside other params; the params land whole
    # (tmp + fsync + rename) before the identity is published.
    meta_path, params_path = os.path.join(path, _META_FILE), os.path.join(path, _PARAMS_FILE)
    if os.path.exists(meta_path):
        os.unlink(meta_path)
    os.makedirs(os.path.dirname(params_path), exist_ok=True)
    tmp = f"{params_path}.tmp.{os.getpid()}"
    save_file(flat, tmp, metadata={"format": "pt"})
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, params_path)
    fsync_dir(os.path.dirname(params_path))
    meta = {
        "model_name": model_name,
        "hash_seed": hash_seed,
        "model_config": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in asdict(model_cfg).items()
            if k != "dtype"
        },
        "dtype": _dtype_name(model_cfg.dtype),
    }
    # Durable publish (atomic_io): the meta file is the checkpoint's
    # validity marker; a crash must not leave it renamed-but-empty.
    atomic_write_bytes(
        meta_path,
        json.dumps(meta, indent=2).encode("utf-8"),
    )
    logger.info("engine checkpoint saved to %s", path)


def load_engine_checkpoint(path: str, device="cuda") -> tuple[Params, LlamaConfig, str, str]:
    """Load ``(params, model_cfg, model_name, hash_seed)`` from ``path``, the
    tree on ``device`` (the card unless the caller says otherwise). The
    leaves' shapes and dtypes are held to the config's shape table before
    any is read; a mismatch raises ``ValueError``."""
    device = resolve_device(device)
    path = os.path.abspath(path)
    with open(os.path.join(path, _META_FILE), encoding="utf-8") as f:
        meta = json.load(f)
    cfg_dict = dict(meta["model_config"])
    # Restore tuple-typed fields generically (JSON stores them as lists).
    for f in fields(LlamaConfig):
        if f.name in cfg_dict and isinstance(cfg_dict[f.name], list):
            cfg_dict[f.name] = tuple(cfg_dict[f.name])
    dtype = getattr(torch, meta.get("dtype", "bfloat16"))
    model_cfg = LlamaConfig(dtype=dtype, **cfg_dict)
    with SafetensorsFile(os.path.join(path, _PARAMS_FILE)) as f:
        faults = _tree_faults(model_cfg, {k: f.info(k)[::-1] for k in f.keys()})
        if faults:
            raise ValueError(f"checkpoint {path} does not fit its config: "
                             f"{'; '.join(faults[:4])}")
        params = unflatten_params({k: f.get_tensor(k, device) for k in f.keys()},
                                  model_cfg.num_layers)
    return params, model_cfg, meta["model_name"], meta.get("hash_seed", "")
