"""HuggingFace checkpoint loading for the port: serve a model from its own files.

Port of ``llmd_kv_cache_tpu/models/hf_loader.py``. It maps a ``transformers``
Llama / Mistral / Mixtral / Qwen2 / Qwen3 / Qwen3-MoE / DeepSeek-V2 / V3
state dict, or a checkpoint directory, onto the port's parameter tree, so the
serving engine runs real checkpoints instead of weights made from a seed.
The names, the refusals and their messages are JAX's.

The port reads a checkpoint with no ``transformers``, ``safetensors`` or
``orbax`` (the card's machine has none of them):

- ``hf_config_from_json`` reads ``config.json`` into an object with every
  attribute ``config_from_hf`` reads, each absent key taking the value that
  transformers' config class for that ``model_type`` gives it (4.57.6),
  derived values included: a ``config.json`` may leave out any key whose
  value is its class's default.
- The weights come from ``model.safetensors`` or its sharded index
  (``model.safetensors.index.json``), read by the in-repo codec
  (``utils/safetensors.py``), or from ``pytorch_model*.bin`` through
  ``torch.load(weights_only=True, mmap=True)``.
- ``load_hf_checkpoint`` converts the config first, so that a refusal raises
  before any weight is read, then goes tensor by tensor: each is mapped
  from its file alone, copied to ``device``, cast and transposed there, and
  unmapped. The host never holds the model.

Conventions (as JAX's): ``nn.Linear`` stores ``[out, in]`` and the port
multiplies ``x @ W`` with ``W [in, out]``, so every projection transposes;
projections are cast to ``cfg.dtype`` and norms stay fp32; HF's rotary is
the half-split ``rotate_half`` form the port's ``_rope`` computes, except
DeepSeek's interleaved rope, whose producing columns ``_deinterleave``
permutes; ``tie_word_embeddings`` reuses the embedding as ``lm_head``. The
output is the canonical, unfused tree ``forward`` takes; the engine's fuse
gate (``EngineConfig.fuse_projections``) fuses it where it pays.
"""

from __future__ import annotations

import json
import math
import os
from collections.abc import Mapping
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from ..utils.safetensors import SafetensorsFile, iter_index
from .llama import LlamaConfig, Params, _leaf_from_numpy, resolve_device


def _yarn_get_mscale(scale: float, m: float = 1.0) -> float:
    """transformers' yarn_get_mscale: 0.1·m·ln(scale)+1 (1.0 for ≤1)."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _convert_rope_scaling(hf_cfg: Any) -> tuple:
    """Map HF ``rope_scaling`` to ``LlamaConfig.rope_scaling``.

    ``llama3`` and ``yarn`` are implemented by ``llama._rope``; every other
    kind (linear, dynamic, ...: both the ``rope_type`` and the legacy
    ``type`` key spellings) refuses: converting would silently change every
    position's frequencies against the checkpoint's training."""
    rope_scaling = getattr(hf_cfg, "rope_scaling", None)
    if not rope_scaling:
        return ()
    kind = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
    if kind == "default":
        return ()
    if kind == "llama3":
        return ("llama3", float(rope_scaling["factor"]),
                float(rope_scaling["low_freq_factor"]),
                float(rope_scaling["high_freq_factor"]),
                float(rope_scaling["original_max_position_embeddings"]))
    if kind == "yarn":
        if not rope_scaling.get("truncate", True):
            raise NotImplementedError(
                "yarn with truncate=false (untruncated correction bounds) "
                "is not implemented")
        factor = float(rope_scaling["factor"])
        att = rope_scaling.get("attention_factor")
        mscale = rope_scaling.get("mscale")
        mscale_all = rope_scaling.get("mscale_all_dim")
        if att is None:
            if mscale and mscale_all:
                att = _yarn_get_mscale(factor, mscale) / _yarn_get_mscale(
                    factor, mscale_all)
            else:
                att = _yarn_get_mscale(factor)
        orig = (rope_scaling.get("original_max_position_embeddings")
                or hf_cfg.max_position_embeddings)
        return ("yarn", factor,
                float(rope_scaling.get("beta_fast") or 32),
                float(rope_scaling.get("beta_slow") or 1),
                float(orig), float(att))
    raise NotImplementedError(
        f"rope_scaling={rope_scaling!r} is not implemented")


def config_from_hf(hf_cfg: Any, page_size: int = 16,
                   dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """Translate a ``transformers`` config (any object with its attributes:
    a transformers config, or ``hf_config_from_json``'s).

    The per-layer attention layout follows ``hf_cfg.layer_types`` when
    present (the map transformers derives from ``max_window_layers``:
    first-N full, rest SWA); otherwise a set ``sliding_window`` (Mistral)
    means uniform SWA. Unsupported features raise instead of silently
    converting to wrong logits. ``dtype`` is a torch dtype.
    """
    n_layers = hf_cfg.num_hidden_layers

    # Architecture allowlist: families whose forward this repo implements
    # exactly. Anything else (Gemma's GELU + softcapping + scaled embeds,
    # Phi's partial rotary, ...) must refuse rather than convert to
    # silently-wrong logits.
    supported = ("llama", "mistral", "mixtral", "qwen2", "qwen3",
                 "qwen3_moe", "deepseek_v2", "deepseek_v3")
    if hf_cfg.model_type not in supported:
        raise NotImplementedError(
            f"model_type {hf_cfg.model_type!r} is not supported "
            f"(supported: {supported})")
    act = getattr(hf_cfg, "hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise NotImplementedError(
            f"hidden_act {act!r} != silu: the SwiGLU MLP here would be "
            f"silently wrong")
    rope_scaling = _convert_rope_scaling(hf_cfg)
    if hf_cfg.model_type.startswith("deepseek"):
        return _config_from_deepseek(hf_cfg, page_size, dtype,
                                     rope_scaling)
    if getattr(hf_cfg, "mlp_bias", False):
        raise NotImplementedError(
            "MLP biases are not implemented; a bias-free conversion "
            "would be silently wrong")
    moe_kw = {}
    if hf_cfg.model_type == "mixtral":
        moe_kw = dict(
            num_experts=hf_cfg.num_local_experts,
            num_experts_per_token=hf_cfg.num_experts_per_tok,
            # "dense" computes every expert with an exact one-hot top-k mix,
            # the semantics HF Mixtral implements (softmax -> top-k ->
            # renorm == top-k -> softmax); "capacity" stays opt-in.
            moe_dispatch="dense",
        )
    elif hf_cfg.model_type == "qwen3_moe":
        # HF layer rule: MoE unless listed in mlp_only_layers, gated by
        # decoder_sparse_step (modeling_qwen3_moe decoder layer init).
        step = getattr(hf_cfg, "decoder_sparse_step", 1) or 1
        only = set(getattr(hf_cfg, "mlp_only_layers", ()) or ())
        moe_layers = tuple(
            i for i in range(n_layers)
            if i not in only and (i + 1) % step == 0)
        if moe_layers:
            moe_kw = dict(
                num_experts=hf_cfg.num_experts,
                num_experts_per_token=hf_cfg.num_experts_per_tok,
                moe_layers=moe_layers,
                moe_intermediate_size=hf_cfg.moe_intermediate_size,
                moe_router=("softmax_topk",
                            int(bool(hf_cfg.norm_topk_prob))),
                moe_dispatch="dense",
            )
    elif getattr(hf_cfg, "num_experts", 0) or getattr(
            hf_cfg, "num_local_experts", 0):
        raise NotImplementedError(
            "MoE checkpoint mapping is only implemented for mixtral and "
            "qwen3_moe")

    layer_types = getattr(hf_cfg, "layer_types", None)
    if layer_types:
        unknown = set(layer_types) - {"full_attention", "sliding_attention"}
        if unknown:
            raise NotImplementedError(f"layer types {unknown} unsupported")
        swa = tuple(i for i, t in enumerate(layer_types)
                    if t == "sliding_attention")
        window = getattr(hf_cfg, "sliding_window", None) if swa else None
    else:
        window = getattr(hf_cfg, "sliding_window", None)
        # Qwen-family configs carry a sliding_window value gated by a
        # separate use_sliding_window flag: honour the gate.
        if not getattr(hf_cfg, "use_sliding_window", True):
            window = None
        swa = tuple(range(n_layers)) if window else ()

    head_dim = getattr(hf_cfg, "head_dim", None) or (
        hf_cfg.hidden_size // hf_cfg.num_attention_heads)
    return LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_layers=n_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_key_value_heads,
        head_dim=head_dim,
        intermediate_size=hf_cfg.intermediate_size,
        rope_theta=float(getattr(hf_cfg, "rope_theta", 10000.0)),
        norm_eps=float(hf_cfg.rms_norm_eps),
        page_size=page_size,
        dtype=dtype,
        sliding_window=window,
        swa_layers=swa,
        qk_norm=hf_cfg.model_type in ("qwen3", "qwen3_moe"),
        rope_scaling=rope_scaling,
        **moe_kw,
    )


def _config_from_deepseek(hf_cfg: Any, page_size: int, dtype: torch.dtype,
                          rope_scaling: tuple = ()) -> LlamaConfig:
    """DeepSeek-V2/V3 -> absorbed-MLA config.

    Supported subset: MoE only for deepseek_v3 (dense layers below
    ``first_k_dense_replace``) and ``v_head_dim == qk_nope_head_dim`` (the
    shared head_dim here); q-LoRA (the full V2/V3 form) and the direct q
    projection (V2-Lite) both convert.
    """
    if hf_cfg.v_head_dim != hf_cfg.qk_nope_head_dim:
        raise NotImplementedError(
            f"v_head_dim {hf_cfg.v_head_dim} != qk_nope_head_dim "
            f"{hf_cfg.qk_nope_head_dim}: this model shares one head_dim")
    n_layers = hf_cfg.num_hidden_layers
    moe_kw = {}
    first_dense = getattr(hf_cfg, "first_k_dense_replace", 0)
    if getattr(hf_cfg, "n_routed_experts", None) and n_layers > first_dense:
        if hf_cfg.model_type != "deepseek_v3":
            raise NotImplementedError(
                "MoE conversion is implemented for deepseek_v3 only "
                "(V2's softmax/greedy router differs)")
        if getattr(hf_cfg, "topk_method", "noaux_tc") not in (
                "noaux_tc", None):
            raise NotImplementedError(
                f"topk_method {hf_cfg.topk_method!r} unsupported")
        moe_kw = dict(
            num_experts=hf_cfg.n_routed_experts,
            num_experts_per_token=hf_cfg.num_experts_per_tok,
            moe_layers=tuple(range(first_dense, n_layers)),
            n_shared_experts=hf_cfg.n_shared_experts,
            moe_intermediate_size=hf_cfg.moe_intermediate_size,
            moe_router=("deepseek_v3", hf_cfg.n_group,
                        hf_cfg.topk_group,
                        int(bool(hf_cfg.norm_topk_prob)),
                        float(hf_cfg.routed_scaling_factor)),
            moe_dispatch="dense",
        )
    # DeepSeek yarn: the generic cos/sin attention factor applies through
    # rope_scaling; for deepseek_v3 only, mscale_all_dim also multiplies the
    # softmax scale by mscale^2 (DeepseekV3Attention.__init__; V2's
    # attention has no such term).
    scale_mult = 1.0
    hf_rs = getattr(hf_cfg, "rope_scaling", None)
    if (rope_scaling and hf_cfg.model_type == "deepseek_v3"
            and hf_rs and hf_rs.get("mscale_all_dim")):
        m = _yarn_get_mscale(float(hf_rs["factor"]),
                             float(hf_rs["mscale_all_dim"]))
        scale_mult = m * m
    return LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_layers=n_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_attention_heads,
        head_dim=hf_cfg.qk_nope_head_dim,
        intermediate_size=hf_cfg.intermediate_size,
        rope_theta=float(getattr(hf_cfg, "rope_theta", 10000.0)),
        norm_eps=float(hf_cfg.rms_norm_eps),
        page_size=page_size,
        dtype=dtype,
        kv_lora_rank=hf_cfg.kv_lora_rank,
        qk_rope_head_dim=hf_cfg.qk_rope_head_dim,
        rope_scaling=rope_scaling,
        softmax_scale_mult=scale_mult,
        **moe_kw,
    )


# ---------------------------------------------------------------------------
# config.json without transformers
# ---------------------------------------------------------------------------

# Each supported config class's defaults in transformers 4.57.6 (the
# keyword defaults of its __init__, and PretrainedConfig's where the class
# passes them on), for the attributes a conversion reads.
_BASE = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=32, num_attention_heads=32, hidden_act="silu",
             max_position_embeddings=2048, rms_norm_eps=1e-6, tie_word_embeddings=False,
             rope_theta=10000.0)
# Mistral's and Mixtral's classes have no rope_scaling attribute.
_ROPE = dict(rope_scaling=None)
_QWEN = dict(_ROPE, vocab_size=151936, intermediate_size=22016, num_key_value_heads=32,
             max_position_embeddings=32768, use_sliding_window=False, sliding_window=4096,
             max_window_layers=28, layer_types=None)
_DEFAULTS = {
    "llama": dict(_ROPE, num_key_value_heads=None, head_dim=None, mlp_bias=False,
                  attention_bias=False),
    "mistral": dict(intermediate_size=14336, num_key_value_heads=8, head_dim=None,
                    max_position_embeddings=4096 * 32, sliding_window=4096),
    "mixtral": dict(intermediate_size=14336, num_key_value_heads=8, head_dim=None,
                    max_position_embeddings=4096 * 32, rms_norm_eps=1e-5, rope_theta=1e6,
                    sliding_window=None, num_experts_per_tok=2, num_local_experts=8),
    "qwen2": dict(_QWEN),
    "qwen3": dict(_QWEN, head_dim=128, attention_bias=False),
    "qwen3_moe": dict(_ROPE, vocab_size=151936, hidden_size=2048, intermediate_size=6144,
                      num_hidden_layers=24, num_key_value_heads=4,
                      max_position_embeddings=32768, attention_bias=False,
                      use_sliding_window=False, sliding_window=4096, decoder_sparse_step=1,
                      moe_intermediate_size=768, num_experts_per_tok=8, num_experts=128,
                      norm_topk_prob=False, mlp_only_layers=None),
    "deepseek_v2": dict(_ROPE, num_key_value_heads=None, attention_bias=False, mlp_bias=False,
                        first_k_dense_replace=0, kv_lora_rank=512, q_lora_rank=1536,
                        n_group=None, n_routed_experts=64, n_shared_experts=2,
                        qk_nope_head_dim=128, qk_rope_head_dim=64, routed_scaling_factor=1.0,
                        topk_group=None, topk_method="greedy", v_head_dim=128,
                        num_experts_per_tok=None, norm_topk_prob=False,
                        moe_intermediate_size=1407),
    "deepseek_v3": dict(_ROPE, vocab_size=129280, hidden_size=7168, intermediate_size=18432,
                        moe_intermediate_size=2048, num_hidden_layers=61,
                        num_attention_heads=128, num_key_value_heads=128, n_shared_experts=1,
                        n_routed_experts=256, routed_scaling_factor=2.5, kv_lora_rank=512,
                        q_lora_rank=1536, qk_rope_head_dim=64, v_head_dim=128,
                        qk_nope_head_dim=128, n_group=8, topk_group=4, num_experts_per_tok=8,
                        first_k_dense_replace=3, norm_topk_prob=True,
                        max_position_embeddings=4096, rope_interleave=True,
                        attention_bias=False),
}


def hf_config_from_json(path_or_dict) -> SimpleNamespace:
    """Read a checkpoint's ``config.json`` (a path to the file or to its
    directory, or the parsed dict) into attributes, as transformers' config
    class for its ``model_type`` would: absent keys take the class's defaults, and the
    values the class derives are derived (``num_key_value_heads`` from
    ``num_attention_heads``; Llama's ``head_dim`` from hidden / heads;
    Qwen2's and Qwen3's ``layer_types`` from ``max_window_layers``, and
    their ``sliding_window`` gated on ``use_sliding_window``; DeepSeek's
    ``head_dim`` = ``qk_rope_head_dim``; ``rope_scaling``'s legacy ``type``
    copied to ``rope_type``). Keys the class does not name are kept as
    they are, as a transformers config keeps them. An unknown
    ``model_type`` keeps the common defaults, and ``config_from_hf`` then
    refuses it."""
    if isinstance(path_or_dict, Mapping):
        raw = dict(path_or_dict)
    else:
        path = os.fspath(path_or_dict)
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
    model_type = raw.get("model_type")
    if not model_type:
        raise ValueError("config.json names no model_type")
    attrs = {**_BASE, **_DEFAULTS.get(model_type, {}), **raw}
    if attrs.get("rope_scaling") is not None:
        rs = dict(attrs["rope_scaling"])
        if "type" in rs:
            rs["rope_type"] = rs["type"]
        if model_type == "deepseek_v3":
            rs.update({k: float(rs[k]) for k in ("beta_fast", "beta_slow", "factor")
                       if k in rs})
        attrs["rope_scaling"] = rs
    if attrs.get("num_key_value_heads") is None and model_type != "qwen3_moe":
        attrs["num_key_value_heads"] = attrs["num_attention_heads"]
    if model_type == "llama" and attrs.get("head_dim") is None:
        attrs["head_dim"] = attrs["hidden_size"] // attrs["num_attention_heads"]
    if model_type in ("qwen2", "qwen3", "qwen3_moe") and not attrs["use_sliding_window"]:
        attrs["sliding_window"] = None
    if model_type in ("qwen2", "qwen3") and attrs.get("layer_types") is None:
        attrs["layer_types"] = [
            "sliding_attention"
            if attrs["sliding_window"] is not None and i >= attrs["max_window_layers"]
            else "full_attention"
            for i in range(attrs["num_hidden_layers"])]
    if model_type == "qwen3_moe" and attrs.get("mlp_only_layers") is None:
        attrs["mlp_only_layers"] = []
    if model_type == "deepseek_v2" or (model_type == "deepseek_v3" and "head_dim" not in raw):
        # V2 sets it after the base class takes the file's keys, V3 before.
        attrs["head_dim"] = attrs["qk_rope_head_dim"]
    if model_type == "deepseek_v3":
        attrs["qk_head_dim"] = attrs["qk_nope_head_dim"] + attrs["qk_rope_head_dim"]
    return SimpleNamespace(**attrs)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _deinterleave(w: torch.Tensor, dr: int) -> torch.Tensor:
    """Permute the trailing ``dr`` output columns from HF DeepSeek's
    interleaved-rotary layout (pairs (2i, 2i+1)) to this repo's half-split
    layout (pairs (i, i+dr/2)).

    Rotations act on activations, so permuting the columns that produce the
    rope dims makes half-split rope equal interleaved rope up to the same
    permutation on both q_pe and k_pe, and their dot product (the only
    consumer) is permutation-invariant.
    """
    order = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)]).to(w.device)
    out = w.clone()
    out[..., -dr:] = w[..., -dr:].index_select(-1, order)
    return out


def params_from_hf(state_dict: Mapping[str, Any], cfg: LlamaConfig,
                   mla_rope_interleaved: bool = True, device="cuda") -> Params:
    """Build the parameter tree from an HF Llama-architecture state dict, on
    ``device`` (the card unless the caller says otherwise).

    Accepts torch tensors or numpy arrays (``state_dict`` may read each
    tensor when it is looked up, as ``load_hf_checkpoint``'s does). Norm
    scales stay fp32; projections are transposed to ``x @ W`` and cast to
    ``cfg.dtype``, each tensor upcast to fp32 first, as JAX's conversion
    does. ``mla_rope_interleaved`` mirrors DeepSeek's ``rope_interleave``
    (True in both HF implementations; V3 exposes the flag): when set, the
    rope-producing weight columns are permuted (``_deinterleave``). A
    tensor the tree has no place for raises (non-persistent rotary buffers
    aside).
    """
    device = resolve_device(device)
    consumed: set = set()

    def get(name):
        # A copy on the device: the tree never shares memory with the
        # caller's state dict.
        consumed.add(name)
        t = state_dict[name]
        if not isinstance(t, torch.Tensor):
            t = _leaf_from_numpy(np.asarray(t), "cpu")
        t = t.detach().to(device, copy=True)
        if t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            t = t.float()  # as JAX upcasts; from these three the cast is the same
        return t

    def cast(t):
        return t.to(cfg.dtype).contiguous()

    def proj(name):  # [out, in] -> [in, out], model dtype
        return cast(get(name).t())

    def norm(name):  # fp32 scale vector
        return get(name).to(torch.float32).contiguous()

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layer = {
            "attn_norm": norm(p + "input_layernorm.weight"),
            "mlp_norm": norm(p + "post_attention_layernorm.weight"),
            "wo": proj(p + "self_attn.o_proj.weight"),
        }
        if p + "mlp.gate.weight" in state_dict:
            # DeepSeek / Qwen3-MoE layer: router + routed experts. The router
            # kind decides the extra tensors: deepseek_v3 requires the
            # e_score_correction bias and the shared expert (a truncated
            # checkpoint fails here, naming the tensor); softmax_topk
            # (Qwen3-MoE) has neither.
            E = cfg.num_experts
            deepseek = cfg.moe_router and cfg.moe_router[0] == "deepseek_v3"
            layer["router"] = proj(p + "mlp.gate.weight")
            if deepseek:
                layer["router_bias"] = norm(p + "mlp.gate.e_score_correction_bias")
            for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                                 ("w_down", "down_proj")):
                layer[ours] = torch.stack([
                    proj(p + f"mlp.experts.{e}.{theirs}.weight") for e in range(E)])
            if deepseek:
                for ours, theirs in (("w_gate_sh", "gate_proj"), ("w_up_sh", "up_proj"),
                                     ("w_down_sh", "down_proj")):
                    layer[ours] = proj(p + f"mlp.shared_experts.{theirs}.weight")
        elif p + "block_sparse_moe.gate.weight" in state_dict:  # Mixtral
            E = cfg.num_experts
            layer["router"] = proj(p + "block_sparse_moe.gate.weight")
            for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
                layer[ours] = torch.stack([
                    proj(p + f"block_sparse_moe.experts.{e}.{theirs}.weight")
                    for e in range(E)])
        else:
            layer["w_gate"] = proj(p + "mlp.gate_proj.weight")
            layer["w_up"] = proj(p + "mlp.up_proj.weight")
            layer["w_down"] = proj(p + "mlp.down_proj.weight")
        if cfg.is_mla:
            # DeepSeek: q either direct (V2-Lite) or through the q-LoRA
            # latent; the fused latent down-projection, the RMS-normed
            # latent, and the fused k_nope/v up-projection split into the
            # absorbed form.
            r, dr, hd = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.head_dim
            H = cfg.num_heads
            if p + "self_attn.q_a_proj.weight" in state_dict:  # q-LoRA
                layer["w_dq"] = proj(p + "self_attn.q_a_proj.weight")
                layer["q_latent_norm"] = norm(p + "self_attn.q_a_layernorm.weight")
                wq = get(p + "self_attn.q_b_proj.weight").t()
            else:
                wq = get(p + "self_attn.q_proj.weight").t()  # [h|q_lora, H*(hd+dr)]
            wq = wq.reshape(wq.shape[0], H, hd + dr)
            if mla_rope_interleaved:
                wq = _deinterleave(wq, dr)
            layer["wq"] = cast(wq.reshape(wq.shape[0], H * (hd + dr)))
            kva = get(p + "self_attn.kv_a_proj_with_mqa.weight").t()
            layer["w_dkv"] = cast(kva[:, :r])
            k_rope = kva[:, r:]
            if mla_rope_interleaved:
                k_rope = _deinterleave(k_rope, dr)
            layer["w_kr"] = cast(k_rope)
            layer["latent_norm"] = norm(p + "self_attn.kv_a_layernorm.weight")
            kvb = get(p + "self_attn.kv_b_proj.weight").reshape(H, 2 * hd, r)  # [H, nope+v, r]
            layer["w_uk"] = cast(kvb[:, :hd, :].transpose(1, 2))
            layer["w_uv"] = cast(kvb[:, hd:, :].transpose(1, 2))
        else:
            layer["wq"] = proj(p + "self_attn.q_proj.weight")
            layer["wk"] = proj(p + "self_attn.k_proj.weight")
            layer["wv"] = proj(p + "self_attn.v_proj.weight")
            if cfg.qk_norm:  # Qwen3: per-head RMS on Q/K before RoPE
                layer["q_norm"] = norm(p + "self_attn.q_norm.weight")
                layer["k_norm"] = norm(p + "self_attn.k_norm.weight")
            if p + "self_attn.q_proj.bias" in state_dict:  # Qwen2 lineage
                for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                    layer[ours] = cast(get(p + f"self_attn.{theirs}.bias"))
        layers.append(layer)

    embed = cast(get("model.embed_tokens.weight"))
    if "lm_head.weight" in state_dict:
        lm_head = proj("lm_head.weight")
    else:  # tie_word_embeddings
        lm_head = embed.t().contiguous()
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": norm("model.norm.weight"),
        "lm_head": lm_head,
    }
    # Every tensor the checkpoint carries must have landed in the tree
    # (modulo non-persistent rotary buffers older exports include): a
    # leftover weight means an architectural feature this model lacks, and
    # ignoring it would serve silently-wrong logits.
    leftover = [k for k in state_dict
                if k not in consumed and "rotary_emb" not in k]
    if leftover:
        raise NotImplementedError(
            f"checkpoint carries unmapped tensors ({leftover[:4]}…) — "
            f"this architecture has features the conversion would drop")
    return params


class CheckpointTensors(Mapping):
    """The tensors of an HF checkpoint directory by name, each read when it
    is looked up and copied to ``device``: ``model.safetensors`` or its
    sharded ``model.safetensors.index.json`` through the in-repo codec
    (preferred, as transformers prefers it), else ``pytorch_model.bin`` or
    its ``pytorch_model.bin.index.json`` through ``torch.load(weights_only=
    True, mmap=True)``. ``skip`` names tensors to leave out. Close it (or
    use it as a context manager) to unmap the files."""

    def __init__(self, path: str, device="cpu", skip=()):
        self.device = torch.device(device)
        self._open: dict[str, Any] = {}
        files: dict[str, str] = {}
        for index, single in (("model.safetensors.index.json", "model.safetensors"),
                              ("pytorch_model.bin.index.json", "pytorch_model.bin")):
            if os.path.exists(os.path.join(path, index)):
                files = dict(iter_index(os.path.join(path, index)))
            elif os.path.exists(os.path.join(path, single)):
                files = {name: os.path.join(path, single)
                         for name in self._file(os.path.join(path, single)).keys()}
            if files:
                break
        else:
            raise FileNotFoundError(
                f"{path}: no model.safetensors, model.safetensors.index.json, "
                "pytorch_model.bin or pytorch_model.bin.index.json")
        self._where = {k: f for k, f in files.items() if k not in set(skip)}

    def _file(self, file: str):
        if file not in self._open:
            if file.endswith(".safetensors"):
                self._open[file] = SafetensorsFile(file)
            else:
                self._open[file] = torch.load(file, map_location="cpu", weights_only=True,
                                              mmap=True)
        return self._open[file]

    def __getitem__(self, name: str) -> torch.Tensor:
        f = self._file(self._where[name])
        if isinstance(f, SafetensorsFile):
            return f.get_tensor(name, self.device)
        t = f[name]
        return t.clone() if self.device.type == "cpu" else t.to(self.device)

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        for f in self._open.values():
            if isinstance(f, SafetensorsFile):
                f.close()
        self._open.clear()

    def __enter__(self) -> "CheckpointTensors":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_hf_checkpoint(path: str, page_size: int = 16, dtype: torch.dtype = torch.bfloat16,
                       device="cuda") -> tuple[LlamaConfig, Params]:
    """Load a local HF checkpoint directory -> ``(LlamaConfig, Params)``,
    the tree on ``device`` (the card unless the caller says otherwise).

    The config is read and converted first, so that a refusal raises before
    any weight is read. The weights are then read tensor by tensor, each
    copied to ``device`` and converted there, so the host holds about one
    tensor at a time. A tied checkpoint (``tie_word_embeddings``) serves its
    embedding as ``lm_head``, as transformers ties it, whether or not the
    files carry an ``lm_head.weight``. Nothing is downloaded: the
    checkpoint must be on disk.
    """
    device = resolve_device(device)
    hf_cfg = hf_config_from_json(path)
    cfg = config_from_hf(hf_cfg, page_size=page_size, dtype=dtype)
    skip = ("lm_head.weight",) if getattr(hf_cfg, "tie_word_embeddings", False) else ()
    with CheckpointTensors(path, device=device, skip=skip) as tensors:
        params = params_from_hf(
            tensors, cfg, mla_rope_interleaved=getattr(hf_cfg, "rope_interleave", True),
            device=device)
    return cfg, params
