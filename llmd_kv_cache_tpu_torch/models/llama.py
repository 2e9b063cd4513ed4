"""Dense GQA and absorbed-MLA Llama over a paged KV cache, in PyTorch.

Port of the dense path of ``llmd_kv_cache_tpu/models/llama.py``: RMSNorm,
half-split RoPE with fp32 angles (plain, llama3- or yarn-scaled),
grouped-query attention over the paged pool ``[layers, pages, kv_heads,
page_size, head_dim]``, and the unfused SwiGLU MLP. DeepSeek-style
multi-head latent attention (``LlamaConfig.kv_lora_rank > 0``) runs in its
absorbed form, as in JAX: each token caches one latent row (``[c_kv ;
rope key]``, plus ``latent_pad`` zeros) in a single-head pool whose V pool
has width 0, the query is absorbed through ``w_uk``, attention is
multi-query over the latent with the K pool passed as K and V, and the
output is un-absorbed through ``w_uv``. Parameters are a plain dict
mirroring the JAX tree, with the same ``x @ W`` orientation (``W`` is
``[in, out]``), so ``params_from_jax`` converts leaf by leaf with no
transposes.

One step serves prefill and decode: queries at logical positions
``ctx_lens + i`` attend to everything already in the paged cache plus
themselves. Where JAX donated the caches to the jit, this port writes the
new K/V into them in place (``scatter_kv_pages`` on each layer's view) and
returns the same tensors. ``forward_ragged`` serves a mixed step (decode
rows and a prefill chunk on one flat token axis) in one attention launch
per layer. ``forward_decode_steps`` runs a fused decode burst: up to
``steps`` greedy tokens a row, attending over the frozen paged cache plus a
burst-local KV tail, scattered into the pages once at the end. Attention
runs through the Hopper kernels in ``ops.cuda_paged_attention``; for CPU
tensors those wrappers run the plain version.

The model families of the JAX package's attention layouts ride every entry
point: a sliding window (``sliding_window`` on the layers in
``swa_layers``: Mistral's on every layer), StreamingLLM sinks on a uniform
window (``attention_sinks``), Qwen3's per-head QK-norm (``qk_norm``) and
Qwen2's QKV biases (``bq``/``bk``/``bv`` in the tree). Each layer hands its
own window and the sinks to the kernels. A hybrid model (full-attention and
SWA layers mixed, Gemma-style) keeps two page pools, each group's layers
stacked in ``group_layers(g)`` order (``init_kv_cache_hybrid``), and runs
through ``forward_hybrid`` and ``forward_decode_steps_hybrid``, each layer
on its group's pool, page table and window.

Tensor parallelism (``parallel/``): ``forward``, ``forward_decode`` and
``forward_prefill`` take a rank's ``tp`` group and its Megatron shard of the
parameters (``parallel.mesh.shard_params``) over its part of the pool
(``init_kv_cache(..., tp_size=)``). Head counts come from the shard's
shapes; the vocab-sharded embedding is a masked local lookup summed over
the ranks, each layer sums its ``wo`` and ``w_down`` products over them
(one all-reduce each), the logits are the ranks' ``lm_head`` columns
gathered, and attention runs through the sharded wrappers on the rank's
heads. An MLA rank computes the whole latent (``w_dkv``, ``w_kr`` and
``latent_norm`` are replicated) and writes it to its whole copy of the
pool. Without a group nothing of this runs.

Mixture-of-experts MLPs (``num_experts > 0``) are the JAX ones, keyed on
each layer's leaves (``router`` present: an expert layer), so dense-first
layouts mix layer kinds: the softmax top-k router with the exact ``dense``
dispatch (every expert over every token, a one-hot mix) or GShard's
``capacity`` dispatch (fixed ``[experts, capacity, hidden]`` buffers,
earlier tokens win slots, the rest drop), and DeepSeek-V3's sigmoid router
(bias-corrected, group-limited choice, unbiased weights) with its shared
expert. All are batched GEMMs and einsums over the stacked experts at
static shapes, with no host read, so a burst's CUDA graph holds them; the
products stay in the model dtype and only the router, activation and mix
math is fp32, as in JAX. Ties in a top-k go to the lower expert index, as
``jax.lax.top_k`` breaks them. Under tp each rank holds every expert's
``1/tp`` of the inner width (``w_gate``/``w_up`` split on their last axis,
``w_down`` on its middle one, the shared expert as a dense MLP) and returns
its partial sum of the experts' outputs, which the all-reduce after the MLP
adds; the router and its bias are replicated, so every rank routes alike.

Fused projections (``fuse_params``, the JAX serving-time transform): one
``[h, Nq + Nk + Nv]`` product ``w_qkv`` (+ ``b_qkv``) in place of three,
``w_mla_in`` in place of an MLA layer's ``wq|w_dq``, ``w_dkv`` and ``w_kr``,
``w_gate_up`` on a dense MLP and ``w_gate_up_sh`` on DeepSeek's shared
expert; every entry point takes both layouts. Under tp the engine fuses in
the per-rank interleaved column order (``fused_interleave`` = tp), so that a
rank's contiguous column shard is its own ``[q_r | k_r | v_r]`` block in the
canonical order at the rank's widths: a rank splits its fused output with
an interleave of ``fused_interleave / tp`` (1), where JAX, one program over
the mesh, splits the global output with ``fused_interleave``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda_paged_attention import (
    cuda_paged_decode_attention,
    cuda_paged_prefill_attention,
    cuda_paged_ragged_attention,
    plan_ragged_attention,
    sharded_paged_decode_attention,
    sharded_paged_prefill_attention,
)
from ..ops.kv_pages import scatter_kv_pages, scatter_kv_pages_ragged, to_kv_dtype
from ..ops.paged_attention import paged_attention, paged_ragged_attention, tp_pool_heads

Params = dict[str, Any]

_LAYER_KEYS = frozenset(
    ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down"))
# An MLA layer: the latent down-projections and per-head up-projections in
# place of wk/wv, and the norms a DeepSeek checkpoint carries (the latent's
# kv_a_layernorm, and q-LoRA's down-projection and its norm).
_MLA_LAYER_KEYS = frozenset(
    ("attn_norm", "wq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo", "mlp_norm",
     "w_gate", "w_up", "w_down", "latent_norm", "w_dq", "q_latent_norm"))
# Qwen2's QKV projection biases, and Qwen3's per-head QK-norm weights.
_BIAS_KEYS = frozenset(("bq", "bk", "bv"))
_QK_NORM_KEYS = frozenset(("q_norm", "k_norm"))
# An expert layer's router (its w_gate/w_up/w_down stacked over the
# experts), and DeepSeek-V3's router bias and shared expert.
_MOE_KEYS = frozenset(("router",))
_DEEPSEEK_MOE_KEYS = frozenset(("router_bias", "w_gate_sh", "w_up_sh", "w_down_sh"))
# fuse_params' leaves, each with the leaves it replaces: a layer holds one
# or the other (MLA's w_mla_in takes wq's place without q-LoRA, w_dq's with).
_FUSED_PARTS = {"w_qkv": ("wq", "wk", "wv"), "b_qkv": ("bq", "bk", "bv"),
                "w_mla_in": ("w_dkv", "w_kr"), "w_gate_up": ("w_gate", "w_up"),
                "w_gate_up_sh": ("w_gate_sh", "w_up_sh")}
_FUSED_KEYS = tuple(_FUSED_PARTS)


@dataclass(frozen=True)
class LlamaConfig:
    """Mirror of the JAX ``LlamaConfig`` for the dense and absorbed-MLA
    paths, the attention layouts of the model families (sliding windows,
    sinks, QK-norm, hybrid) and mixture-of-experts MLPs; ``dtype`` is a
    torch dtype (the JAX field holds a ``jnp`` dtype). The fields and their
    validation are the JAX ones."""

    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 64
    intermediate_size: int = 1408
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    page_size: int = 16
    dtype: torch.dtype = torch.bfloat16
    # Layers listed in swa_layers attend over a sliding window of
    # sliding_window keys (Mistral: every layer; Gemma: some of them, which
    # makes the model hybrid); the rest attend over everything.
    sliding_window: int | None = None
    swa_layers: tuple = ()
    # Qwen3: per-head RMSNorm of Q and K over head_dim, before RoPE.
    qk_norm: bool = False
    # Mixture of experts: 0 = a dense MLP. "capacity" dispatches the top-k
    # choices into per-expert buffers of ceil(T·k/E · moe_capacity_factor)
    # tokens (over-capacity assignments drop; the residual passes); "dense"
    # runs every expert over every token with a one-hot mix (exact).
    num_experts: int = 0
    num_experts_per_token: int = 2
    moe_dispatch: str = "capacity"
    moe_capacity_factor: float = 2.0
    # DeepSeek layouts: moe_layers lists the expert layers (empty: all of
    # them when num_experts > 0); n_shared_experts and moe_intermediate_size
    # size the always-on shared expert and the routed experts' inner width;
    # moe_router is ("deepseek_v3", n_group, topk_group, norm_topk_prob,
    # routed_scaling_factor), the sigmoid group-limited router with its
    # router_bias leaf, or ("softmax_topk", norm_topk_prob) (Qwen3-MoE).
    moe_layers: tuple = ()
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    moe_router: tuple = ()
    # Multi-head latent attention (DeepSeek-V2/V3), served absorbed: each
    # token caches a latent of kv_lora_rank dims plus a decoupled-RoPE key
    # of qk_rope_head_dim dims shared across heads. 0 = standard attention.
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    # Zeros appended to the latent cache row (the TPU's 128-lane layout;
    # DeepSeek-V2 shapes set 64 for 640). Part of the cache layout; the
    # attention is invariant to it up to fp rounding of the scale.
    latent_pad: int = 0
    # The TPU decode kernel's choice of how one VMEM buffer feeds its two
    # matmuls ("copy" or "reuse"). Kept and validated so configs round-trip;
    # the CUDA latent kernels (decode, prefill and the ragged kernel's
    # shared_kv arm) have one form, each staged chunk feeding both products
    # from shared memory, and ignore it.
    mla_decode_stream: str = "copy"
    # The column order of fused projections (fuse_params), set by the
    # engine at serving time: 1 = canonical [q|k|v] / [gate|up]; t > 1 =
    # per-rank interleaved [q_0|k_0|v_0 | q_1|k_1|v_1 | ...], part_i rank
    # i's contiguous slice, so a uniform t-way column split hands each rank
    # its own fused block (the canonical order would straddle q/k/v).
    fused_interleave: int = 1
    # () = plain RoPE; ("llama3", factor, low_freq_factor, high_freq_factor,
    # original_max) or ("yarn", factor, beta_fast, beta_slow, original_max,
    # attention_factor), as in transformers' modeling_rope_utils.
    rope_scaling: tuple = ()
    # DeepSeek-V3 yarn's mscale^2 on the softmax scale (MLA only).
    softmax_scale_mult: float = 1.0
    # StreamingLLM: with a sliding window, the first attention_sinks
    # positions stay attendable past it (the sink_full_attention spec kind).
    # Uniform SWA only: a hybrid pool would reclaim the sink blocks.
    attention_sinks: int = 0

    def __post_init__(self):
        if self.num_experts > 0 and self.num_experts_per_token > self.num_experts:
            raise ValueError(
                f"num_experts_per_token ({self.num_experts_per_token}) exceeds "
                f"num_experts ({self.num_experts})"
            )
        if self.kv_lora_rank > 0:
            if self.qk_rope_head_dim <= 0 or self.qk_rope_head_dim % 2:
                raise ValueError(
                    "MLA needs an even qk_rope_head_dim > 0 (decoupled-RoPE "
                    f"key dims), got {self.qk_rope_head_dim}")
            if self.sliding_window is not None or self.swa_layers:
                raise ValueError(
                    "sliding_window_mla is not implemented: MLA configs "
                    "cannot set sliding_window/swa_layers")
            if self.qk_norm:
                raise ValueError("qk_norm is not defined for MLA configs")
        if self.moe_router:
            kind = self.moe_router[0]
            if kind == "deepseek_v3" and len(self.moe_router) == 5:
                if self.moe_dispatch != "dense":
                    raise ValueError(
                        "the deepseek_v3 router is implemented for the "
                        "exact 'dense' dispatch only")
                n_group = self.moe_router[1]
                if n_group < 1 or self.num_experts % n_group != 0:
                    raise ValueError(
                        "num_experts must divide by n_group >= 1")
                if self.num_experts // n_group < 2:
                    raise ValueError(
                        "deepseek_v3 group scoring sums each group's "
                        "top-2 corrected scores: groups need >= 2 experts")
            elif kind == "softmax_topk" and len(self.moe_router) == 2:
                pass  # Qwen3-MoE: the classic router, norm_topk_prob in [1]
            else:
                raise ValueError(
                    "moe_router must be ('deepseek_v3', n_group, "
                    "topk_group, norm_topk_prob, factor) or "
                    f"('softmax_topk', norm_topk_prob); got "
                    f"{self.moe_router!r}")
        if self.moe_layers and not all(
                0 <= i < self.num_layers for i in self.moe_layers):
            raise ValueError("moe_layers indices out of range")
        if self.rope_scaling:
            ok = (self.rope_scaling[0] == "llama3"
                  and len(self.rope_scaling) == 5) or (
                 self.rope_scaling[0] == "yarn"
                 and len(self.rope_scaling) == 6)
            if not ok:
                raise ValueError(
                    "rope_scaling must be ('llama3', factor, low_freq_factor,"
                    " high_freq_factor, original_max) or ('yarn', factor, "
                    "beta_fast, beta_slow, original_max, attention_factor); "
                    f"got {self.rope_scaling!r}")
        if self.softmax_scale_mult != 1.0 and not self.is_mla:
            raise ValueError(
                "softmax_scale_mult is a DeepSeek-yarn (MLA) knob")
        if self.mla_decode_stream not in ("copy", "reuse"):
            raise ValueError(
                "mla_decode_stream must be 'copy' or 'reuse', got "
                f"{self.mla_decode_stream!r}")
        if self.mla_decode_stream != "copy" and not self.is_mla:
            raise ValueError("mla_decode_stream is an MLA knob")
        if self.latent_pad:
            if not self.is_mla:
                raise ValueError("latent_pad only applies to MLA configs")
            if self.latent_pad < 0:
                raise ValueError("latent_pad must be >= 0")
        if self.fused_interleave < 1:
            raise ValueError("fused_interleave must be >= 1")
        if self.fused_interleave > 1 and self.is_mla:
            # The MLA fused block mixes head-sharded (wq/w_dq) and
            # replicated (w_dkv/w_kr) columns: no uniform interleave shards
            # it, so MLA serves unfused under tp.
            raise ValueError(
                "fused_interleave > 1 is not supported for MLA configs")
        if self.attention_sinks:
            if self.sliding_window is None:
                raise ValueError("attention_sinks requires sliding_window")
            if self.is_hybrid:
                raise ValueError(
                    "attention sinks need a uniform-SWA model "
                    "(sink_full_attention); hybrid layouts would reclaim "
                    "sink blocks from the window-bounded SWA pool")

    def moe_layer(self, layer_idx: int) -> bool:
        """Whether the layer's MLP is a mixture of experts (every layer when
        ``moe_layers`` is empty)."""
        return self.num_experts > 0 and (not self.moe_layers or layer_idx in self.moe_layers)

    @property
    def deepseek_router(self) -> bool:
        return bool(self.moe_router) and self.moe_router[0] == "deepseek_v3"

    def layer_window(self, layer_idx: int):
        """The layer's sliding window in keys, or None (full attention)."""
        if self.sliding_window is not None and layer_idx in self.swa_layers:
            return self.sliding_window
        return None

    @property
    def is_hybrid(self) -> bool:
        """Full-attention and SWA layers mixed: two KV-cache groups with
        page pools of their own."""
        if self.sliding_window is None or not self.swa_layers:
            return False
        swa = set(self.swa_layers) & set(range(self.num_layers))
        return bool(swa) and swa != set(range(self.num_layers))

    def group_layers(self, group_idx: int) -> tuple:
        """Layer indices of a cache group: group 0 = full attention, group
        1 = sliding window (hybrid models only)."""
        swa = set(self.swa_layers) if self.sliding_window is not None else set()
        if group_idx == 0:
            return tuple(li for li in range(self.num_layers) if li not in swa)
        return tuple(li for li in range(self.num_layers) if li in swa)

    def layer_group(self, layer_idx: int) -> int:
        return 1 if (self.is_hybrid and layer_idx in self.swa_layers) else 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def kv_cache_heads(self) -> int:
        """Head count of the paged cache (MLA: the latent is one shared
        head, multi-query over the compressed KV)."""
        return 1 if self.is_mla else self.num_kv_heads

    @property
    def kv_cache_head_dim(self) -> int:
        """Width of a token's cache row (MLA: latent rank + decoupled-RoPE
        key + pad)."""
        if self.is_mla:
            return self.kv_lora_rank + self.qk_rope_head_dim + self.latent_pad
        return self.head_dim

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Test-sized config (the JAX package's ``LlamaConfig.tiny``)."""
        return cls(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4,
        )

    @classmethod
    def qwen3_tiny(cls) -> "LlamaConfig":
        """Test-sized Qwen3-family config (GQA + QK-norm), the JAX
        package's ``LlamaConfig.qwen3_tiny``."""
        return cls(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4,
            qk_norm=True,
        )

    @classmethod
    def gemma_tiny(cls) -> "LlamaConfig":
        """Test-sized hybrid config: SWA and full-attention layers
        interleaved 1:1 (the JAX package's ``LlamaConfig.gemma_tiny``)."""
        return cls(
            vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4,
            sliding_window=8, swa_layers=(0, 2),
        )

    @classmethod
    def sink_tiny(cls) -> "LlamaConfig":
        """Test-sized StreamingLLM config: every layer SWA with sinks (the
        JAX package's ``LlamaConfig.sink_tiny``)."""
        return cls(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4,
            sliding_window=8, swa_layers=(0, 1), attention_sinks=4,
        )

    @classmethod
    def deepseek_tiny(cls) -> "LlamaConfig":
        """Test-sized DeepSeek-family config (MLA, the JAX package's
        ``LlamaConfig.deepseek_tiny``): a 16 + 8 = 24-wide latent row."""
        return cls(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, head_dim=16, intermediate_size=128, page_size=4,
            kv_lora_rank=16, qk_rope_head_dim=8,
        )

    @classmethod
    def mixtral_tiny(cls) -> "LlamaConfig":
        """Test-sized Mixtral-style MoE config (top 2 of 4 experts, capacity
        dispatch), the JAX package's ``LlamaConfig.mixtral_tiny``."""
        return cls(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4,
            num_experts=4, num_experts_per_token=2,
        )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller says
    otherwise, and never a silent fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return device


def _truncated_normal(shape, generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (inverse-CDF sampling)."""
    hi = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0  # normal CDF at 2
    lo = 1.0 - hi
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return torch.erfinv((lo + (hi - lo) * u) * 2.0 - 1.0) * math.sqrt(2.0)


def param_layout(cfg: LlamaConfig) -> Params:
    """The tree ``init_params(cfg)`` builds, as ``(shape, dtype, init)`` a
    leaf (``init``: "dense", a truncated normal scaled by 0.02 in
    ``cfg.dtype``; "ones" or "zeros", fp32), with no tensor made: the shape
    table a checkpoint's leaves are held to. Each dict is in ``init_params``'
    key order, which within a layer is also the order of its random draws;
    the layers draw before ``embed`` and ``lm_head``."""
    h, hd, dt, f32 = cfg.hidden_size, cfg.head_dim, cfg.dtype, torch.float32

    def dense(*shape):
        return (shape, dt, "dense")

    layers = []
    for li in range(cfg.num_layers):
        layer = {"attn_norm": ((h,), f32, "ones")}
        if cfg.is_mla:
            r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
            layer.update({"wq": dense(h, cfg.num_heads * (hd + dr)), "w_dkv": dense(h, r),
                          "w_kr": dense(h, dr), "w_uk": dense(cfg.num_heads, r, hd),
                          "w_uv": dense(cfg.num_heads, r, hd)})
        else:
            layer.update({"wq": dense(h, cfg.num_heads * hd),
                          "wk": dense(h, cfg.num_kv_heads * hd),
                          "wv": dense(h, cfg.num_kv_heads * hd)})
        if cfg.qk_norm:
            layer.update({"q_norm": ((hd,), f32, "ones"), "k_norm": ((hd,), f32, "ones")})
        layer.update({"wo": dense(cfg.num_heads * hd, h), "mlp_norm": ((h,), f32, "ones")})
        if cfg.moe_layer(li):
            e = cfg.num_experts
            inter = cfg.moe_intermediate_size or cfg.intermediate_size
            layer.update({"router": dense(h, e), "w_gate": dense(e, h, inter),
                          "w_up": dense(e, h, inter), "w_down": dense(e, inter, h)})
            if cfg.deepseek_router:  # the router's bias and the shared expert
                sh = inter * max(cfg.n_shared_experts, 1)
                layer.update({"router_bias": ((e,), f32, "zeros"), "w_gate_sh": dense(h, sh),
                              "w_up_sh": dense(h, sh), "w_down_sh": dense(sh, h)})
        else:
            layer.update({"w_gate": dense(h, cfg.intermediate_size),
                          "w_up": dense(h, cfg.intermediate_size),
                          "w_down": dense(cfg.intermediate_size, h)})
        layers.append(layer)
    return {"embed": dense(cfg.vocab_size, h), "layers": layers,
            "final_norm": ((h,), f32, "ones"), "lm_head": dense(h, cfg.vocab_size)}


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters from ``seed`` (truncated-normal projections scaled
    by 0.02, ones for the norms, zeros for a DeepSeek router's bias), laid
    out like the JAX ``init_params`` tree (``param_layout``): an expert
    layer holds ``router`` ``[h, E]``, ``w_gate``/``w_up`` ``[E, h, inter]``
    and ``w_down`` ``[E, inter, h]`` (``inter`` = ``moe_intermediate_size``
    or ``intermediate_size``), and under the ``deepseek_v3`` router an fp32
    ``router_bias`` ``[E]`` and the shared expert's ``w_gate_sh``/``w_up_sh``
    ``[h, sh]`` and ``w_down_sh`` ``[sh, h]`` (``sh = inter *
    max(n_shared_experts, 1)``). The numbers differ from JAX's for the same seed; tests that need
    equal weights convert the JAX tree with ``params_from_jax``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(spec):
        shape, dtype, init = spec
        if init == "dense":
            return (_truncated_normal(shape, gen, device) * 0.02).to(dtype)
        return (torch.ones if init == "ones" else torch.zeros)(shape, dtype=dtype, device=device)

    layout = param_layout(cfg)
    layers = [{k: make(spec) for k, spec in layer.items()} for layer in layout["layers"]]
    top = {k: make(spec) for k, spec in layout.items() if k != "layers"}
    return {"embed": top["embed"], "layers": layers, "final_norm": top["final_norm"],
            "lm_head": top["lm_head"]}


def flatten_params(params: Params) -> dict[str, torch.Tensor]:
    """The tree's leaves by flat name: ``embed``, ``final_norm``,
    ``lm_head`` and ``layers.<i>.<leaf>`` (a checkpoint's tensor names).
    The ``fused_interleave`` marker, an int, is not a leaf and is left out."""
    flat = {k: v for k, v in params.items() if k not in ("layers", "fused_interleave")}
    for li, layer in enumerate(params["layers"]):
        flat.update({f"layers.{li}.{k}": v for k, v in layer.items()})
    return flat


def unflatten_params(flat: dict[str, Any], num_layers: int) -> Params:
    """Inverse of ``flatten_params`` over ``num_layers`` layers; a name of
    no such form raises."""
    tree: Params = {"layers": [{} for _ in range(num_layers)]}
    for name, v in flat.items():
        parts = name.split(".")
        if len(parts) == 3 and parts[0] == "layers" and parts[1].isdigit() \
                and int(parts[1]) < num_layers:
            tree["layers"][int(parts[1])][parts[2]] = v
        elif len(parts) == 1 and parts[0] != "layers":
            tree[name] = v
        else:
            raise ValueError(f"{name!r} names no leaf of a {num_layers}-layer tree")
    out = {k: tree.pop(k) for k in ("embed", "layers", "final_norm", "lm_head") if k in tree}
    return {**out, **tree}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 arrays, which torch.from_numpy refuses: move
        # the raw 16-bit words and reinterpret them.
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Params, cfg: LlamaConfig, device="cuda") -> Params:
    """Carry a JAX ``init_params`` tree (leaves converted to numpy) across.

    The orientation is kept as it is (``x @ W``). An MLA layer may carry
    ``latent_norm`` and q-LoRA's ``w_dq``/``q_latent_norm``, as
    ``params_from_hf`` gives them; a dense layer Qwen2's ``bq``/``bk``/``bv``
    biases and, under ``qk_norm``, Qwen3's ``q_norm``/``k_norm``. An expert
    layer (``cfg.moe_layer(i)``) carries ``router``, and under the
    ``deepseek_v3`` router ``router_bias`` and the shared expert; no other
    layer may. A tree of JAX's ``fuse_params`` is taken too: its fused
    leaves where ``fuse_params`` puts them (``w_qkv``/``b_qkv`` on a dense
    attention layer, ``w_mla_in`` on an MLA one, ``w_gate_up`` on a dense
    MLP, ``w_gate_up_sh`` on DeepSeek's shared expert), each in place of
    the leaves it fused, and its top-level ``fused_interleave`` marker,
    carried across unchanged.
    """
    device = resolve_device(device)
    if cfg.is_mla:
        known = _MLA_LAYER_KEYS | {"w_mla_in"}
    else:
        known = (_LAYER_KEYS | _BIAS_KEYS | {"w_qkv", "b_qkv"}
                 | (_QK_NORM_KEYS if cfg.qk_norm else frozenset()))
    moe_known = known | _MOE_KEYS | (_DEEPSEEK_MOE_KEYS | {"w_gate_up_sh"}
                                     if cfg.deepseek_router else frozenset())
    known = known | {"w_gate_up"}  # expert stacks are never fused
    layers = []
    for li, layer in enumerate(tree["layers"]):
        unknown = set(layer) - (moe_known if cfg.moe_layer(li) else known)
        if unknown:
            raise NotImplementedError(
                f"layer parameters {sorted(unknown)} are not in the ported slices")
        fused = [k for k in _FUSED_KEYS if k in layer]
        covered = {p for k in fused for p in _FUSED_PARTS[k]}
        beside = sorted(covered & set(layer))
        if "w_mla_in" in layer and ("w_dq" in layer or (
                "wq" in layer) != ("q_latent_norm" in layer)):
            beside.append("w_dq" if "w_dq" in layer else "wq")
        if beside:
            raise ValueError(f"layer {li} holds fused {fused} beside the leaves they "
                             f"replace, {beside}")
        if "b_qkv" in layer and "w_qkv" not in layer:
            raise ValueError(f"layer {li} holds b_qkv without w_qkv")
        if cfg.moe_layer(li):
            need = _MOE_KEYS | (_DEEPSEEK_MOE_KEYS if cfg.deepseek_router else frozenset())
            missing = need - set(layer) - covered
            if missing:
                raise ValueError(f"expert layer {li} lacks {sorted(missing)}")
        if cfg.qk_norm and not _QK_NORM_KEYS <= set(layer):
            raise ValueError("a qk_norm config needs q_norm and k_norm in every layer")
        biases = _BIAS_KEYS & set(layer)
        if biases and biases != _BIAS_KEYS:
            raise ValueError(f"QKV biases come as bq, bk and bv together, got {sorted(biases)}")
        layers.append({k: _leaf_from_numpy(v, device) for k, v in layer.items()})
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree has {len(layers)} layers, config {cfg.num_layers}")
    out = {
        "embed": _leaf_from_numpy(tree["embed"], device),
        "layers": layers,
        "final_norm": _leaf_from_numpy(tree["final_norm"], device),
        "lm_head": _leaf_from_numpy(tree["lm_head"], device),
    }
    if "fused_interleave" in tree:
        out["fused_interleave"] = tree["fused_interleave"]
    return out


def _interleave_concat(parts: list, t: int, axis: int = 1) -> torch.Tensor:
    """Concatenate projection blocks in per-rank interleaved column order.

    t == 1 is the canonical order. For t > 1 every part's fused axis must
    divide by t; rank i's slice of each part lands contiguously, so a
    uniform t-way split of the result gives rank i exactly ``[part0_i |
    part1_i | ...]``, its local fused block."""
    if t == 1:
        return torch.cat(parts, dim=axis)
    for p in parts:
        if p.shape[axis] % t:
            raise ValueError(
                f"fused_interleave={t} does not divide projection width "
                f"{p.shape[axis]}")
    chunks = []
    for i in range(t):
        for p in parts:
            n = p.shape[axis] // t
            chunks.append(p.narrow(axis, i * n, n))
    return torch.cat(chunks, dim=axis)


def _deinterleave_split(w: torch.Tensor, widths: tuple, t: int, axis: int = 1) -> list:
    """Inverse of ``_interleave_concat``: the canonical per-projection
    blocks of a (possibly interleaved) fused tensor."""
    if t == 1:
        outs, off = [], 0
        for n in widths:
            outs.append(w.narrow(axis, off, n))
            off += n
        return outs
    blk = sum(widths) // t
    ranks = [w.narrow(axis, i * blk, blk) for i in range(t)]
    outs, off = [], 0
    for n in widths:
        outs.append(torch.cat([r.narrow(axis, off, n // t) for r in ranks], dim=axis))
        off += n // t
    return outs


def split_fused_out(y: torch.Tensor, widths: tuple, t: int) -> list:
    """Split a fused projection's output activations into the
    per-projection tensors, honouring the interleaved layout: for t == 1
    the canonical slices; for t > 1 the last axis viewed as ``[t, blk]``,
    each part's per-rank columns taken and the rank axis merged back
    (rank-major order is the canonical order)."""
    if t == 1:
        outs, off = [], 0
        for n in widths:
            outs.append(y[..., off:off + n])
            off += n
        return outs
    blk = sum(widths) // t
    yb = y.reshape(*y.shape[:-1], t, blk)
    outs, off = [], 0
    for n in widths:
        outs.append(yb[..., off:off + n // t].reshape(*y.shape[:-1], n))
        off += n // t
    return outs


def fuse_params(params: Params, cfg: LlamaConfig) -> Params:
    """Fuse each layer's projections that share an input into wider
    products (the JAX serving-time transform):

    - ``wq/wk/wv`` (+ ``bq/bk/bv``) -> ``w_qkv`` (+ ``b_qkv``);
    - MLA: ``wq|w_dq`` + ``w_dkv`` + ``w_kr`` -> ``w_mla_in`` (all read the
      normed attention input; q-LoRA keeps its ``wq`` over the normed q
      latent);
    - a dense SwiGLU's ``w_gate/w_up`` -> ``w_gate_up`` (an expert stack,
      3-d, is never fused);
    - DeepSeek's shared expert ``w_gate_sh/w_up_sh`` -> ``w_gate_up_sh``.

    The originals are dropped from the new tree. The columns are in
    ``cfg.fused_interleave``'s order (MLA: canonical only). A tree that
    fused anything records that interleave as its top-level
    ``fused_interleave`` marker; a call on a fused tree changes nothing,
    the marker included."""
    t = cfg.fused_interleave
    out = dict(params)
    fused_layers = []
    fused_any = False
    for layer in params["layers"]:
        lyr = dict(layer)
        if "wk" in lyr:  # standard / GQA attention
            lyr["w_qkv"] = _interleave_concat([lyr.pop("wq"), lyr.pop("wk"), lyr.pop("wv")], t)
            if "bq" in lyr:
                lyr["b_qkv"] = _interleave_concat(
                    [lyr.pop("bq"), lyr.pop("bk"), lyr.pop("bv")], t, axis=0)
            fused_any = True
        elif "w_dkv" in lyr:  # absorbed MLA (canonical order; t == 1)
            head_in = lyr.pop("w_dq") if "w_dq" in lyr else lyr.pop("wq")
            lyr["w_mla_in"] = torch.cat([head_in, lyr.pop("w_dkv"), lyr.pop("w_kr")], dim=1)
            fused_any = True
        if "w_gate" in lyr and lyr["w_gate"].dim() == 2:  # dense SwiGLU
            lyr["w_gate_up"] = _interleave_concat([lyr.pop("w_gate"), lyr.pop("w_up")], t)
            fused_any = True
        if "w_gate_sh" in lyr:
            lyr["w_gate_up_sh"] = _interleave_concat([lyr.pop("w_gate_sh"), lyr.pop("w_up_sh")], t)
            fused_any = True
        fused_layers.append(lyr)
    out["layers"] = fused_layers
    if fused_any:
        # The interleave the tree was fused with, so that unfuse_params can
        # refuse a config that disagrees instead of scrambling q/k/v.
        out["fused_interleave"] = t
    return out


def fuse_profitable(cfg: LlamaConfig, tp: int = 1) -> bool:
    """JAX's gate, as it is: fuse when a rank's hidden width (``hidden_size
    / tp``: tp divides each rank's product columns) is at least 4096. JAX
    measured the crossover on a TPU v5e (hidden 4096 ~7% faster fused,
    2048 ~8% slower); ``chip_smoke.py`` times the products on the H100
    beside it, and the gate is kept whatever they say."""
    return cfg.hidden_size // max(1, tp) >= 4096


def maybe_fuse_params(params: Params, cfg: LlamaConfig) -> Params:
    """``fuse_params`` iff ``fuse_profitable(cfg)``: the shared-tree path (a
    tree that several single-rank engines adopt, fused once)."""
    return fuse_params(params, cfg) if fuse_profitable(cfg) else params


def unfuse_params(params: Params, cfg: LlamaConfig) -> Params:
    """Inverse of ``fuse_params``: the canonical per-projection layout,
    the marker dropped; a tree with no fused leaf is returned as it is (less
    its marker). The interleave is the tree's ``fused_interleave`` marker: a
    fused tree without one, or whose marker disagrees with
    ``cfg.fused_interleave``, raises (de-interleaving with the wrong t would
    scramble wq/wk/wv silently)."""
    out = dict(params)
    marker = out.pop("fused_interleave", None)
    if not any(k in lyr for lyr in params["layers"] for k in _FUSED_KEYS):
        return out  # already canonical
    if marker is None:
        raise ValueError(
            "cannot unfuse: tree has fused projections but no "
            "fused_interleave marker (was it fused by fuse_params?)")
    t = int(marker)
    if t != cfg.fused_interleave:
        raise ValueError(
            f"fused_interleave mismatch: tree was fused with t={t} but "
            f"cfg.fused_interleave={cfg.fused_interleave}; unfusing with "
            "the wrong interleave would scramble the q/k/v column order")
    layers = []
    for layer in params["layers"]:
        lyr = dict(layer)
        if "w_qkv" in lyr:
            nq = cfg.num_heads * cfg.head_dim
            nk = cfg.num_kv_heads * cfg.head_dim
            w = lyr.pop("w_qkv")
            nv = w.shape[1] - nq - nk
            lyr["wq"], lyr["wk"], lyr["wv"] = _deinterleave_split(w, (nq, nk, nv), t)
            if "b_qkv" in lyr:
                lyr["bq"], lyr["bk"], lyr["bv"] = _deinterleave_split(
                    lyr.pop("b_qkv"), (nq, nk, nv), t, axis=0)
        if "w_mla_in" in lyr:  # canonical order only (t == 1)
            r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
            w = lyr.pop("w_mla_in")
            qc = w.shape[1] - r - dr
            head_key = "w_dq" if "q_latent_norm" in lyr else "wq"
            lyr[head_key] = w[:, :qc]
            lyr["w_dkv"] = w[:, qc:qc + r]
            lyr["w_kr"] = w[:, qc + r:]
        if "w_gate_up" in lyr:
            w = lyr.pop("w_gate_up")
            inter = w.shape[1] // 2
            lyr["w_gate"], lyr["w_up"] = _deinterleave_split(w, (inter, inter), t)
        if "w_gate_up_sh" in lyr:
            w = lyr.pop("w_gate_up_sh")
            sh = w.shape[1] // 2
            lyr["w_gate_sh"], lyr["w_up_sh"] = _deinterleave_split(w, (sh, sh), t)
        layers.append(lyr)
    out["layers"] = layers
    return out


def init_kv_cache(cfg: LlamaConfig, num_pages: int, dtype=None,
                  device="cuda", tp_size: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the paged K and V pools ``[layers, pages, kvh, page, hd]``,
    zeroed so no page ever holds non-finite bytes, in ``dtype`` (default
    the model's). ``torch.float8_e4m3fn`` halves the pools' bytes: new
    K/V are cast on write (``to_kv_dtype``) and attention upcasts on read.

    MLA: the K pool holds each token's latent row as one shared head
    (``kvh = 1``, ``hd = kv_cache_head_dim``) and the V pool has width 0:
    attention reads the values from the latent itself.

    ``tp_size``: a tensor-parallel rank's part (``tp_pool_heads``:
    ``kv_cache_heads / tp_size`` heads, or the whole pool when it has one
    head, the latent)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_pages, tp_pool_heads(cfg.kv_cache_heads, tp_size),
             cfg.page_size, cfg.kv_cache_head_dim)
    v_shape = shape[:-1] + (0,) if cfg.is_mla else shape
    dtype = cfg.dtype if dtype is None else dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(v_shape, dtype=dtype, device=device))


def init_kv_cache_hybrid(cfg: LlamaConfig, num_pages: int, num_swa_pages: int,
                         dtype=None, device="cuda") -> tuple[torch.Tensor, ...]:
    """Page pools of a hybrid model's two cache groups, ``(k0, v0, k1,
    v1)``: group 0 holds the full-attention layers over ``num_pages``
    pages, group 1 the SWA layers over ``num_swa_pages`` (window-bounded,
    so typically far fewer), each stacked in ``cfg.group_layers(g)`` order
    and zeroed; ``dtype`` as in ``init_kv_cache``."""
    if not cfg.is_hybrid:
        raise ValueError("init_kv_cache_hybrid needs a hybrid config")
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype

    def pool(group, pages):
        shape = (len(cfg.group_layers(group)), pages, cfg.num_kv_heads, cfg.page_size,
                 cfg.head_dim)
        return torch.zeros(shape, dtype=dtype, device=device)

    return pool(0, num_pages), pool(0, num_pages), pool(1, num_swa_pages), pool(1, num_swa_pages)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, the lower index first among equal values (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_capacity(cfg: LlamaConfig, tokens: int) -> int:
    """GShard's per-expert buffer length for ``tokens`` tokens: ``ceil(T ·
    k · moe_capacity_factor / E)``, at least 1."""
    return max(1, math.ceil(
        tokens * cfg.num_experts_per_token * cfg.moe_capacity_factor / cfg.num_experts))


def _moe_router(mlp_in: torch.Tensor, layer: dict, cfg: LlamaConfig):
    """The softmax router (the JAX ``_moe_router`` less its training loss):
    logits from a product in the model dtype, then fp32; the top k experts
    a token and their weights, the softmax of the top k logits or, for
    ``("softmax_topk", 0)`` (Qwen3-MoE, ``norm_topk_prob=False``), the top
    k entries of the full softmax, not renormalised. Returns ``(top_idx [b,
    s, k], weights [b, s, k], one-hot [b, s, k, E])``."""
    router_logits = (mlp_in @ layer["router"].to(mlp_in.dtype)).float()  # [b, s, E]
    top_w, top_idx = _top_k(router_logits, cfg.num_experts_per_token)
    if cfg.moe_router and cfg.moe_router[0] == "softmax_topk" and not cfg.moe_router[1]:
        weights = torch.gather(torch.softmax(router_logits, dim=-1), -1, top_idx)
    else:
        weights = torch.softmax(top_w, dim=-1)
    return top_idx, weights, _one_hot(top_idx, cfg.num_experts, torch.float32)


def _experts(x_e: torch.Tensor, layer: dict) -> torch.Tensor:
    """SwiGLU of every expert over its rows, one batched GEMM over the
    stacked experts a product: ``x_e [E, rows, h]`` (a stride-0 expand of
    the tokens when every expert sees all of them) through ``w_gate``/
    ``w_up`` ``[E, h, inter]`` and ``w_down`` ``[E, inter, h]``. The products
    come out in the model dtype; the activation is fp32 and ``gate * up``
    goes back to the model dtype before ``w_down``, as in JAX. Returns fp32
    ``[E, rows, h]``."""
    gate = F.silu(torch.bmm(x_e, layer["w_gate"]).float())
    up = torch.bmm(x_e, layer["w_up"]).float()
    return torch.bmm((gate * up).to(x_e.dtype), layer["w_down"]).float()


def _mix(mix_w: torch.Tensor, expert_out: torch.Tensor) -> torch.Tensor:
    """Each token's weighted sum of the experts' outputs in fp32: ``mix_w
    [T, E]`` over ``expert_out [E, T, h]``, one GEMM a token."""
    return torch.bmm(mix_w[:, None, :], expert_out.transpose(0, 1))[:, 0]


def _moe_dense(mlp_in: torch.Tensor, layer: dict, cfg: LlamaConfig) -> torch.Tensor:
    """The JAX ``_moe_dense``: every expert over every token, a one-hot mix
    (exact, E/k times the routed work)."""
    b, s, h = mlp_in.shape
    e = cfg.num_experts
    _top_idx, weights, onehot = _moe_router(mlp_in, layer, cfg)
    mix_w = torch.einsum("bsk,bske->bse", weights, onehot).reshape(b * s, e)
    x = mlp_in.reshape(b * s, h)
    return _mix(mix_w, _experts(x.expand(e, b * s, h), layer)).reshape(b, s, h).to(mlp_in.dtype)


def _capacity_slots(top_idx: torch.Tensor, e: int, valid: torch.Tensor | None = None):
    """The capacity dispatch's assignments, token-major (a = token · k +
    choice, so earlier tokens win slots): each one's expert one-hot ``oh
    [A, E]`` int32, a zero row for a token ``valid`` masks, and its slot
    ``pos_a [A]``, the assignments to its expert before it. It is kept
    where its row is not zero and ``pos_a < C``."""
    k = top_idx.shape[-1]
    t = top_idx.numel() // k
    oh = _one_hot(top_idx.reshape(t * k), e, torch.int32)  # [A, E]
    if valid is not None:
        oh = oh * valid.reshape(t, 1).expand(t, k).reshape(t * k, 1).to(torch.int32)
    return oh, torch.sum((torch.cumsum(oh, dim=0) - oh) * oh, dim=1)


def _moe_capacity(mlp_in: torch.Tensor, layer: dict, cfg: LlamaConfig,
                  valid: torch.Tensor | None = None,
                  capacity_tokens: int | None = None) -> torch.Tensor:
    """The JAX ``_moe_capacity``: GShard dispatch into ``[E, C, h]`` buffers
    by one-hot einsums (static shapes), experts over the buffers, the
    outputs combined back with the router's weights. Assignments are
    token-major (earlier tokens win slots); past an expert's ``C`` they drop
    and the residual passes. ``valid`` ([b, s] bool) keeps padded positions
    out of the slots.

    ``C = moe_capacity(cfg, T)`` with ``T`` the tokens of ``mlp_in`` or
    ``capacity_tokens``: a caller whose token axis is shorter than the one
    the JAX engine would pad it to (the ragged scheduler's, unbucketed)
    passes JAX's length, so the same assignments drop."""
    batch, seq, hidden = mlp_in.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    t = batch * seq
    top_idx, weights, _onehot = _moe_router(mlp_in, layer, cfg)
    capacity = moe_capacity(cfg, t if capacity_tokens is None else capacity_tokens)
    x = mlp_in.reshape(t, hidden)
    oh, pos_a = _capacity_slots(top_idx, e, valid)
    # Over-capacity assignments (and masked tokens, whose row is zero) get
    # a zero row here and drop out of the dispatch.
    pos_tk = _one_hot(pos_a, capacity, mlp_in.dtype).reshape(t, k, capacity)
    oh_tk = oh.to(mlp_in.dtype).reshape(t, k, e)
    # A token's k choices land in distinct (expert, slot) cells: the sum
    # over the choice axis is a lossless [T, E, C] dispatch.
    disp = torch.einsum("tke,tkc->tec", oh_tk, pos_tk)
    buf = torch.einsum("tec,th->ech", disp, x)  # [E, C, h]
    expert_out = _experts(buf, layer)
    combine = torch.einsum("tke,tkc,tk->tec", oh_tk.float(), pos_tk.float(),
                           weights.reshape(t, k))
    y = torch.einsum("tec,ech->th", combine, expert_out)  # [T, h]
    return y.reshape(batch, seq, hidden).to(mlp_in.dtype)


def _deepseek_route(x: torch.Tensor, layer: dict, cfg: LlamaConfig):
    """DeepSeek-V3's routing of ``x [T, h]``: the chosen experts ``idx [T,
    k]`` and their weights ``w [T, k]`` (``_moe_deepseek``)."""
    _kind, n_group, topk_group, norm_flag, factor = cfg.moe_router
    e = layer["router"].shape[1]
    scores = torch.sigmoid(x.float() @ layer["router"].float())  # [T, E]
    choice = scores + layer["router_bias"][None, :].float()
    group_scores = _top_k(choice.reshape(-1, n_group, e // n_group), 2)[0].sum(-1)
    _, gidx = _top_k(group_scores, topk_group)  # [T, topk_group]
    gmask = _one_hot(gidx, n_group, torch.float32).sum(1)  # [T, n_group]
    smask = gmask[:, :, None].expand(-1, n_group, e // n_group).reshape(-1, e)
    masked = torch.where(smask > 0, choice, 0.0)
    _, idx = _top_k(masked, cfg.num_experts_per_token)  # [T, k]
    w = torch.gather(scores, -1, idx)
    if norm_flag:
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20)
    w = w * factor
    return idx, w


def _rank_interleave(cfg: LlamaConfig, tp) -> int:
    """The column interleave of the fused leaves this process holds: the
    whole tree's ``fused_interleave``, or, on a tp rank, that over the
    group size. A tree fused with t = tp and split into tp contiguous
    shards gives each rank its own block in the canonical order (1); JAX,
    one program over the mesh, splits the global output with t instead."""
    size = 1 if tp is None else tp.size
    if cfg.fused_interleave % size:
        raise ValueError(
            f"fused leaves in fused_interleave={cfg.fused_interleave} order do not split into "
            f"{size} ranks' fused blocks (the engine fuses with fused_interleave = tp)")
    return cfg.fused_interleave // size


def _gate_up(x: torch.Tensor, layer: dict, cfg: LlamaConfig, tp, suffix: str = ""):
    """A SwiGLU's fp32 ``silu(gate)`` and ``up``: from the fused
    ``w_gate_up{suffix}`` product split by ``split_fused_out``, or from the
    two products."""
    if "w_gate_up" + suffix in layer:  # fused serving layout (fuse_params)
        gu = (x @ layer["w_gate_up" + suffix]).float()
        inter = gu.shape[-1] // 2
        gate_out, up = split_fused_out(gu, (inter, inter), _rank_interleave(cfg, tp))
        return F.silu(gate_out), up
    return F.silu((x @ layer["w_gate" + suffix]).float()), (x @ layer["w_up" + suffix]).float()


def _moe_deepseek(mlp_in: torch.Tensor, layer: dict, cfg: LlamaConfig,
                  tp=None) -> torch.Tensor:
    """The JAX ``_moe_deepseek`` (DeepSeek-V3's router and MoE, exact dense
    form): sigmoid scores of an fp32 product; the top k chosen on the
    scores plus ``router_bias``, within the best ``topk_group`` of
    ``n_group`` expert groups (a group's score: the sum of its top two);
    the weights the unbiased scores of the chosen experts, renormalised
    (``+ 1e-20``) when ``norm_topk_prob``, times the routed scaling factor.
    The routed sum is cast to the model dtype before the shared expert is
    added. On a tp rank both are the rank's partial sums over its part of
    the inner widths."""
    b, s, h = mlp_in.shape
    e = layer["w_gate"].shape[0]
    x = mlp_in.reshape(b * s, h)
    idx, w = _deepseek_route(x, layer, cfg)
    mix_w = torch.einsum("tk,tke->te", w, _one_hot(idx, e, torch.float32))
    out = _mix(mix_w, _experts(x.expand(e, b * s, h), layer)).to(mlp_in.dtype)

    sh_gate, sh_up = _gate_up(x, layer, cfg, tp, "_sh")
    shared = (sh_gate * sh_up).to(x.dtype) @ layer["w_down_sh"]
    return (out + shared).reshape(b, s, h)


def _mlp(mlp_in: torch.Tensor, layer: dict, cfg: LlamaConfig,
         valid: torch.Tensor | None = None,
         capacity_tokens: int | None = None, tp=None) -> torch.Tensor:
    """The JAX ``_mlp``: dense SwiGLU (``w_gate_up`` fused or its two
    products), or a mixture of experts when the layer has a ``router`` (the
    ``deepseek_v3`` router, or the softmax one with the capacity or dense
    dispatch). The products stay in the model dtype; the activation, router
    and mix math is fp32. ``valid`` and ``capacity_tokens`` reach the
    capacity dispatch; ``tp`` is a rank's group (its fused blocks' order)."""
    if "router" in layer:
        if cfg.deepseek_router:
            return _moe_deepseek(mlp_in, layer, cfg, tp)
        if cfg.moe_dispatch == "capacity":
            return _moe_capacity(mlp_in, layer, cfg, valid=valid,
                                 capacity_tokens=capacity_tokens)
        if cfg.moe_dispatch == "dense":
            return _moe_dense(mlp_in, layer, cfg)
        raise ValueError(f"unknown moe_dispatch: {cfg.moe_dispatch!r}")
    gate, up = _gate_up(mlp_in, layer, cfg, tp)
    return (gate * up).to(mlp_in.dtype) @ layer["w_down"]


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          scaling: tuple = ()) -> torch.Tensor:
    """Rotary position embedding (half-split). x: [b, s, heads, hd],
    positions: [b, s]; angles in fp32.

    ``scaling`` is ``LlamaConfig.rope_scaling``: ``()`` for plain RoPE;
    ``("llama3", factor, low_freq_factor, high_freq_factor, original_max)``
    divides long wavelengths by ``factor``, keeps short ones and ramps
    between; ``("yarn", factor, beta_fast, beta_slow, original_max,
    attention_factor)`` interpolates the dims past the beta_slow bound,
    keeps those below beta_fast, ramps between, and scales cos/sin by the
    attention factor (transformers' formulas with truncate=True, as in
    JAX).
    """
    hd = x.shape[-1]
    half = hd // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (idx / half))
    att = 1.0
    if scaling and scaling[0] == "llama3":
        _, factor, low_f, high_f, orig = scaling
        wavelen = 2.0 * math.pi / freqs
        smooth = (orig / wavelen - low_f) / (high_f - low_f)
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(wavelen > orig / low_f, freqs / factor,
                            torch.where(wavelen < orig / high_f, freqs, mid))
    elif scaling:
        _, factor, beta_fast, beta_slow, orig, att = scaling

        def corr_dim(n_rot):  # full-dim index for a rotation count
            return (hd * math.log(orig / (n_rot * 2.0 * math.pi))) / (2.0 * math.log(theta))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), hd - 1)
        extrap = 1.0 - torch.clamp((idx - low) / max(high - low, 0.001), 0.0, 1.0)
        freqs = (freqs / factor) * (1.0 - extrap) + freqs * extrap
    angles = positions[..., None].float() * freqs  # [b, s, half]
    cos = torch.cos(angles)[:, :, None, :] * att
    sin = torch.sin(angles)[:, :, None, :] * att
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# attention(q, k_layer, v_layer, page_table, positions, ctx_lens, total_lens,
#           shared_kv, window, sinks, **tail): shared_kv is absorbed MLA, with
# v_layer the K pool; window is the layer's sliding window (None: full) and
# sinks the StreamingLLM sink count (None: none); in a burst tick ``tail``
# holds tail_k, tail_v and tail_lens, and total_lens is the burst's frozen
# base.
AttentionFn = Callable[..., torch.Tensor]


def _plain_attention(q, k_l, v_l, table, positions, ctx_lens, total_lens,
                     shared_kv=False, window=None, sinks=None, **tail):
    return paged_attention(q, k_l, v_l, table, positions, total_lens,
                           sliding_window=window, attention_sinks=sinks, **tail)


def _decode_attention(q, k_l, v_l, table, positions, ctx_lens, total_lens,
                      shared_kv=False, window=None, sinks=None, **tail):
    return cuda_paged_decode_attention(q[:, 0], k_l, v_l, table, total_lens,
                                       sliding_window=window, sinks=sinks,
                                       shared_kv=shared_kv, **tail)[:, None]


def _prefill_attention(q, k_l, v_l, table, positions, ctx_lens, total_lens,
                       shared_kv=False, window=None, sinks=None):
    return cuda_paged_prefill_attention(q, k_l, v_l, table, ctx_lens, total_lens,
                                        sliding_window=window, sinks=sinks,
                                        shared_kv=shared_kv)


def _sharded_attention(cfg: LlamaConfig, tp, decode: bool) -> AttentionFn:
    """A tensor-parallel rank's attention of one padded step, on its heads:
    the sharded decode wrapper for one token a row, the sharded prefill
    wrapper for more (each checks the local heads against the model's)."""
    heads = dict(q_heads=cfg.num_heads, kv_heads=cfg.kv_cache_heads)
    if decode:
        def attention(q, k_l, v_l, table, positions, ctx_lens, total_lens, shared_kv=False,
                      window=None, sinks=None, **tail):
            return sharded_paged_decode_attention(
                tp, q[:, 0], k_l, v_l, table, total_lens, sliding_window=window, sinks=sinks,
                shared_kv=shared_kv, **heads, **tail)[:, None]
    else:
        def attention(q, k_l, v_l, table, positions, ctx_lens, total_lens, shared_kv=False,
                      window=None, sinks=None):
            return sharded_paged_prefill_attention(
                tp, q, k_l, v_l, table, ctx_lens, total_lens, sliding_window=window,
                sinks=sinks, shared_kv=shared_kv, **heads)
    return attention


def _embed(embed: torch.Tensor, tokens: torch.Tensor, tp) -> torch.Tensor:
    """Token embeddings. Under tp ``embed`` is the rank's contiguous block
    of vocab rows: each rank looks up the tokens that fall in it, zeros for
    the rest, and the sum over the ranks is every token's row (exact: one
    rank's row plus zeros)."""
    if tp is None:
        return embed[tokens.long()]
    local = tokens.long() - tp.rank * embed.shape[0]
    miss = (local < 0) | (local >= embed.shape[0])
    x = embed[local.masked_fill(miss, 0)].masked_fill_(miss[..., None], 0)
    return tp.all_reduce_(x)


def _mla_project(cfg: LlamaConfig, layer: dict, attn_in, positions):
    """The absorbed-MLA projections of the JAX ``_forward_impl_grouped``:
    returns ``(q_eff [b, s, heads, width], latent [b, s, 1, width])`` (the
    heads of ``wq``'s shard), the
    query absorbed through ``w_uk`` and scaled for the kernels, and the
    token's latent ``[c_kv ; rope key]`` (plus ``latent_pad`` zeros), which
    is its K and V. A fused layer (``w_mla_in``) computes ``wq``'s (q-LoRA:
    ``w_dq``'s), ``w_dkv``'s and ``w_kr``'s outputs in one product."""
    batch, seq = attn_in.shape[:2]
    r, dr, hd = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.head_dim
    if "w_mla_in" in layer:  # fused serving layout (fuse_params), canonical order
        fused = attn_in @ layer["w_mla_in"]
        qc = fused.shape[-1] - r - dr
        q, c_kv, k_rope_in = fused[..., :qc], fused[..., qc:qc + r], fused[..., qc + r:]
        if "q_latent_norm" in layer:  # q-LoRA: the block holds w_dq's output
            q = _rms_norm(q, layer["q_latent_norm"], cfg.norm_eps) @ layer["wq"]
    else:
        q_in = attn_in
        if "w_dq" in layer:  # q-LoRA: down-projection, norm, up-projection
            q_in = _rms_norm(attn_in @ layer["w_dq"], layer["q_latent_norm"], cfg.norm_eps)
        q = q_in @ layer["wq"]
        c_kv = attn_in @ layer["w_dkv"]  # [b, s, r]
        k_rope_in = attn_in @ layer["w_kr"]
    q = q.reshape(batch, seq, -1, hd + dr)  # the shard's heads
    if "latent_norm" in layer:  # kv_a_layernorm: the latent is cached post-norm
        c_kv = _rms_norm(c_kv, layer["latent_norm"], cfg.norm_eps)
    q_rope = _rope(q[..., hd:], positions, cfg.rope_theta, cfg.rope_scaling)
    k_rope = _rope(k_rope_in[:, :, None, :], positions,
                   cfg.rope_theta, cfg.rope_scaling)  # [b, s, 1, dr]
    latent = torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)  # [b, s, 1, r + dr]
    # Absorb W_UK: q . (latent W_UK) == (q W_UK^T) . latent.
    q_eff = torch.cat(
        [torch.einsum("bshd,hrd->bshr", q[..., :hd], layer["w_uk"]), q_rope], dim=-1)
    if cfg.latent_pad:
        latent = F.pad(latent, (0, cfg.latent_pad))
        q_eff = F.pad(q_eff, (0, cfg.latent_pad))
    # The kernels scale by the cache width^-0.5; MLA's logical scale is the
    # per-head q/k width (nope + rope)^-0.5, times softmax_scale_mult.
    q_eff = q_eff * (q_eff.shape[-1] ** 0.5 / (hd + dr) ** 0.5 * cfg.softmax_scale_mult)
    return q_eff, latent


def _layer_slots(cfg: LlamaConfig, groups: int) -> list[tuple[int, int]]:
    """Each layer's (cache group, index in its group's stacked pool): the
    layers themselves for one pool, ``group_layers(g)`` order for two."""
    if groups == 1:
        return [(0, li) for li in range(cfg.num_layers)]
    slots = {li: (g, j) for g in range(groups) for j, li in enumerate(cfg.group_layers(g))}
    return [slots[li] for li in range(cfg.num_layers)]


@torch.no_grad()
def _forward_impl_grouped(params: Params, cfg: LlamaConfig, tokens, k_caches, v_caches,
                          tables, ctx_lens, new_lens, attention: AttentionFn,
                          last_only: bool, ragged: torch.Tensor | None = None,
                          tails: tuple | None = None, tp=None,
                          capacity_tokens: int | None = None):
    """The JAX ``_forward_impl_grouped``: scatter the step's K/V into the
    pages, then attend over them, layer by layer, each layer with its own
    sliding window and the model's sinks. ``k_caches[g]`` holds cache group
    g's layers stacked in ``cfg.group_layers(g)`` order, with ``tables[g]``
    its page table; a model with one pool passes 1-tuples. An MLA model's
    latent is its K and V (the K pool passed as both), and its attention
    output is un-absorbed through ``w_uv``. A dense layer adds the QKV
    biases when the tree has them (Qwen2) and, under ``qk_norm``, normalises
    each head of Q and K over head_dim before RoPE (Qwen3).

    ``ragged=row_starts`` ([rows+1] flat-token prefix sums) is the ragged
    mixed-batch mode (one pool): ``tokens`` is one flat axis [1, total_q]
    where row r owns slots ``[row_starts[r], row_starts[r+1])`` at positions
    ``ctx_lens[r] + i``; ``ctx_lens``/``new_lens`` and the page table are
    per row, and ``last_only=True`` returns one logit row per ragged row
    (its final token; an empty row reads slot 0 and is ignored).

    ``tails=(tail_ks, tail_vs, ctx_base)`` is the fused-decode-burst mode
    (``seq == 1``): the paged caches are read-only, holding ``ctx_base``
    keys a row, and the token's K/V (an MLA model's latent) is written in
    place into group g's burst-local tail buffers ``tail_ks[g]``/
    ``tail_vs[g]`` ``[layers_g, batch, steps, kv_heads, width]`` at slot
    ``ctx_lens - ctx_base``, by live rows only (``new_lens`` 1); attention
    folds the tail after the paged keys, so a window's start moves with the
    tail. The caller scatters the tails into the pages after the burst.

    ``tp`` is a tensor-parallel rank's group (``params`` its shard, the
    pools its part): the embedding, the ``wo`` and ``w_down`` products and
    the logits take the group's collectives (the module docstring). Fused
    leaves (``fuse_params``) are split by ``split_fused_out`` at the rank's
    widths and interleave (``_rank_interleave``).

    An expert layer's MLP sees ``valid`` (padded positions, frozen burst
    rows and ragged slots past ``row_starts[-1]`` take no capacity slot) and
    ``capacity_tokens``, the token count its capacity is computed from
    (default: ``batch * seq``).
    """
    batch, seq = tokens.shape
    if ragged is not None:
        if tails is not None:
            raise ValueError("ragged mode is scatter-then-attend; burst tails are not "
                             "supported")
        if batch != 1:
            raise ValueError(
                f"ragged mode takes one flat token axis [1, total_q], got batch={batch}")
        rows = ctx_lens.shape[0]
        flat = torch.arange(seq, device=tokens.device, dtype=ragged.dtype)
        row_of = torch.clamp(
            torch.searchsorted(ragged, flat, right=True) - 1, 0, rows - 1)
        positions = (ctx_lens[row_of] + flat - ragged[row_of])[None, :]
        valid = (flat < ragged[-1])[None, :]

        def scatter(cache, new_kv, table):
            scatter_kv_pages_ragged(cache, new_kv[0], table, row_of, positions[0], valid[0])
    else:
        steps = torch.arange(seq, device=tokens.device, dtype=ctx_lens.dtype)
        positions = ctx_lens[:, None] + steps[None, :]  # [b, s]
        valid = steps[None, :] < new_lens[:, None]

        def scatter(cache, new_kv, table):
            scatter_kv_pages(cache, new_kv, table, positions, valid)
    total_lens = ctx_lens + new_lens
    if tails is not None:
        # One new token a live row: the write mask broadcasts valid [b, 1]
        # over the tail slots, so a longer step would mis-mask silently.
        if seq != 1:
            raise ValueError(f"tails mode requires seq == 1 (decode bursts), got {seq}")
        tail_ks, tail_vs, ctx_base = tails
        slot = ctx_lens - ctx_base  # [b] tail tokens already written
        tmask = (torch.arange(tail_ks[0].shape[2], device=tokens.device)[None, :]
                 == slot[:, None]) & valid  # [b, T]: live rows write one slot
        tail_lens = slot + new_lens  # attendable tail keys, the current one included

        def write_tail(buf, new_kv):  # buf [b, T, kvh, w], new_kv [b, 1, kvh, w]
            # An fp8 pool's tail is fp8 too: its tokens quantize exactly as
            # their scatter into the pages will.
            buf.copy_(torch.where(tmask[:, :, None, None], to_kv_dtype(new_kv, buf.dtype),
                                  buf))

    sinks = cfg.attention_sinks or None
    x = _embed(params["embed"], tokens, tp)  # [b, s, h]
    for li, ((g, lj), layer) in enumerate(zip(_layer_slots(cfg, len(k_caches)),
                                             params["layers"])):
        table = tables[g]
        k_pool = k_caches[g][lj]
        attn_in = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        if cfg.is_mla:
            q, k = _mla_project(cfg, layer, attn_in, positions)
            v = None  # the latent is also V
        else:
            if "w_qkv" in layer:  # fused serving layout (fuse_params)
                qkv = attn_in @ layer["w_qkv"]
                if "b_qkv" in layer:
                    qkv = qkv + layer["b_qkv"]
                # A rank's block: its heads' columns, nq / tp and nk / tp.
                size = 1 if tp is None else tp.size
                nq = cfg.num_heads * cfg.head_dim // size
                nk = cfg.num_kv_heads * cfg.head_dim // size
                q, k, v = split_fused_out(qkv, (nq, nk, qkv.shape[-1] - nq - nk),
                                          _rank_interleave(cfg, tp))
            else:
                q = attn_in @ layer["wq"]
                k = attn_in @ layer["wk"]
                v = attn_in @ layer["wv"]
                if "bq" in layer:  # Qwen2-lineage QKV projection biases
                    q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
            q = q.reshape(batch, seq, -1, cfg.head_dim)  # the shard's heads
            k = k.reshape(batch, seq, -1, cfg.head_dim)
            v = v.reshape(batch, seq, -1, cfg.head_dim)
            if cfg.qk_norm:  # Qwen3: per-head RMS over head_dim, before RoPE
                q = _rms_norm(q, layer["q_norm"], cfg.norm_eps)
                k = _rms_norm(k, layer["k_norm"], cfg.norm_eps)
            q = _rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
            k = _rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        v_pool = k_pool if v is None else v_caches[g][lj]
        kw = dict(shared_kv=v is None, window=cfg.layer_window(li), sinks=sinks)
        if tails is None:
            scatter(k_pool, k, table)
            if v is not None:
                scatter(v_pool, v, table)
            ctx = attention(q, k_pool, v_pool, table, positions, ctx_lens, total_lens, **kw)
        else:
            tail_k = tail_ks[g][lj]
            tail_v = tail_k if v is None else tail_vs[g][lj]
            write_tail(tail_k, k)
            if v is not None:
                write_tail(tail_v, v)
            ctx = attention(q, k_pool, v_pool, table, positions, ctx_lens, ctx_base,
                            tail_k=tail_k, tail_v=tail_v, tail_lens=tail_lens, **kw)
        if cfg.is_mla:  # un-absorb W_UV from the latent-width output
            ctx = torch.einsum("bshr,hrv->bshv", ctx[..., :cfg.kv_lora_rank], layer["w_uv"])
        attn_out = ctx.reshape(batch, seq, -1) @ layer["wo"]
        x = x + (attn_out if tp is None else tp.all_reduce_(attn_out))
        mlp_in = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        mlp_out = _mlp(mlp_in, layer, cfg, valid=valid, capacity_tokens=capacity_tokens, tp=tp)
        x = x + (mlp_out if tp is None else tp.all_reduce_(mlp_out))

    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        if ragged is not None:
            x = x[:, torch.clamp(ragged[1:] - 1, min=0).long()]  # [1, rows, h]
        else:
            idx = torch.clamp(new_lens - 1, min=0).long()
            x = x[torch.arange(batch, device=x.device), idx][:, None]
    logits = x @ params["lm_head"]
    if tp is not None:  # the ranks' vocab columns, gathered
        logits = tp.gather_vocab(logits)
    return logits.float()


def _forward_impl(params: Params, cfg: LlamaConfig, tokens, k_cache, v_cache, page_table,
                  ctx_lens, new_lens, attention: AttentionFn, last_only: bool,
                  ragged: torch.Tensor | None = None, tails: tuple | None = None, tp=None,
                  capacity_tokens: int | None = None):
    """``_forward_impl_grouped`` over one pool (the non-hybrid models);
    ``tails=(tail_k, tail_v, ctx_base)`` as there with one group's buffers,
    ``tp`` a rank's group. Returns ``(logits, k_cache, v_cache)``, the
    caches updated in place."""
    if tails is not None:
        tails = ((tails[0],), (tails[1],), tails[2])
    logits = _forward_impl_grouped(params, cfg, tokens, (k_cache,), (v_cache,),
                                   (page_table,), ctx_lens, new_lens, attention,
                                   last_only, ragged=ragged, tails=tails, tp=tp,
                                   capacity_tokens=capacity_tokens)
    return logits, k_cache, v_cache


def _step_attention(tokens: torch.Tensor, plain_attention: bool, cfg: LlamaConfig = None,
                    tp=None) -> AttentionFn:
    """The attention of one padded step: the plain version, or the decode
    kernel for one token a row and the prefill kernel for more (a
    tensor-parallel rank's: through the sharded wrappers)."""
    if plain_attention:
        return _plain_attention
    if tp is not None:
        return _sharded_attention(cfg, tp, tokens.shape[1] == 1)
    return _decode_attention if tokens.shape[1] == 1 else _prefill_attention


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            k_cache: torch.Tensor, v_cache: torch.Tensor,
            page_table: torch.Tensor, ctx_lens: torch.Tensor,
            new_lens: torch.Tensor, last_only: bool = False,
            plain_attention: bool = False, tp=None):
    """One model step (prefill or decode) on the tensors' device.

    ``tokens`` [batch, seq] (padded), caches ``[layers, pages, kvh, page,
    hd]`` (updated in place), ``page_table`` [batch, pages_per_seq] int32,
    ``ctx_lens`` [batch] int32 tokens already cached, ``new_lens`` [batch]
    int32 valid new tokens. Returns ``(logits [b, seq, vocab] fp32,
    k_cache, v_cache)``; ``last_only=True`` → logits ``[b, 1, vocab]`` at
    each row's final valid position. Query i of row b sits at
    ``ctx_lens[b] + i``; padded positions scatter to the garbage page.

    Attention runs the decode kernel when ``seq == 1`` and the prefill
    kernel otherwise (for an MLA config, the latent decode and latent
    prefill kernels). ``plain_attention=True`` runs the plain version
    instead — the yardstick ``chip_smoke.py`` holds the kernels against.
    Every layer keeps its window, so a hybrid config over one pool of all
    its layers computes what ``forward_hybrid`` computes over two. ``tp``:
    a tensor-parallel rank's step (its group, its shard of ``params``, its
    part of the pools), the kernels through the sharded wrappers.
    """
    return _forward_impl(params, cfg, tokens, k_cache, v_cache, page_table, ctx_lens,
                         new_lens, _step_attention(tokens, plain_attention, cfg, tp),
                         last_only, tp=tp)


def forward_hybrid(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                   k0: torch.Tensor, v0: torch.Tensor, k1: torch.Tensor, v1: torch.Tensor,
                   table0: torch.Tensor, table1: torch.Tensor, ctx_lens: torch.Tensor,
                   new_lens: torch.Tensor, last_only: bool = False,
                   plain_attention: bool = False):
    """One model step of a hybrid model over its two page pools (the JAX
    ``forward_hybrid``): group 0's full-attention layers read ``k0``/``v0``
    through ``table0``, group 1's SWA layers ``k1``/``v1`` through
    ``table1``, each at its index in ``cfg.group_layers(g)``. Otherwise as
    ``forward``: the decode kernel for ``seq == 1``, the prefill kernel for
    more, once a layer with that layer's pool, table and window, or the
    plain version with ``plain_attention=True``. (The JAX engine runs a
    hybrid single step on XLA attention; the kernels compute the same
    function.) Returns ``(logits, k0, v0, k1, v1)``, the pools updated in
    place."""
    logits = _forward_impl_grouped(
        params, cfg, tokens, (k0, k1), (v0, v1), (table0, table1), ctx_lens, new_lens,
        _step_attention(tokens, plain_attention), last_only)
    return logits, k0, v0, k1, v1


def forward_decode(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   page_table: torch.Tensor, ctx_lens: torch.Tensor,
                   new_lens: torch.Tensor, tp=None):
    """Decode step (seq == 1) through the flash-decode kernel (the JAX
    ``forward_decode_pallas``), caches updated in place as in ``forward``.
    Padded rows have ``new_lens == 0`` and ``ctx_lens == 0``; their logits
    are garbage and ignored. ``tp``: a tensor-parallel rank's step, as in
    ``forward`` (the sharded decode wrapper)."""
    if tokens.shape[1] != 1:
        raise ValueError(f"forward_decode takes one token per row, got {tokens.shape[1]}")
    return _forward_impl(params, cfg, tokens, k_cache, v_cache, page_table,
                         ctx_lens, new_lens, _step_attention(tokens, False, cfg, tp), False,
                         tp=tp)


def _decode_steps(params: Params, cfg: LlamaConfig, last_tokens, k_caches, v_caches,
                  tables, ctx_lens, active, steps: int, plain_attention: bool):
    """The burst loop over grouped pools (the JAX ``_decode_steps_scan``),
    shared by the one- and two-pool entry points: ``steps`` ticks over the
    frozen pages plus a burst-local tail a group, then one scatter a layer
    (and pool) moves the tails into the pages. Returns the tokens ``[batch,
    steps]``."""
    attention = _plain_attention if plain_attention else _decode_attention
    batch = last_tokens.shape[0]

    def tails_like(caches):
        return tuple(c.new_zeros((c.shape[0], batch, steps) + c.shape[2:3] + c.shape[4:])
                     for c in caches)

    tail_ks, tail_vs = tails_like(k_caches), tails_like(v_caches)
    toks, ctx, out = last_tokens, ctx_lens, []
    for tick in range(steps):
        live = (tick < active).to(ctx_lens.dtype)  # [batch]
        logits = _forward_impl_grouped(
            params, cfg, toks[:, None], k_caches, v_caches, tables, ctx, live,
            attention, False, tails=(tail_ks, tail_vs, ctx_lens))
        nxt = torch.argmax(logits[:, 0], dim=-1).to(toks.dtype)
        toks = torch.where(live > 0, nxt, toks)
        out.append(toks)
        ctx = ctx + live

    # The burst's tokens into the pages: one scatter a layer (and pool).
    slots = torch.arange(steps, device=ctx_lens.device, dtype=ctx_lens.dtype)[None, :]
    tpos = ctx_lens[:, None] + slots  # [batch, steps]
    tvalid = slots < torch.clamp(active, max=steps)[:, None]
    for k_cache, v_cache, tail_k, tail_v, table in zip(k_caches, v_caches, tail_ks,
                                                       tail_vs, tables):
        for li in range(k_cache.shape[0]):
            scatter_kv_pages(k_cache[li], tail_k[li], table, tpos, tvalid)
            if v_cache.shape[-1]:  # an MLA model's width-0 V pool holds nothing
                scatter_kv_pages(v_cache[li], tail_v[li], table, tpos, tvalid)
    return torch.stack(out, dim=1)


@torch.no_grad()
def forward_decode_steps(params: Params, cfg: LlamaConfig, last_tokens: torch.Tensor,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         page_table: torch.Tensor, ctx_lens: torch.Tensor,
                         active: torch.Tensor, steps: int,
                         plain_attention: bool = False):
    """Greedy decode of ``steps`` tokens a row in one call (the JAX
    ``forward_decode_steps`` and its ``_decode_steps_scan``).

    ``last_tokens`` [batch] is each row's newest token (its KV not yet
    computed), ``ctx_lens`` [batch] int32 the tokens already cached and
    ``active`` [batch] int32 each row's remaining token budget: a row
    decodes while the tick is below its budget and freezes after (its
    token repeats, its context stops, it writes nothing), so rows with
    ``active == 0`` are inert padding. Page tables must cover ``ctx_lens +
    min(active, steps)`` tokens.

    Every tick attends over the paged cache as it was when the burst began
    plus a burst-local KV tail ``[layers, batch, steps, kv_heads, width]``
    (for an MLA model the latent, with a width-0 V tail); after the last
    tick one scatter a layer moves the tail into the pages, in place. The
    ticks run through the decode kernels' tail arms, or the plain version
    with ``plain_attention=True``; the loop reads nothing on the host, so
    a CUDA graph can capture the whole call. Returns ``(tokens [batch,
    steps], k_cache, v_cache)``; row i's first ``min(active[i], steps)``
    tokens are valid.
    """
    toks = _decode_steps(params, cfg, last_tokens, (k_cache,), (v_cache,), (page_table,),
                         ctx_lens, active, steps, plain_attention)
    return toks, k_cache, v_cache


@torch.no_grad()
def forward_decode_steps_hybrid(params: Params, cfg: LlamaConfig,
                                last_tokens: torch.Tensor, k0: torch.Tensor,
                                v0: torch.Tensor, k1: torch.Tensor, v1: torch.Tensor,
                                table0: torch.Tensor, table1: torch.Tensor,
                                ctx_lens: torch.Tensor, active: torch.Tensor, steps: int,
                                plain_attention: bool = False):
    """``forward_decode_steps`` over a hybrid model's two pools (the JAX
    ``forward_decode_steps_hybrid``): both tables are frozen for the burst
    (the engine pre-extends the SWA table through every page the burst
    writes), each layer reads its group's pool and table with its window,
    and the tails scatter into both pools at the end. Returns ``(tokens
    [batch, steps], k0, v0, k1, v1)``."""
    toks = _decode_steps(params, cfg, last_tokens, (k0, k1), (v0, v1), (table0, table1),
                         ctx_lens, active, steps, plain_attention)
    return toks, k0, v0, k1, v1


def forward_prefill(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    page_table: torch.Tensor, ctx_lens: torch.Tensor,
                    new_lens: torch.Tensor, last_only: bool = False, tp=None):
    """Prefill chunk through the flash-prefill kernel (the JAX
    ``forward_prefill_pallas``), caches updated in place as in
    ``forward``; ``tp`` as there (the sharded prefill wrapper)."""
    attention = _prefill_attention if tp is None else _sharded_attention(cfg, tp, False)
    return _forward_impl(params, cfg, tokens, k_cache, v_cache, page_table,
                         ctx_lens, new_lens, attention, last_only, tp=tp)


def forward_ragged(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   page_table: torch.Tensor, row_starts: torch.Tensor,
                   ctx_lens: torch.Tensor, plain_attention: bool = False,
                   capacity_tokens: int | None = None):
    """One ragged mixed prefill+decode step through the ragged kernel (the
    JAX ``forward_ragged``), caches updated in place as in ``forward``.

    ``tokens`` [1, total_q] is one flat axis: row r's new tokens occupy
    slots ``[row_starts[r], row_starts[r+1])`` at positions
    ``ctx_lens[r] + i`` — a decode row is a 1-token row, a prefill chunk a
    longer one, with no per-row padding. ``page_table`` [rows,
    pages_per_seq], ``row_starts`` [rows+1] and ``ctx_lens`` [rows] are
    int32; slots at and past ``row_starts[-1]`` scatter to the garbage
    page. Returns ``(logits [rows, vocab] fp32, k_cache, v_cache)``: one
    row per ragged row, at its final token. An MLA model's rows run the
    kernel's ``shared_kv`` arm (the latent pool is K and V); every layer
    passes its window and the sinks. ``plain_attention=True`` runs the plain
    version instead, the yardstick of ``chip_smoke.py``.

    Every layer's launch has the same shapes, so on the card the dispatch
    is planned once (``plan_ragged_attention``: both arms' key splits and
    one workspace the layers share, from shapes only) and the plan passed
    to each layer. The plain version, and the CPU, need no plan.

    ``capacity_tokens``: the token count an expert layer's capacity
    dispatch computes its buffers from (default ``total_q``). The JAX
    engine pads the flat axis to a power of two (at least 8) and computes
    the capacity from that; the engine here passes that length, so the same
    assignments drop over its unpadded axis.
    """
    plan = None
    if not plain_attention and k_cache.device.type == "cuda":
        plan = plan_ragged_attention(tokens.shape[1], cfg.num_heads, k_cache[0], page_table,
                                     shared_kv=cfg.is_mla)

    def attention(q, k_l, v_l, table, positions, ctx, total_lens, shared_kv=False,
                  window=None, sinks=None):
        if plain_attention:
            return paged_ragged_attention(q[0], k_l, v_l, table, row_starts, ctx,
                                          sliding_window=window, sinks=sinks,
                                          shared_kv=shared_kv)[None]
        return cuda_paged_ragged_attention(q[0], k_l, v_l, table, row_starts, ctx,
                                           sliding_window=window, sinks=sinks,
                                           shared_kv=shared_kv, plan=plan)[None]

    logits, k_cache, v_cache = _forward_impl(
        params, cfg, tokens, k_cache, v_cache, page_table, ctx_lens,
        row_starts[1:] - row_starts[:-1], attention, True, ragged=row_starts,
        capacity_tokens=capacity_tokens)
    return logits[0], k_cache, v_cache
