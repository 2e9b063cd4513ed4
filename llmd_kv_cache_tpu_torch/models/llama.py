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

Fused projections and MoE are later slices.
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
)
from ..ops.kv_pages import scatter_kv_pages, scatter_kv_pages_ragged, to_kv_dtype
from ..ops.paged_attention import paged_attention, paged_ragged_attention

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


@dataclass(frozen=True)
class LlamaConfig:
    """Mirror of the JAX ``LlamaConfig`` for the dense and absorbed-MLA
    paths and the attention layouts of the model families (sliding windows,
    sinks, QK-norm, hybrid); ``dtype`` is a torch dtype (the JAX field holds
    a ``jnp`` dtype). The fields and their validation are the JAX ones."""

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
        if self.attention_sinks:
            if self.sliding_window is None:
                raise ValueError("attention_sinks requires sliding_window")
            if self.is_hybrid:
                raise ValueError(
                    "attention sinks need a uniform-SWA model "
                    "(sink_full_attention); hybrid layouts would reclaim "
                    "sink blocks from the window-bounded SWA pool")

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


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters from ``seed`` (truncated-normal projections scaled
    by 0.02, ones for the norms), laid out like the JAX ``init_params``
    tree. The numbers differ from JAX's for the same seed; tests that need
    equal weights convert the JAX tree with ``params_from_jax``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, hd = cfg.hidden_size, cfg.head_dim

    def dense(*shape):
        return (_truncated_normal(shape, gen, device) * 0.02).to(cfg.dtype)

    def ones():
        return torch.ones(h, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        if cfg.is_mla:
            r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
            attn = {
                "wq": dense(h, cfg.num_heads * (hd + dr)),
                "w_dkv": dense(h, r),
                "w_kr": dense(h, dr),
                "w_uk": dense(cfg.num_heads, r, hd),
                "w_uv": dense(cfg.num_heads, r, hd),
            }
        else:
            attn = {
                "wq": dense(h, cfg.num_heads * hd),
                "wk": dense(h, cfg.num_kv_heads * hd),
                "wv": dense(h, cfg.num_kv_heads * hd),
            }
        if cfg.qk_norm:
            attn["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
            attn["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        layers.append({
            "attn_norm": ones(),
            **attn,
            "wo": dense(cfg.num_heads * hd, h),
            "mlp_norm": ones(),
            "w_gate": dense(h, cfg.intermediate_size),
            "w_up": dense(h, cfg.intermediate_size),
            "w_down": dense(cfg.intermediate_size, h),
        })
    return {
        "embed": dense(cfg.vocab_size, h),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense(h, cfg.vocab_size),
    }


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 arrays, which torch.from_numpy refuses: move
        # the raw 16-bit words and reinterpret them.
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Params, cfg: LlamaConfig, device="cuda") -> Params:
    """Carry a JAX ``init_params`` tree (leaves converted to numpy) across.

    The orientation is kept as it is (``x @ W``); only the unfused dense
    and MLA layouts are accepted (an MLA layer may carry ``latent_norm``
    and q-LoRA's ``w_dq``/``q_latent_norm``, as ``params_from_hf`` gives
    them; a dense layer Qwen2's ``bq``/``bk``/``bv`` biases and, under
    ``qk_norm``, Qwen3's ``q_norm``/``k_norm``).
    """
    device = resolve_device(device)
    if cfg.is_mla:
        known = _MLA_LAYER_KEYS
    else:
        known = _LAYER_KEYS | _BIAS_KEYS | (_QK_NORM_KEYS if cfg.qk_norm else frozenset())
    layers = []
    for layer in tree["layers"]:
        unknown = set(layer) - known
        if unknown:
            raise NotImplementedError(
                f"layer parameters {sorted(unknown)} are not in the ported slices")
        if cfg.qk_norm and not _QK_NORM_KEYS <= set(layer):
            raise ValueError("a qk_norm config needs q_norm and k_norm in every layer")
        biases = _BIAS_KEYS & set(layer)
        if biases and biases != _BIAS_KEYS:
            raise ValueError(f"QKV biases come as bq, bk and bv together, got {sorted(biases)}")
        layers.append({k: _leaf_from_numpy(v, device) for k, v in layer.items()})
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree has {len(layers)} layers, config {cfg.num_layers}")
    return {
        "embed": _leaf_from_numpy(tree["embed"], device),
        "layers": layers,
        "final_norm": _leaf_from_numpy(tree["final_norm"], device),
        "lm_head": _leaf_from_numpy(tree["lm_head"], device),
    }


def init_kv_cache(cfg: LlamaConfig, num_pages: int, dtype=None,
                  device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the paged K and V pools ``[layers, pages, kvh, page, hd]``,
    zeroed so no page ever holds non-finite bytes, in ``dtype`` (default
    the model's). ``torch.float8_e4m3fn`` halves the pools' bytes: new
    K/V are cast on write (``to_kv_dtype``) and attention upcasts on read.

    MLA: the K pool holds each token's latent row as one shared head
    (``kvh = 1``, ``hd = kv_cache_head_dim``) and the V pool has width 0:
    attention reads the values from the latent itself."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.kv_cache_heads, cfg.page_size,
             cfg.kv_cache_head_dim)
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


def _mlp(mlp_in: torch.Tensor, layer: dict) -> torch.Tensor:
    """Dense SwiGLU (the JAX ``_mlp`` unfused branch)."""
    gate = F.silu((mlp_in @ layer["w_gate"]).float())
    up = (mlp_in @ layer["w_up"]).float()
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


def _mla_project(cfg: LlamaConfig, layer: dict, attn_in, positions):
    """The absorbed-MLA projections of the JAX ``_forward_impl_grouped``:
    returns ``(q_eff [b, s, heads, width], latent [b, s, 1, width])``, the
    query absorbed through ``w_uk`` and scaled for the kernels, and the
    token's latent ``[c_kv ; rope key]`` (plus ``latent_pad`` zeros), which
    is its K and V."""
    batch, seq = attn_in.shape[:2]
    r, dr, hd = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.head_dim
    q_in = attn_in
    if "w_dq" in layer:  # q-LoRA: down-projection, norm, up-projection
        q_in = _rms_norm(attn_in @ layer["w_dq"], layer["q_latent_norm"], cfg.norm_eps)
    q = (q_in @ layer["wq"]).reshape(batch, seq, cfg.num_heads, hd + dr)
    c_kv = attn_in @ layer["w_dkv"]  # [b, s, r]
    if "latent_norm" in layer:  # kv_a_layernorm: the latent is cached post-norm
        c_kv = _rms_norm(c_kv, layer["latent_norm"], cfg.norm_eps)
    q_rope = _rope(q[..., hd:], positions, cfg.rope_theta, cfg.rope_scaling)
    k_rope = _rope((attn_in @ layer["w_kr"])[:, :, None, :], positions,
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
                          tails: tuple | None = None):
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
    x = params["embed"][tokens.long()]  # [b, s, h]
    for li, ((g, lj), layer) in enumerate(zip(_layer_slots(cfg, len(k_caches)),
                                             params["layers"])):
        table = tables[g]
        k_pool = k_caches[g][lj]
        attn_in = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        if cfg.is_mla:
            q, k = _mla_project(cfg, layer, attn_in, positions)
            v = None  # the latent is also V
        else:
            q = attn_in @ layer["wq"]
            k = attn_in @ layer["wk"]
            v = attn_in @ layer["wv"]
            if "bq" in layer:  # Qwen2-lineage QKV projection biases
                q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
            q = q.reshape(batch, seq, cfg.num_heads, cfg.head_dim)
            k = k.reshape(batch, seq, cfg.num_kv_heads, cfg.head_dim)
            v = v.reshape(batch, seq, cfg.num_kv_heads, cfg.head_dim)
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
        x = x + ctx.reshape(batch, seq, -1) @ layer["wo"]
        mlp_in = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(mlp_in, layer)

    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        if ragged is not None:
            x = x[:, torch.clamp(ragged[1:] - 1, min=0).long()]  # [1, rows, h]
        else:
            idx = torch.clamp(new_lens - 1, min=0).long()
            x = x[torch.arange(batch, device=x.device), idx][:, None]
    return (x @ params["lm_head"]).float()


def _forward_impl(params: Params, cfg: LlamaConfig, tokens, k_cache, v_cache, page_table,
                  ctx_lens, new_lens, attention: AttentionFn, last_only: bool,
                  ragged: torch.Tensor | None = None, tails: tuple | None = None):
    """``_forward_impl_grouped`` over one pool (the non-hybrid models);
    ``tails=(tail_k, tail_v, ctx_base)`` as there with one group's buffers.
    Returns ``(logits, k_cache, v_cache)``, the caches updated in place."""
    if tails is not None:
        tails = ((tails[0],), (tails[1],), tails[2])
    logits = _forward_impl_grouped(params, cfg, tokens, (k_cache,), (v_cache,),
                                   (page_table,), ctx_lens, new_lens, attention,
                                   last_only, ragged=ragged, tails=tails)
    return logits, k_cache, v_cache


def _step_attention(tokens: torch.Tensor, plain_attention: bool) -> AttentionFn:
    """The attention of one padded step: the plain version, or the decode
    kernel for one token a row and the prefill kernel for more."""
    if plain_attention:
        return _plain_attention
    return _decode_attention if tokens.shape[1] == 1 else _prefill_attention


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            k_cache: torch.Tensor, v_cache: torch.Tensor,
            page_table: torch.Tensor, ctx_lens: torch.Tensor,
            new_lens: torch.Tensor, last_only: bool = False,
            plain_attention: bool = False):
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
    its layers computes what ``forward_hybrid`` computes over two.
    """
    return _forward_impl(params, cfg, tokens, k_cache, v_cache, page_table, ctx_lens,
                         new_lens, _step_attention(tokens, plain_attention), last_only)


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
                   new_lens: torch.Tensor):
    """Decode step (seq == 1) through the flash-decode kernel (the JAX
    ``forward_decode_pallas``), caches updated in place as in ``forward``.
    Padded rows have ``new_lens == 0`` and ``ctx_lens == 0``; their logits
    are garbage and ignored."""
    if tokens.shape[1] != 1:
        raise ValueError(f"forward_decode takes one token per row, got {tokens.shape[1]}")
    return _forward_impl(params, cfg, tokens, k_cache, v_cache, page_table,
                         ctx_lens, new_lens, _decode_attention, False)


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
                    new_lens: torch.Tensor, last_only: bool = False):
    """Prefill chunk through the flash-prefill kernel (the JAX
    ``forward_prefill_pallas``), caches updated in place as in
    ``forward``."""
    return _forward_impl(params, cfg, tokens, k_cache, v_cache, page_table,
                         ctx_lens, new_lens, _prefill_attention, last_only)


def forward_ragged(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   page_table: torch.Tensor, row_starts: torch.Tensor,
                   ctx_lens: torch.Tensor, plain_attention: bool = False):
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
        row_starts[1:] - row_starts[:-1], attention, True, ragged=row_starts)
    return logits[0], k_cache, v_cache
