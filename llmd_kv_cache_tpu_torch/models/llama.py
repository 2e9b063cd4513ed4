"""Dense GQA Llama over a paged KV cache, in PyTorch.

Port of the dense path of ``llmd_kv_cache_tpu/models/llama.py``: RMSNorm,
half-split RoPE with fp32 angles, grouped-query attention over the paged
pool ``[layers, pages, kv_heads, page_size, head_dim]``, and the unfused
SwiGLU MLP. Parameters are a plain dict mirroring the JAX tree, with the
same ``x @ W`` orientation (``W`` is ``[in, out]``), so ``params_from_jax``
converts leaf by leaf with no transposes.

One step serves prefill and decode: queries at logical positions
``ctx_lens + i`` attend to everything already in the paged cache plus
themselves. Where JAX donated the caches to the jit, this port writes the
new K/V into them in place (``scatter_kv_pages`` on each layer's view) and
returns the same tensors. ``forward_ragged`` serves a mixed step (decode
rows and a prefill chunk on one flat token axis) in one attention launch
per layer. Attention runs through the Hopper kernels in
``ops.cuda_paged_attention``; for CPU tensors those wrappers run the plain
version.

Fused projections, MoE, MLA, QK-norm, RoPE scaling, sliding-window/hybrid
models and fused decode bursts are later slices.
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
)
from ..ops.kv_pages import scatter_kv_pages, scatter_kv_pages_ragged
from ..ops.paged_attention import paged_attention, paged_ragged_attention

Params = dict[str, Any]

_LAYER_KEYS = frozenset(
    ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down"))


@dataclass(frozen=True)
class LlamaConfig:
    """Mirror of the JAX ``LlamaConfig`` for the dense path; ``dtype`` is a
    torch dtype (the JAX field holds a ``jnp`` dtype)."""

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

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Test-sized config (the JAX package's ``LlamaConfig.tiny``)."""
        return cls(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4,
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
        layers.append({
            "attn_norm": ones(),
            "wq": dense(h, cfg.num_heads * hd),
            "wk": dense(h, cfg.num_kv_heads * hd),
            "wv": dense(h, cfg.num_kv_heads * hd),
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

    The orientation is kept as it is (``x @ W``); only the dense unfused
    layout of this slice is accepted.
    """
    device = resolve_device(device)
    layers = []
    for layer in tree["layers"]:
        unknown = set(layer) - _LAYER_KEYS
        if unknown:
            raise NotImplementedError(
                f"layer parameters {sorted(unknown)} are not in the dense slice")
        layers.append({k: _leaf_from_numpy(v, device) for k, v in layer.items()})
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree has {len(layers)} layers, config {cfg.num_layers}")
    return {
        "embed": _leaf_from_numpy(tree["embed"], device),
        "layers": layers,
        "final_norm": _leaf_from_numpy(tree["final_norm"], device),
        "lm_head": _leaf_from_numpy(tree["lm_head"], device),
    }


def init_kv_cache(cfg: LlamaConfig, num_pages: int,
                  device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the paged K and V pools ``[layers, pages, kvh, page, hd]``,
    zeroed so no page ever holds non-finite bytes."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, cfg.page_size,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _mlp(mlp_in: torch.Tensor, layer: dict) -> torch.Tensor:
    """Dense SwiGLU (the JAX ``_mlp`` unfused branch)."""
    gate = F.silu((mlp_in @ layer["w_gate"]).float())
    up = (mlp_in @ layer["w_up"]).float()
    return (gate * up).to(mlp_in.dtype) @ layer["w_down"]


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding (half-split). x: [b, s, heads, hd],
    positions: [b, s]; angles in fp32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [b, s, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# attention(q, k_layer, v_layer, page_table, positions, ctx_lens, total_lens)
AttentionFn = Callable[..., torch.Tensor]


def _plain_attention(q, k_l, v_l, table, positions, ctx_lens, total_lens):
    return paged_attention(q, k_l, v_l, table, positions, total_lens)


def _decode_attention(q, k_l, v_l, table, positions, ctx_lens, total_lens):
    return cuda_paged_decode_attention(q[:, 0], k_l, v_l, table, total_lens)[:, None]


def _prefill_attention(q, k_l, v_l, table, positions, ctx_lens, total_lens):
    return cuda_paged_prefill_attention(q, k_l, v_l, table, ctx_lens, total_lens)


@torch.no_grad()
def _forward_impl(params: Params, cfg: LlamaConfig, tokens, k_cache, v_cache,
                  page_table, ctx_lens, new_lens, attention: AttentionFn,
                  last_only: bool, ragged: torch.Tensor | None = None):
    """The dense branch of the JAX ``_forward_impl_grouped``: scatter the
    step's K/V into the pages, then attend over them, layer by layer.

    ``ragged=row_starts`` ([rows+1] flat-token prefix sums) is the ragged
    mixed-batch mode: ``tokens`` is one flat axis [1, total_q] where row r
    owns slots ``[row_starts[r], row_starts[r+1])`` at positions
    ``ctx_lens[r] + i``; ``ctx_lens``/``new_lens`` and ``page_table`` are
    per row, and ``last_only=True`` returns one logit row per ragged row
    (its final token; an empty row reads slot 0 and is ignored).
    """
    batch, seq = tokens.shape
    if ragged is not None:
        if batch != 1:
            raise ValueError(
                f"ragged mode takes one flat token axis [1, total_q], got batch={batch}")
        rows = ctx_lens.shape[0]
        flat = torch.arange(seq, device=tokens.device, dtype=ragged.dtype)
        row_of = torch.clamp(
            torch.searchsorted(ragged, flat, right=True) - 1, 0, rows - 1)
        positions = (ctx_lens[row_of] + flat - ragged[row_of])[None, :]
        valid = (flat < ragged[-1])[None, :]

        def scatter(cache, new_kv):
            scatter_kv_pages_ragged(cache, new_kv[0], page_table, row_of,
                                    positions[0], valid[0])
    else:
        steps = torch.arange(seq, device=tokens.device, dtype=ctx_lens.dtype)
        positions = ctx_lens[:, None] + steps[None, :]  # [b, s]
        valid = steps[None, :] < new_lens[:, None]

        def scatter(cache, new_kv):
            scatter_kv_pages(cache, new_kv, page_table, positions, valid)
    total_lens = ctx_lens + new_lens

    x = params["embed"][tokens.long()]  # [b, s, h]
    for li, layer in enumerate(params["layers"]):
        attn_in = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = (attn_in @ layer["wq"]).reshape(batch, seq, cfg.num_heads, cfg.head_dim)
        k = (attn_in @ layer["wk"]).reshape(batch, seq, cfg.num_kv_heads, cfg.head_dim)
        v = (attn_in @ layer["wv"]).reshape(batch, seq, cfg.num_kv_heads, cfg.head_dim)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        scatter(k_cache[li], k)
        scatter(v_cache[li], v)
        attn = attention(q, k_cache[li], v_cache[li], page_table, positions,
                         ctx_lens, total_lens)
        x = x + attn.reshape(batch, seq, -1) @ layer["wo"]
        mlp_in = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(mlp_in, layer)

    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        if ragged is not None:
            x = x[:, torch.clamp(ragged[1:] - 1, min=0).long()]  # [1, rows, h]
        else:
            idx = torch.clamp(new_lens - 1, min=0).long()
            x = x[torch.arange(batch, device=x.device), idx][:, None]
    logits = (x @ params["lm_head"]).float()
    return logits, k_cache, v_cache


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
    kernel otherwise. ``plain_attention=True`` runs the plain version
    instead — the yardstick ``chip_smoke.py`` holds the kernels against.
    """
    if plain_attention:
        attention = _plain_attention
    elif tokens.shape[1] == 1:
        attention = _decode_attention
    else:
        attention = _prefill_attention
    return _forward_impl(params, cfg, tokens, k_cache, v_cache, page_table,
                         ctx_lens, new_lens, attention, last_only)


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
    row per ragged row, at its final token. ``plain_attention=True`` runs
    the plain version instead, the yardstick of ``chip_smoke.py``.
    """
    ragged_attention = (paged_ragged_attention if plain_attention
                        else cuda_paged_ragged_attention)

    def attention(q, k_l, v_l, table, positions, ctx, total_lens):
        return ragged_attention(q[0], k_l, v_l, table, row_starts, ctx)[None]

    logits, k_cache, v_cache = _forward_impl(
        params, cfg, tokens, k_cache, v_cache, page_table, ctx_lens,
        row_starts[1:] - row_starts[:-1], attention, True, ragged=row_starts)
    return logits[0], k_cache, v_cache
