"""Flash attention over a paged KV cache: the hand-written Hopper kernels.

Port of ``llmd_kv_cache_tpu/ops/pallas_paged_attention.py``'s kernels on
the serving paths:

- ``cuda_paged_decode_attention`` replaces ``_decode_kernel_merged``
  (reached through ``pallas_paged_decode_attention``);
- ``cuda_paged_prefill_attention`` replaces ``_prefill_kernel`` (reached
  through ``pallas_paged_prefill_attention``);
- ``cuda_paged_ragged_attention`` replaces ``_ragged_kernel`` (reached
  through ``pallas_paged_ragged_attention``), the engine's ragged mixed
  prefill+decode path.

The kernels live in ``csrc/paged_attention.cu`` (design and bounds are in
the notes there) and are built at first use by ``cuda_build``. The TPU
blocking does not carry over: the wrappers take one layer's contiguous
view of the cache (``k_cache[layer]`` — no stacked operand and no
``layer_idx``), and each CUDA block loads its own page ids from the table.

Each wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors — and only for those — it runs the plain version,
``ops.paged_attention``. Each counts its kernel launches in ``.launches``,
a plain integer, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from .cuda_build import load_library
from .paged_attention import paged_attention, paged_ragged_attention

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)


def _window_args(sliding_window, sinks) -> tuple[int, int]:
    if sliding_window is None:
        # Without a window every position is causally attendable anyway:
        # the sink mask is a no-op (as in the JAX wrappers).
        return -1, 0
    if sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")
    return int(sliding_window), int(sinks or 0)


def _check_cuda_operands(q, k_cache, v_cache, page_table, lens, q_heads):
    device = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("page_table", page_table), *lens):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q is on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the CUDA kernels take bf16 only ({name} is {t.dtype}; "
                "fp8 caches are not ported yet)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("page_table", page_table), *lens):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            "k_cache/v_cache must be one layer's [pages, kv_heads, page_size, "
            f"head_dim] view, got {tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    _, kv_heads, _, head_dim = k_cache.shape
    if q.shape[-1] != head_dim:
        raise ValueError(f"q head_dim {q.shape[-1]} != cache head_dim {head_dim}")
    if head_dim not in _HEAD_DIMS:
        raise NotImplementedError(f"head_dim {head_dim} not in {_HEAD_DIMS}")
    if q_heads % kv_heads or q_heads // kv_heads not in _GROUPS:
        raise NotImplementedError(
            f"q_heads/kv_heads = {q_heads}/{kv_heads}: GQA group must be one of {_GROUPS}")


def cuda_paged_decode_attention(
    q: torch.Tensor,  # [batch, q_heads, head_dim]
    k_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim] (one layer)
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    ctx_lens: torch.Tensor,  # [batch] int32 keys to attend (query at ctx_len - 1)
    *,
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
    tail_k: torch.Tensor | None = None,
    tail_v: torch.Tensor | None = None,
    tail_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash-decode over paged KV. Returns ``[batch, q_heads, head_dim]``.

    A row with ``ctx_len == 0`` (a padded decode row) returns zeros from the
    kernel; the plain version averages the garbage page there instead, and
    callers ignore such rows either way. The TPU kernel's ``shared_kv``
    (MLA) and decode-burst tail arms are not ported yet and raise.
    """
    if shared_kv or tail_k is not None or tail_v is not None or tail_lens is not None:
        raise NotImplementedError(
            "the shared_kv (MLA) and decode-burst tail arms are not ported yet")
    if q.device.type == "cpu":
        return paged_attention(
            q[:, None], k_cache, v_cache, page_table, (ctx_lens - 1)[:, None],
            ctx_lens, sliding_window=sliding_window,
            attention_sinks=sinks if sliding_window is not None else None,
        )[:, 0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    window, n_sinks = _window_args(sliding_window, sinks)
    batch, q_heads, head_dim = q.shape
    _check_cuda_operands(q, k_cache, v_cache, page_table,
                         (("ctx_lens", ctx_lens),), q_heads)
    if page_table.shape[0] != batch or ctx_lens.shape != (batch,):
        raise ValueError("page_table/ctx_lens batch does not match q")
    _, kv_heads, page_size, _ = k_cache.shape
    out = torch.empty_like(q)
    rc = load_library().llmd_paged_decode_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        batch, q_heads, kv_heads, head_dim, page_size, page_table.shape[1],
        window, n_sinks, head_dim ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel failed to launch (code {rc})")
    cuda_paged_decode_attention.launches += 1
    return out


cuda_paged_decode_attention.launches = 0


def cuda_paged_prefill_attention(
    q: torch.Tensor,  # [batch, q_seq, q_heads, head_dim] (new tokens, padded)
    k_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim] (one layer)
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    ctx_lens: torch.Tensor,  # [batch] int32 cached tokens before the new ones
    total_lens: torch.Tensor,  # [batch] int32 ctx + valid new tokens
    *,
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
) -> torch.Tensor:
    """Flash prefill over paged KV (new tokens' KV already scattered).

    Query ``i`` of row ``b`` sits at ``ctx_lens[b] + i`` and attends
    causally over the cached prefix and the new tokens before it. Returns
    ``[batch, q_seq, q_heads, head_dim]``. ``q_seq`` needs no padding to a
    tile multiple. The TPU kernel's ``shared_kv`` (MLA) arm is not ported
    yet and raises.
    """
    if shared_kv:
        raise NotImplementedError("the shared_kv (MLA) arm is not ported yet")
    batch, q_seq, q_heads, head_dim = q.shape
    if q.device.type == "cpu":
        positions = ctx_lens[:, None] + torch.arange(q_seq, device=q.device)[None]
        return paged_attention(
            q, k_cache, v_cache, page_table, positions, total_lens,
            sliding_window=sliding_window,
            attention_sinks=sinks if sliding_window is not None else None,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    window, n_sinks = _window_args(sliding_window, sinks)
    _check_cuda_operands(q, k_cache, v_cache, page_table,
                         (("ctx_lens", ctx_lens), ("total_lens", total_lens)),
                         q_heads)
    if (page_table.shape[0] != batch or ctx_lens.shape != (batch,)
            or total_lens.shape != (batch,)):
        raise ValueError("page_table/ctx_lens/total_lens batch does not match q")
    _, kv_heads, page_size, _ = k_cache.shape
    out = torch.empty_like(q)
    rc = load_library().llmd_paged_prefill_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), ctx_lens.data_ptr(), total_lens.data_ptr(),
        out.data_ptr(), batch, q_seq, q_heads, kv_heads, head_dim, page_size,
        page_table.shape[1], window, n_sinks, head_dim ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged prefill kernel failed to launch (code {rc})")
    cuda_paged_prefill_attention.launches += 1
    return out


cuda_paged_prefill_attention.launches = 0


def cuda_paged_ragged_attention(
    q: torch.Tensor,  # [total_q, q_heads, head_dim] flat mixed batch
    k_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim] (one layer)
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [rows, pages_per_seq] int32
    row_starts: torch.Tensor,  # [rows + 1] int32 flat-token prefix sums
    ctx_lens: torch.Tensor,  # [rows] int32 cached tokens before each row's new ones
    *,
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
    tail_k: torch.Tensor | None = None,
    tail_v: torch.Tensor | None = None,
    tail_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash attention over a ragged mixed prefill+decode batch, in one
    launch (new tokens' KV already scattered).

    Row r's tokens sit at flat slots ``[row_starts[r], row_starts[r+1])``
    at positions ``ctx_lens[r] + i`` and attend causally over row r's
    paged KV; a decode row is a 1-token row. ``row_starts`` is
    non-decreasing with ``row_starts[-1] <= total_q``; ``total_q`` needs no
    padding to any tile, and slots at and past ``row_starts[-1]`` are
    zeros. Returns ``[total_q, q_heads, head_dim]``. The TPU kernel's
    ``shared_kv`` (MLA), decode-burst tail and fp8 arms are not ported yet
    and raise.
    """
    if shared_kv or tail_k is not None or tail_v is not None or tail_lens is not None:
        raise NotImplementedError(
            "the shared_kv (MLA) and decode-burst tail arms are not ported yet")
    if q.device.type == "cpu":
        return paged_ragged_attention(
            q, k_cache, v_cache, page_table, row_starts, ctx_lens,
            sliding_window=sliding_window, sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    window, n_sinks = _window_args(sliding_window, sinks)
    total_q, q_heads, head_dim = q.shape
    _check_cuda_operands(q, k_cache, v_cache, page_table,
                         (("row_starts", row_starts), ("ctx_lens", ctx_lens)),
                         q_heads)
    rows = page_table.shape[0]
    if rows == 0 or row_starts.shape != (rows + 1,) or ctx_lens.shape != (rows,):
        raise ValueError("row_starts must be [rows + 1] and ctx_lens [rows] "
                         "for a page_table of rows > 0")
    _, kv_heads, page_size, _ = k_cache.shape
    # Each row's query tiles, prefix-summed on the device (no host sync):
    # the kernel finds a CTA's row in it. The tile size is the kernel's own.
    lib = load_library()
    tile_tokens = lib.llmd_ragged_tile_tokens(q_heads // kv_heads)
    lens = (row_starts[1:] - row_starts[:-1]).clamp_(min=0)
    tile_ends = torch.cumsum(
        (lens + tile_tokens - 1) // tile_tokens, 0, dtype=torch.int32)
    out = torch.empty_like(q)
    rc = lib.llmd_paged_ragged_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), row_starts.data_ptr(), ctx_lens.data_ptr(),
        tile_ends.data_ptr(), out.data_ptr(), total_q, rows, q_heads, kv_heads,
        head_dim, page_size, page_table.shape[1], window, n_sinks, head_dim ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged ragged kernel failed to launch (code {rc})")
    cuda_paged_ragged_attention.launches += 1
    return out


cuda_paged_ragged_attention.launches = 0
