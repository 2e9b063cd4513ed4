"""Paged KV-cache page scatter/gather.

Port of ``llmd_kv_cache_tpu/ops/kv_pages.py``. One physical pool of pages
per layer, shape ``[num_pages, kv_heads, page_size, head_dim]``, addressed
through per-sequence page tables. Padded positions are routed to a reserved
garbage page (page 0) instead of branching, so every call has one shape.

Where JAX returned an updated copy of a donated cache, ``scatter_kv_pages``
and ``scatter_kv_pages_ragged`` write in place (``index_put_`` on the cache
they are given — the engine passes ``k_cache[layer]``, a view of its
stacked pool). Values enter a pool through ``to_kv_dtype``, which casts to
an fp8 (e4m3) pool by the JAX package's rule, byte for byte.
"""

from __future__ import annotations

import torch

# Physical page 0 is reserved as the write target for padded/invalid
# positions so scatters need no data-dependent control flow.
GARBAGE_PAGE = 0

# float8_e4m3fn: 4 exponent bits (bias 7), 3 mantissa bits, no infinity.
# |x| above 464 (the midpoint between the largest finite value, 448, and
# the 480 the format cannot hold) and +-inf are NaN, 0x7f | sign.
_E4M3_OVERFLOW = 464.0


def to_kv_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a pool of ``dtype`` holds it: ``x.to(dtype)``, except for
    ``torch.float8_e4m3fn``, which is cast as the JAX package's
    ``astype(jnp.float8_e4m3fn)`` casts (the rule of ``ml_dtypes`` and
    XLA): round to nearest even from ``x``'s own value (bf16 or fp32), and
    NaN — 0x7f, 0xff for a negative input — where the value is past e4m3's
    range (|x| > 464) or infinite. ``Tensor.to`` rounds as JAX does up to
    there and saturates past it to +-448 (0x7e | sign). A cast can give
    nothing there but +-448 or NaN (0x7f | sign), so setting the low bit
    of those codes gives JAX's NaN whichever it chose. Elementwise ops on
    ``x``'s device with no host sync, so a CUDA graph captures them. The
    upcast back (``.to(torch.bfloat16)`` or fp32) is exact."""
    out = x.to(dtype)
    if dtype != torch.float8_e4m3fn or x.dtype == dtype:
        return out
    past = x.abs() > _E4M3_OVERFLOW
    return (out.view(torch.uint8) | past).view(torch.float8_e4m3fn)


def scatter_kv_pages(
    cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim]
    new_kv: torch.Tensor,  # [batch, seq, kv_heads, head_dim]
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32 (physical page ids)
    positions: torch.Tensor,  # [batch, seq] logical positions
    valid: torch.Tensor,  # [batch, seq] bool
) -> torch.Tensor:
    """Write new K or V vectors into their pages, in place; returns ``cache``.

    Invalid slots scatter into the garbage page.
    """
    num_pages, kv_heads, page_size, head_dim = cache.shape
    batch, seq = positions.shape
    # Clamp: padded positions can point past the page table (their writes
    # are redirected to the garbage page below anyway).
    logical_page = torch.clamp(positions // page_size, max=page_table.shape[1] - 1)
    slot = positions % page_size
    phys_page = torch.gather(page_table.long(), 1, logical_page.long())
    phys_page = torch.where(valid, phys_page, GARBAGE_PAGE)
    slot = torch.where(valid, slot, 0).long()
    vals = to_kv_dtype(new_kv, cache.dtype).reshape(batch * seq, kv_heads, head_dim)
    cache[phys_page.reshape(-1), :, slot.reshape(-1)] = vals
    return cache


def scatter_kv_pages_ragged(
    cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim]
    new_kv: torch.Tensor,  # [total_q, kv_heads, head_dim] flat mixed batch
    page_table: torch.Tensor,  # [rows, pages_per_seq] int32
    row_of: torch.Tensor,  # [total_q] owning row per flat token
    positions: torch.Tensor,  # [total_q] logical positions
    valid: torch.Tensor,  # [total_q] bool
) -> torch.Tensor:
    """``scatter_kv_pages`` over a ragged flat token axis, in place;
    returns ``cache``.

    Each flat token knows its owning row and logical position; the page
    lookup is ``page_table[row, logical_page]``. Invalid slots go to the
    garbage page.
    """
    page_size = cache.shape[2]
    logical_page = torch.clamp(positions // page_size, max=page_table.shape[1] - 1)
    slot = positions % page_size
    row = torch.clamp(row_of, 0, page_table.shape[0] - 1)
    phys_page = page_table[row.long(), logical_page.long()].long()
    phys_page = torch.where(valid, phys_page, GARBAGE_PAGE)
    slot = torch.where(valid, slot, 0).long()
    cache[phys_page, :, slot] = to_kv_dtype(new_kv, cache.dtype)
    return cache


def gather_kv_pages(
    cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim]
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
) -> torch.Tensor:
    """Gather each sequence's pages into logical order.

    Returns ``[batch, pages_per_seq * page_size, kv_heads, head_dim]``.
    """
    batch, pages_per_seq = page_table.shape
    _, kv_heads, page_size, head_dim = cache.shape
    gathered = cache[page_table.long()]  # [batch, pages_per_seq, kv, page_size, hd]
    return gathered.permute(0, 1, 3, 2, 4).reshape(
        batch, pages_per_seq * page_size, kv_heads, head_dim
    )


def gather_pages_flat(
    cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim]
    page_ids: torch.Tensor,  # [n] int32 physical page ids
) -> torch.Tensor:
    """Gather arbitrary physical pages into one contiguous block
    ``[n, kv_heads, page_size, head_dim]`` (the offload store's slab)."""
    return cache[page_ids.long()]
