"""Flash attention over a paged KV cache: the hand-written Hopper kernels.

Port of ``llmd_kv_cache_tpu/ops/pallas_paged_attention.py``'s kernels on
the serving paths:

- ``cuda_paged_decode_attention`` replaces ``_decode_kernel_merged``
  (reached through ``pallas_paged_decode_attention``), with its
  decode-burst tail fold (``_tail_fold``), as does the latent decode below;
  each (row, kv head)'s keys are split across ``decode_splits`` CTAs;
- ``cuda_paged_prefill_attention`` replaces ``_prefill_kernel`` (reached
  through ``pallas_paged_prefill_attention``);
- ``cuda_paged_ragged_attention`` replaces ``_ragged_kernel`` (reached
  through ``pallas_paged_ragged_attention``), the engine's ragged mixed
  prefill+decode path, with its decode-burst tail fold; its ``shared_kv``
  arm (absorbed MLA) runs the latent ragged kernel;
- ``cuda_paged_latent_decode_attention`` replaces ``_decode_kernel``, the
  per-(row, kv head) decode that ``pallas_paged_decode_attention`` runs
  when ``kv_heads == 1``: absorbed MLA (``shared_kv``, the latent pool is
  K and V) and MQA. ``cuda_paged_decode_attention`` routes ``kv_heads ==
  1`` and ``shared_kv`` to it, as the JAX wrapper does;
- ``cuda_paged_latent_prefill_attention`` replaces the ``shared_kv`` arm of
  ``_prefill_kernel``; ``cuda_paged_prefill_attention(shared_kv=True)``
  routes to it;
- ``sharded_paged_decode_attention`` and ``sharded_paged_prefill_attention``
  replace the JAX wrappers of the same names (the kernels once a tp shard
  under ``shard_map``): a tensor-parallel rank passes its local operands
  (its query heads, its kv heads or the whole single-head pool) and its
  group, and the wrapper checks the local head counts against the group
  size and calls the decode or prefill wrapper above on them. Attention
  needs no collective.

The kernels live in ``csrc/paged_attention.cu`` (GQA) and
``csrc/latent_attention.cu`` (single KV head, wide heads); design and
bounds are in the notes there. The three GQA wrappers also take K and V
pools of fp8 e4m3 (``torch.float8_e4m3fn``) beside a bf16 q — the
quantized arms of ``_decode_kernel_merged`` and ``_ragged_kernel``, and for
the prefill the JAX engine's XLA prefill of an fp8 pool — and launch the
kernels' fp8 instantiations, which stage 1-byte rows and upcast them
exactly; a burst tail of an fp8 pool is fp8 too. The single-KV-head
kernels (and the ragged ``shared_kv`` arm) refuse fp8, as the JAX wrapper
does. They are built at first use by
``cuda_build``. The TPU
blocking does not carry over: the wrappers take one layer's contiguous
view of the cache (``k_cache[layer]`` — no stacked operand and no
``layer_idx``), and each CUDA block loads its own page ids from the table.

Each wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors — and only for those — it runs the plain version,
``ops.paged_attention`` (with the K pool passed as V for ``shared_kv``).
Each counts its own kernel's launches in ``.launches``, a plain integer, so
a run can show that it went through the kernel (a split launch's combine
pass counted with it); a wrapper that routes a call to another wrapper
counts nothing itself, but for the two sharded wrappers, which count their
dispatches to a kernel in ``.launches`` of their own, beside the launches
of the kernel wrapper they call. For CPU tensors those two run the plain
``sharded_decode_attention`` / ``sharded_prefill_attention``. The GQA wrappers count their fp8 launches apart as
well, in ``.launches_fp8``; the ragged wrapper its ``shared_kv`` launches in
``.launches_shared_kv`` and those with a burst tail in ``.launches_tail``.
The ragged and latent prefill wrappers also count them by shape class in
``.launches_by_shape`` (arm, flat tokens and rows, for the latent ragged
kernel its decode and prefill splits; chunk length and key splits). The
GQA decode wrapper keeps the key splits its latest launch ran in
``.last_splits``.

A ragged dispatch runs one launch a layer at the same shapes, so its plan
(``plan_ragged_attention``: the key splits of both arms, from shapes only,
and one workspace) is made once and passed to every layer's
``cuda_paged_ragged_attention`` as ``plan=``; the kernels find each
prefill tile's row from ``row_starts`` themselves (``ragged_tile_lookup``
is their plain mirror), so a planned call launches nothing but its kernels.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .cuda_build import load_library
from .paged_attention import (
    check_tp_heads,
    paged_attention,
    paged_decode_attention,
    paged_ragged_attention,
    sharded_decode_attention,
    sharded_prefill_attention,
)

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
FP8 = torch.float8_e4m3fn
# The latent kernels' builds: (shared_kv, head_dim, q_heads) for decode and
# (head_dim, q_heads) for prefill and the ragged kernel. 576 = DeepSeek-V2's
# kv_lora_rank 512 + qk_rope_head_dim 64; 640 adds the TPU layout's 64-wide
# latent_pad. 8 heads over the latent are a tensor-parallel rank's at tp 2.
_LATENT_DECODE = ((True, 576, 16), (True, 640, 16), (True, 576, 8), (True, 640, 8),
                  (False, 128, 8), (False, 128, 16))
_LATENT_PREFILL = ((576, 16), (640, 16), (576, 8), (640, 8))
_LATENT_RAGGED = ((576, 16), (640, 16))
# The latent ragged kernel is built at the latent prefill's shapes; its
# decode arm takes 1-token rows (16 heads fill its m16 tile), longer rows
# take its 4-token prefill tiles.
LATENT_RAGGED_DECODE_TOKENS = 1
# The most decode-burst tail slots the decode kernels fold: one 64-key chunk
# of the GQA decode, two 32-key chunks of the latent decode.
MAX_TAIL_SLOTS = 64


def _window_args(sliding_window, sinks) -> tuple[int, int]:
    if sliding_window is None:
        # Without a window every position is causally attendable anyway:
        # the sink mask is a no-op (as in the JAX wrappers).
        return -1, 0
    if sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")
    return int(sliding_window), int(sinks or 0)


def _check_cuda_operands(q, caches, page_table, lens) -> bool:
    """Device, layout and type checks shared by every kernel: ``caches``
    are ``(name, tensor)`` pairs of one layer's ``[pages, kv_heads,
    page_size, head_dim]`` views of equal shape and one dtype, bf16 or fp8
    e4m3 (the latent wrappers refuse fp8 before this), ``lens`` int32
    vectors. Returns whether the pools are fp8."""
    device = q.device
    for name, t in (*caches, ("page_table", page_table), *lens):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q is on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"the CUDA kernels take a bf16 q, got {q.dtype}")
    for name, t in caches:
        if t.dtype != caches[0][1].dtype or t.dtype not in (torch.bfloat16, FP8):
            raise NotImplementedError(
                f"the CUDA kernels take K/V pools of one dtype, bf16 or fp8 e4m3 "
                f"({name} is {t.dtype})")
    for name, t in (("q", q), *caches):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("page_table", page_table), *lens):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    shapes = [tuple(t.shape) for _, t in caches]
    if caches[0][1].dim() != 4 or len(set(shapes)) != 1:
        raise ValueError(
            "k_cache/v_cache must be one layer's [pages, kv_heads, page_size, "
            f"head_dim] view, got {' / '.join(map(str, shapes))}")
    head_dim = caches[0][1].shape[3]
    if q.shape[-1] != head_dim:
        raise ValueError(f"q head_dim {q.shape[-1]} != cache head_dim {head_dim}")
    return caches[0][1].dtype == FP8


def _tail_set(tail_k, tail_v, tail_lens, shared_kv):
    """The decode-burst tail arguments, which travel as a set (the JAX
    wrapper's check): ``(tail_k, tail_v, tail_lens)``, with the latent tail
    as ``tail_v`` under ``shared_kv``, or three ``None``."""
    if tail_k is None:
        if tail_v is not None or tail_lens is not None:
            raise ValueError("tail_v/tail_lens given without tail_k")
        return None, None, None
    if tail_lens is None:
        raise ValueError(
            "tail_k requires tail_lens [batch] int32 (valid tail tokens per sequence)")
    if shared_kv:
        return tail_k, tail_k, tail_lens
    if tail_v is None:
        raise ValueError(
            "tail_k requires tail_v [batch, T, kv_heads, head_dim] unless "
            "shared_kv=True (single-stream MLA)")
    return tail_k, tail_v, tail_lens


def _check_tail_slots(tail_k):
    """The kernels fold a tail of up to 64 slots; the plain version any."""
    if tail_k is not None and not 1 <= tail_k.shape[1] <= MAX_TAIL_SLOTS:
        raise NotImplementedError(
            f"the decode kernels fold a tail of 1..{MAX_TAIL_SLOTS} slots, got "
            f"{tail_k.shape[1]}")


def _tail_pointers(q, tail_k, tail_v, tail_lens, kv_heads, head_dim, dtype=torch.bfloat16,
                   batch=None):
    """Checks a burst tail bound for a CUDA kernel (in the pools' ``dtype``;
    one tail a row of ``batch``, by default q's first axis) and returns its
    ``(tail_k, tail_v, tail_lens)`` pointers and slot count (``None`` x 3
    and 0 without a tail)."""
    if tail_k is None:
        return None, None, None, 0
    batch = q.shape[0] if batch is None else batch
    slots = tail_k.shape[1] if tail_k.dim() == 4 else 0
    for name, t in (("tail_k", tail_k), ("tail_v", tail_v)):
        if tuple(t.shape) != (batch, slots, kv_heads, head_dim):
            raise ValueError(f"{name} must be [batch, T, kv_heads, head_dim] = "
                             f"[{batch}, T, {kv_heads}, {head_dim}], got {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous() or t.dtype != dtype:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {q.device}, "
                             "the pools' dtype")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if (tail_lens.device != q.device or tail_lens.dtype != torch.int32
            or tuple(tail_lens.shape) != (batch,) or not tail_lens.is_contiguous()):
        raise ValueError(f"tail_lens must be a contiguous int32 [{batch}] tensor on {q.device}")
    return tail_k.data_ptr(), tail_v.data_ptr(), tail_lens.data_ptr(), slots


def _count_shape(wrapper, key: str) -> None:
    """Counts a launch of ``wrapper`` by its shape class (``key``, read from
    shapes only) in ``wrapper.launches_by_shape``, beside ``.launches``."""
    wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def _count(wrapper, fp8: bool) -> None:
    """One launch of ``wrapper``'s kernel, an fp8 one counted apart too."""
    wrapper.launches += 1
    wrapper.launches_fp8 += int(fp8)


def _check_gqa_operands(q, k_cache, v_cache, page_table, lens, q_heads) -> bool:
    """The GQA kernels' checks; returns whether the pools are fp8."""
    fp8 = _check_cuda_operands(q, (("k_cache", k_cache), ("v_cache", v_cache)),
                               page_table, lens)
    _, kv_heads, _, head_dim = k_cache.shape
    if head_dim not in _HEAD_DIMS:
        raise NotImplementedError(f"head_dim {head_dim} not in {_HEAD_DIMS}")
    if q_heads % kv_heads or q_heads // kv_heads not in _GROUPS:
        raise NotImplementedError(
            f"q_heads/kv_heads = {q_heads}/{kv_heads}: GQA group must be one of {_GROUPS}")
    return fp8


def cuda_paged_decode_attention(
    q: torch.Tensor,  # [batch, q_heads, head_dim]
    k_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim] (one layer)
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    ctx_lens: torch.Tensor,  # [batch] int32 paged keys to attend
    *,
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
    tail_k: torch.Tensor | None = None,  # [batch, T, kv_heads, head_dim]
    tail_v: torch.Tensor | None = None,
    tail_lens: torch.Tensor | None = None,  # [batch] int32 valid tail tokens
) -> torch.Tensor:
    """Flash-decode over paged KV. Returns ``[batch, q_heads, head_dim]``.

    The query sits at ``ctx_len - 1``. With a decode-burst tail it sits at
    ``ctx_len + tail_len - 1``: the paged keys stop at ``ctx_len`` and the
    tail's slot ``j`` is the key at ``ctx_len + j``, attendable while ``j <
    tail_len`` (the JAX ``_tail_fold``). The tail arguments travel as a set;
    under ``shared_kv`` the latent tail is also V and ``tail_v`` is unread.
    The kernels fold up to ``MAX_TAIL_SLOTS`` slots.

    Each (row, kv head)'s keys are split across ``decode_splits`` CTAs,
    planned from shapes only (a captured burst replays the same plan at any
    lengths), the row's last split folding the tail; a combine pass merges
    the splits (counted with the launch). A row with ``ctx_len == 0`` and
    no tail (a padded decode row) returns zeros from the kernel; the plain
    version averages the garbage page there instead, and callers ignore
    such rows either way. fp8 pools take a tail of fp8 too. A single KV head
    (MQA) and ``shared_kv`` (absorbed MLA: ``k_cache`` is the latent pool
    and also V) go to ``cuda_paged_latent_decode_attention``, as the JAX
    wrapper takes its per-head kernel for ``kv_heads == 1``.
    """
    tail_k, tail_v, tail_lens = _tail_set(tail_k, tail_v, tail_lens, shared_kv)
    if shared_kv or k_cache.shape[1] == 1:
        return cuda_paged_latent_decode_attention(
            q, k_cache, v_cache, page_table, ctx_lens, sliding_window=sliding_window,
            sinks=sinks, shared_kv=shared_kv, tail_k=tail_k, tail_v=tail_v,
            tail_lens=tail_lens)
    if q.device.type == "cpu":
        return paged_decode_attention(q, k_cache, v_cache, page_table, ctx_lens, sliding_window,
                             sinks, tail_k, tail_v, tail_lens)
    _check_tail_slots(tail_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    window, n_sinks = _window_args(sliding_window, sinks)
    batch, q_heads, head_dim = q.shape
    fp8 = _check_gqa_operands(q, k_cache, v_cache, page_table,
                              (("ctx_lens", ctx_lens),), q_heads)
    if page_table.shape[0] != batch or ctx_lens.shape != (batch,):
        raise ValueError("page_table/ctx_lens batch does not match q")
    _, kv_heads, page_size, _ = k_cache.shape
    tail_k_p, tail_v_p, tail_lens_p, slots = _tail_pointers(
        q, tail_k, tail_v, tail_lens, kv_heads, head_dim, k_cache.dtype)
    lib = load_library()
    splits = decode_splits(q, k_cache, page_table, lib.llmd_decode_chunk_keys(),
                           _sm_count(q.device.index or 0))
    # Freed on return: the caching allocator hands the memory only to later
    # work on this stream, which runs after these kernels.
    workspace = torch.empty(lib.llmd_decode_workspace_bytes(batch, kv_heads, head_dim, splits),
                            dtype=torch.uint8, device=q.device)
    out = torch.empty_like(q)
    launch = lib.llmd_paged_decode_fp8 if fp8 else lib.llmd_paged_decode_bf16
    rc = launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), ctx_lens.data_ptr(), tail_k_p, tail_v_p, tail_lens_p,
        out.data_ptr(), batch, q_heads, kv_heads, head_dim, page_size,
        page_table.shape[1], slots, window, n_sinks, head_dim ** -0.5, splits,
        workspace.data_ptr() if splits > 1 else None,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel failed to launch (code {rc})")
    _count(cuda_paged_decode_attention, fp8)
    cuda_paged_decode_attention.last_splits = splits
    return out


cuda_paged_decode_attention.launches = 0
cuda_paged_decode_attention.launches_fp8 = 0
cuda_paged_decode_attention.last_splits = 0  # key splits of the latest launch


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
    tile multiple. ``shared_kv`` (absorbed MLA: ``k_cache`` is the latent
    pool and also V) goes to ``cuda_paged_latent_prefill_attention``. fp8
    pools run the kernel's fp8 arm, which computes what the JAX engine
    computes with XLA for them: the pages upcast to q's dtype, attended.
    """
    if shared_kv:
        return cuda_paged_latent_prefill_attention(
            q, k_cache, page_table, ctx_lens, total_lens,
            sliding_window=sliding_window, sinks=sinks)
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
    fp8 = _check_gqa_operands(q, k_cache, v_cache, page_table,
                              (("ctx_lens", ctx_lens), ("total_lens", total_lens)),
                              q_heads)
    if (page_table.shape[0] != batch or ctx_lens.shape != (batch,)
            or total_lens.shape != (batch,)):
        raise ValueError("page_table/ctx_lens/total_lens batch does not match q")
    _, kv_heads, page_size, _ = k_cache.shape
    out = torch.empty_like(q)
    lib = load_library()
    rc = (lib.llmd_paged_prefill_fp8 if fp8 else lib.llmd_paged_prefill_bf16)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), ctx_lens.data_ptr(), total_lens.data_ptr(),
        out.data_ptr(), batch, q_seq, q_heads, kv_heads, head_dim, page_size,
        page_table.shape[1], window, n_sinks, head_dim ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged prefill kernel failed to launch (code {rc})")
    _count(cuda_paged_prefill_attention, fp8)
    return out


cuda_paged_prefill_attention.launches = 0
cuda_paged_prefill_attention.launches_fp8 = 0


def cuda_paged_ragged_attention(
    q: torch.Tensor,  # [total_q, q_heads, head_dim] flat mixed batch
    k_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim] (one layer)
    v_cache: torch.Tensor | None,  # as k_cache; unread with shared_kv
    page_table: torch.Tensor,  # [rows, pages_per_seq] int32
    row_starts: torch.Tensor,  # [rows + 1] int32 flat-token prefix sums
    ctx_lens: torch.Tensor,  # [rows] int32 cached tokens before each row's new ones
    *,
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
    tail_k: torch.Tensor | None = None,  # [rows, T, kv_heads, head_dim]
    tail_v: torch.Tensor | None = None,  # as tail_k; unread with shared_kv
    tail_lens: torch.Tensor | None = None,  # [rows] int32 valid tail tokens
    plan: RaggedPlan | None = None,
) -> torch.Tensor:
    """Flash attention over a ragged mixed prefill+decode batch, in one
    launch (new tokens' KV already scattered).

    Row r's tokens sit at flat slots ``[row_starts[r], row_starts[r+1])``
    at positions ``ctx_lens[r] + i`` and attend causally over row r's
    paged KV; a decode row is a 1-token row. ``row_starts`` is
    non-decreasing with ``row_starts[-1] <= total_q``; ``total_q`` needs no
    padding to any tile, and slots at and past ``row_starts[-1]`` are
    zeros. Returns ``[total_q, q_heads, head_dim]``. Rows of at most
    ``llmd_ragged_decode_tokens`` tokens (16 / group: the engine's 1-token
    decode rows) take the kernel's split-KV decode arm, longer rows its
    prefill tiles; a combine pass after a split launch is counted with it.
    fp8 pools run the fp8 arm of both.

    ``shared_kv`` is absorbed MLA: ``k_cache`` is the latent pool and also
    V. It runs the latent ragged kernel (1-token rows on the latent decode
    tile, longer rows on the latent prefill's wgmma tiles), built for
    head_dim 576 or 640 with 16 query heads; fp8 pools raise ``ValueError``
    (as JAX), other shapes ``NotImplementedError``. The decode-burst tail
    (the arguments travel as a set; under ``shared_kv`` the latent tail is
    also V) follows the JAX kernel's contract: a row with ``tail_lens[r] >
    0`` keeps its new KV in the tail, its paged keys stop at ``ctx_lens[r]``
    and its query sits at ``ctx_lens[r] + tail_lens[r] - 1``. Only 1-token
    rows may carry a tail: the kernels ignore a longer row's, the plain
    version sits all its queries at the tail's end, as the JAX kernel does.
    The kernels fold up to ``MAX_TAIL_SLOTS`` slots; the engine has no
    ragged burst path, so only direct calls pass a tail.

    ``plan`` is ``plan_ragged_attention``'s for these shapes (a dispatch's
    layers share one: ``forward_ragged``); without one the call plans for
    itself, the same way. A plan made for other shapes raises
    ``ValueError``. CPU calls ignore it.
    """
    tail_k, tail_v, tail_lens = _tail_set(tail_k, tail_v, tail_lens, shared_kv)
    if shared_kv:
        if k_cache.dtype == FP8:
            raise ValueError(
                "quantized (fp8) caches are not supported for shared-kv (MLA latent) pools")
        v_cache = k_cache
    if q.device.type == "cpu":
        return paged_ragged_attention(
            q, k_cache, v_cache, page_table, row_starts, ctx_lens,
            sliding_window=sliding_window, sinks=sinks, tail_k=tail_k, tail_v=tail_v,
            tail_lens=tail_lens)
    total_q, q_heads, head_dim = q.shape
    if shared_kv:
        _check_latent_ragged_shape(q_heads, k_cache)
    _check_tail_slots(tail_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    window, n_sinks = _window_args(sliding_window, sinks)
    lens = (("row_starts", row_starts), ("ctx_lens", ctx_lens))
    if shared_kv:
        fp8 = _check_cuda_operands(q, (("k_cache", k_cache),), page_table, lens)
    else:
        fp8 = _check_gqa_operands(q, k_cache, v_cache, page_table, lens, q_heads)
    rows = page_table.shape[0]
    if rows == 0 or row_starts.shape != (rows + 1,) or ctx_lens.shape != (rows,):
        raise ValueError("row_starts must be [rows + 1] and ctx_lens [rows] "
                         "for a page_table of rows > 0")
    _, kv_heads, page_size, _ = k_cache.shape
    tail_k_p, tail_v_p, tail_lens_p, slots = _tail_pointers(
        q, tail_k, tail_v, tail_lens, kv_heads, head_dim, k_cache.dtype, batch=rows)
    if plan is None:
        # Freed on return: the caching allocator hands the workspace only to
        # later work on this stream, which runs after these kernels.
        plan = plan_ragged_attention(total_q, q_heads, k_cache, page_table, shared_kv=shared_kv)
    elif plan.key != _ragged_plan_key(total_q, q_heads, k_cache, page_table, shared_kv):
        raise ValueError(f"the ragged plan was made for {plan.key}, not for this call's "
                         f"{_ragged_plan_key(total_q, q_heads, k_cache, page_table, shared_kv)}")
    lib = load_library()
    ws = plan.workspace.data_ptr() if plan.workspace is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    if shared_kv:
        rc = lib.llmd_latent_ragged_bf16(
            q.data_ptr(), k_cache.data_ptr(), page_table.data_ptr(), row_starts.data_ptr(),
            ctx_lens.data_ptr(), tail_k_p, tail_lens_p, out.data_ptr(), total_q, rows,
            q_heads, head_dim, page_size, page_table.shape[1], slots, window, n_sinks,
            head_dim ** -0.5, plan.splits, plan.prefill_splits, ws, stream)
    else:
        rc = (lib.llmd_paged_ragged_fp8 if fp8 else lib.llmd_paged_ragged_bf16)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            page_table.data_ptr(), row_starts.data_ptr(), ctx_lens.data_ptr(),
            tail_k_p, tail_v_p, tail_lens_p, out.data_ptr(), total_q, rows, q_heads,
            kv_heads, head_dim, page_size, page_table.shape[1], slots, window, n_sinks,
            head_dim ** -0.5, plan.splits, ws, stream)
    if rc != 0:
        raise RuntimeError(f"{'latent ' if shared_kv else ''}ragged kernel failed to launch "
                           f"(code {rc})")
    _count(cuda_paged_ragged_attention, fp8)
    cuda_paged_ragged_attention.launches_shared_kv += int(shared_kv)
    cuda_paged_ragged_attention.launches_tail += int(tail_k is not None)
    _count_shape(cuda_paged_ragged_attention,
                 f"latent q{total_q}/rows{rows}/splits{plan.splits}x{plan.prefill_splits}"
                 if shared_kv else f"q{total_q}/rows{rows}")
    return out


cuda_paged_ragged_attention.launches = 0
cuda_paged_ragged_attention.launches_fp8 = 0
cuda_paged_ragged_attention.launches_shared_kv = 0
cuda_paged_ragged_attention.launches_tail = 0
cuda_paged_ragged_attention.launches_by_shape = {}


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# Work planning. Every count comes from shapes (batch, rows, heads, the page
# table's capacity, the SM count), never from lengths on the device, so
# planning a launch costs no host sync (the engine runs one a layer).

def plan_splits(units: int, max_chunks: int, slots: int) -> int:
    """CTAs each of ``units`` independent key streams is split across:
    enough that units x splits fills ``slots`` CTA slots once, never more
    than the ``max_chunks`` key chunks a stream can hold, at least 1."""
    return max(1, min(slots // max(units, 1), max_chunks))


def _max_chunks(pages_per_seq: int, page_size: int, chunk_keys: int) -> int:
    return -(-pages_per_seq * page_size // chunk_keys)


def latent_decode_splits(batch: int, pages_per_seq: int, page_size: int, chunk_keys: int,
                         cta_slots: int) -> int:
    """CTAs each row's keys are split across in the latent decode: enough
    that batch x splits fills the card's ``cta_slots`` (its SMs times the
    kernel's CTAs an SM, ``llmd_latent_decode_ctas_per_sm``) once, never
    more than the ``chunk_keys``-key chunks the page table can hold. Shapes
    only, so a captured CUDA graph keeps its plan."""
    return plan_splits(batch, _max_chunks(pages_per_seq, page_size, chunk_keys), cta_slots)


def latent_prefill_splits(batch: int, q_seq: int, pages_per_seq: int, page_size: int,
                          chunk_keys: int, tile_tokens: int, sm_count: int) -> int:
    """CTAs each query tile's keys are split across in the latent prefill:
    1 once the tiles (``tile_tokens`` tokens each) fill the SMs (one CTA an
    SM), else enough to fill them, as a 64-token warm chunk needs."""
    tiles = batch * -(-q_seq // tile_tokens)
    return plan_splits(tiles, _max_chunks(pages_per_seq, page_size, chunk_keys), sm_count)


# Decode CTAs the GQA decode kernel's split plan aims at for each SM: one
# wave, two CTAs an SM at a time (a CTA's three staged chunks take ~105 KB
# of shared memory at head_dim 128, ~85 KB over an fp8 pool: still two an
# SM, which the kernel source asserts).
DECODE_CTAS_PER_SM = 2


def decode_splits(q: torch.Tensor, k_cache: torch.Tensor, page_table: torch.Tensor,
                  chunk_keys: int, sm_count: int) -> int:
    """CTAs each (row, kv head) of the GQA decode kernel is split across:
    enough that batch x kv_heads x splits fills ``DECODE_CTAS_PER_SM`` CTA
    slots of every SM once. Reads the tensors' shapes only (batch, kv
    heads, page size, the page table's capacity), never a value, so it
    costs no host sync and a captured CUDA graph keeps its plan."""
    _, kv_heads, page_size, _ = k_cache.shape
    return plan_splits(q.shape[0] * kv_heads,
                       _max_chunks(page_table.shape[1], page_size, chunk_keys),
                       sm_count * DECODE_CTAS_PER_SM)


# Decode-arm CTAs of the ragged kernel the split plan aims at for each SM
# over a launch: two waves, since the kernel's shared memory (~131 KB at
# head_dim 128) holds one CTA an SM at a time.
RAGGED_CTAS_PER_SM = 2


def ragged_decode_splits(rows: int, kv_heads: int, pages_per_seq: int, page_size: int,
                         chunk_keys: int, sm_count: int) -> int:
    """CTAs each (row, kv head) of the ragged kernel's decode arm is split
    across. Every row is counted, since which rows decode is on the device:
    a CTA of a prefill row exits at once."""
    return plan_splits(rows * kv_heads, _max_chunks(pages_per_seq, page_size, chunk_keys),
                       sm_count * RAGGED_CTAS_PER_SM)


def latent_ragged_splits(rows: int, total_q: int, pages_per_seq: int, page_size: int,
                         decode_chunk_keys: int, prefill_chunk_keys: int, tile_tokens: int,
                         cta_slots: int) -> tuple[int, int]:
    """``(splits, prefill_splits)`` of the latent ragged kernel: the CTAs
    each decode row's keys and each prefill tile's keys are split across.
    Both arms are one-CTA-an-SM CTAs of one grid, so they are planned
    together, to share one wave of the ``cta_slots`` where they fit in one
    (two arms each planned to fill the card alone make two waves).

    Shapes only, so which rows decode is not known: the plan reads the
    shapes as the engine sends them, 1-token decode rows and at most one
    longer row, the prefill chunk, which holds the flat tokens past one a
    row. Decode rows only: their split fills the card. A chunk whose tiles
    fill the card alone runs unsplit, and the decode rows planned as if
    alone follow in its last wave. Otherwise each of the decode rows and
    the chunk's tiles gets the same share of the slots, the tiles' split
    from it, and the decode rows take the slots the tiles leave. Each split
    is at least 1 and never more than the key chunks the page table can
    hold, at each arm's chunk size."""
    chunk = total_q - rows + 1  # the prefill row's tokens, if there is one
    dec_chunks = _max_chunks(pages_per_seq, page_size, decode_chunk_keys)
    if chunk <= LATENT_RAGGED_DECODE_TOKENS:  # decode rows only
        return plan_splits(rows, dec_chunks, cta_slots), 1
    decode_rows, tiles = rows - 1, -(-chunk // tile_tokens)
    if tiles >= cta_slots:
        return (plan_splits(rows, dec_chunks, cta_slots) if decode_rows else 1), 1
    prefill_splits = plan_splits(decode_rows + tiles,
                                 _max_chunks(pages_per_seq, page_size, prefill_chunk_keys),
                                 cta_slots)
    splits = (plan_splits(decode_rows, dec_chunks, cta_slots - tiles * prefill_splits)
              if decode_rows else 1)
    return splits, prefill_splits


def ragged_tile_slots(total_q: int, rows: int, tile_tokens: int, decode_tokens: int) -> int:
    """The plain mirror of the kernels' ``ragged_tile_slots`` (the library's
    ``llmd_ragged_tile_slots``), which the CPU tests replay a launch's grid
    with: the tile slots of a ragged kernel's prefill arm, a bound on the
    prefill tiles from shapes only. A row of ``len > decode_tokens`` tokens
    owns ``ceil(len / tile_tokens)`` tiles and at most ``min(rows, total_q
    // (decode_tokens + 1))`` rows are that long; at least 1."""
    long_rows = min(rows, total_q // (decode_tokens + 1))
    return max(1, (total_q + long_rows * (tile_tokens - 1)) // tile_tokens)


def ragged_tile_lookup(row_starts, total_q: int, tile_tokens: int, decode_tokens: int,
                       slot: int):
    """The plain mirror of the kernels' ``ragged_tile``: the prefill tile
    that tile slot ``slot`` of a ragged launch serves, found from
    ``row_starts`` (a host sequence of rows + 1 ints) alone. Each row is
    clamped to the flat axis ``[0, total_q]``; a row of more than
    ``decode_tokens`` tokens owns ``ceil(len / tile_tokens)`` tiles,
    numbered on from the rows before it; slot s takes tile ``total - 1 -
    s``, the last first. Returns ``(row, start, len, t0)`` (the row, its
    first flat slot and tokens, the tile's first token in the row) or
    ``None`` for a slot past the last tile."""
    found = []
    for r in range(len(row_starts) - 1):
        start = min(max(int(row_starts[r]), 0), total_q)
        n = min(max(int(row_starts[r + 1]), start), total_q) - start
        tiles = -(-n // tile_tokens) if n > decode_tokens else 0
        found.extend((r, start, n, i * tile_tokens) for i in range(tiles))
    t = len(found) - 1 - slot
    return found[t] if t >= 0 else None


def _check_latent_ragged_shape(q_heads: int, k_cache: torch.Tensor) -> None:
    head_dim = k_cache.shape[3]
    if k_cache.shape[1] != 1 or (head_dim, q_heads) not in _LATENT_RAGGED:
        raise NotImplementedError(
            f"the latent ragged kernel is built for one KV head and (head_dim, q_heads) in "
            f"{_LATENT_RAGGED}; got kv_heads {k_cache.shape[1]}, ({head_dim}, {q_heads})")


def _ragged_plan_key(total_q, q_heads, k_cache, page_table, shared_kv) -> tuple:
    """The shapes a ragged plan holds for: (rows, total_q, q_heads, kv_heads,
    page_size, head_dim, pages_per_seq, shared_kv, device)."""
    return (page_table.shape[0], total_q, q_heads, *k_cache.shape[1:], page_table.shape[1],
            bool(shared_kv), k_cache.device)


@dataclasses.dataclass(frozen=True, eq=False)
class RaggedPlan:
    """One ragged dispatch's launch plan, from shapes only (no device value
    is read, so planning costs no host sync): the key splits of the decode
    arm (``splits``) and of the prefill arm (``prefill_splits``, 1 for the
    GQA kernel, whose prefill tiles are not split) and one workspace for
    the split states (``None`` when no arm splits). The layers of a dispatch
    launch in order on one stream, so they share the workspace. ``key`` is
    the shapes it was made for."""

    key: tuple
    splits: int
    prefill_splits: int
    workspace: torch.Tensor | None


def plan_ragged_attention(total_q: int, q_heads: int, k_cache: torch.Tensor,
                          page_table: torch.Tensor, *, shared_kv: bool = False) -> RaggedPlan:
    """The plan of a ragged launch over ``total_q`` flat tokens of
    ``q_heads`` heads, one layer's pool view ``k_cache`` ``[pages,
    kv_heads, page_size, head_dim]`` and ``page_table`` ``[rows,
    pages_per_seq]`` on the card: ``latent_ragged_splits`` for
    ``shared_kv`` (the latent ragged kernel), ``ragged_decode_splits`` for
    the GQA kernel, and the workspace they need, allocated on the current
    stream. Shapes the kernels are not built for raise
    ``NotImplementedError``."""
    rows, pages_per_seq = page_table.shape
    _, kv_heads, page_size, head_dim = k_cache.shape
    if shared_kv:
        _check_latent_ragged_shape(q_heads, k_cache)
    elif head_dim not in _HEAD_DIMS or q_heads % kv_heads or q_heads // kv_heads not in _GROUPS:
        raise NotImplementedError(
            f"the ragged kernel takes head_dim in {_HEAD_DIMS} and a GQA group in {_GROUPS}; "
            f"got head_dim {head_dim}, q_heads/kv_heads {q_heads}/{kv_heads}")
    lib = load_library()
    sms = _sm_count(k_cache.device.index or 0)
    if shared_kv:
        splits, prefill_splits = latent_ragged_splits(
            rows, total_q, pages_per_seq, page_size, lib.llmd_latent_decode_chunk_keys(),
            lib.llmd_latent_prefill_chunk_keys(head_dim),
            lib.llmd_latent_prefill_tile_tokens(q_heads),
            sms * lib.llmd_latent_decode_ctas_per_sm())
        nbytes = lib.llmd_latent_ragged_workspace_bytes(total_q, rows, head_dim, splits,
                                                        prefill_splits)
    else:
        splits, prefill_splits = ragged_decode_splits(
            rows, kv_heads, pages_per_seq, page_size, lib.llmd_decode_chunk_keys(), sms), 1
        nbytes = lib.llmd_decode_workspace_bytes(rows, kv_heads, head_dim, splits)
    return RaggedPlan(
        key=_ragged_plan_key(total_q, q_heads, k_cache, page_table, shared_kv),
        splits=splits, prefill_splits=prefill_splits,
        workspace=(torch.empty(nbytes, dtype=torch.uint8, device=k_cache.device)
                   if nbytes else None))


def _refuse_fp8_single_head(k_cache) -> None:
    """The single-KV-head kernels have no fp8 arm, as the TPU's per-head
    decode has none (the JAX wrapper refuses fp8 for ``shared_kv`` and for
    the per-head grid)."""
    if k_cache.dtype == FP8:
        raise ValueError(
            "quantized (fp8) caches are not supported for single-KV-head "
            "(MLA latent or MQA) pools")


def cuda_paged_latent_decode_attention(
    q: torch.Tensor,  # [batch, q_heads, head_dim]
    k_cache: torch.Tensor,  # [num_pages, 1, page_size, head_dim] (one layer)
    v_cache: torch.Tensor | None,  # as k_cache; unread with shared_kv
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    ctx_lens: torch.Tensor,  # [batch] int32 paged keys to attend
    *,
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
    tail_k: torch.Tensor | None = None,  # [batch, T, 1, head_dim]
    tail_v: torch.Tensor | None = None,  # as tail_k; unread with shared_kv
    tail_lens: torch.Tensor | None = None,  # [batch] int32 valid tail tokens
) -> torch.Tensor:
    """Flash-decode of every query head over one shared KV head. Returns
    ``[batch, q_heads, head_dim]``.

    ``shared_kv`` is absorbed MLA: ``k_cache`` holds each token's latent,
    which is both key and value, and the output covers the full width
    (the model keeps ``[..., :kv_lora_rank]``). Without it, ``v_cache`` is
    the V pool (MQA). The decode-burst tail is that of
    ``cuda_paged_decode_attention``; its last split of each row folds it.
    The kernel is built for ``shared_kv`` at head_dim 576
    or 640 with 16 query heads or 8 (a tp 2 rank's) and for MQA at head_dim
    128 with 8 or 16; other shapes, and fp8 pools, raise. Each row's keys are split across
    ``latent_decode_splits`` CTAs, whose states a combine pass merges (two
    kernel launches, counted as one launch of the latent decode). A row
    with ``ctx_len == 0`` and no tail returns zeros from the kernel (the
    plain version averages the garbage page). For CPU tensors the plain
    version runs at any shape; elsewhere an unbuilt shape raises before the
    device is looked at.
    """
    tail_k, tail_v, tail_lens = _tail_set(tail_k, tail_v, tail_lens, shared_kv)
    if shared_kv:
        v_cache = k_cache
    if q.device.type == "cpu":
        return paged_decode_attention(q, k_cache, v_cache, page_table, ctx_lens, sliding_window,
                             sinks, tail_k, tail_v, tail_lens)
    batch, q_heads, head_dim = q.shape
    _refuse_fp8_single_head(k_cache)
    if k_cache.shape[1] != 1 or (bool(shared_kv), head_dim, q_heads) not in _LATENT_DECODE:
        raise NotImplementedError(
            f"the latent decode kernel is built for one KV head and (shared_kv, "
            f"head_dim, q_heads) in {_LATENT_DECODE}; got kv_heads {k_cache.shape[1]}, "
            f"({bool(shared_kv)}, {head_dim}, {q_heads})")
    _check_tail_slots(tail_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    window, n_sinks = _window_args(sliding_window, sinks)
    caches = (("k_cache", k_cache),) if shared_kv else (
        ("k_cache", k_cache), ("v_cache", v_cache))
    _check_cuda_operands(q, caches, page_table, (("ctx_lens", ctx_lens),))
    if page_table.shape[0] != batch or ctx_lens.shape != (batch,):
        raise ValueError("page_table/ctx_lens batch does not match q")
    page_size = k_cache.shape[2]
    tail_k_p, tail_v_p, tail_lens_p, slots = _tail_pointers(
        q, tail_k, tail_v, tail_lens, 1, head_dim)
    lib = load_library()
    splits = latent_decode_splits(
        batch, page_table.shape[1], page_size, lib.llmd_latent_decode_chunk_keys(),
        _sm_count(q.device.index or 0) * lib.llmd_latent_decode_ctas_per_sm())
    # Freed on return: the caching allocator hands the memory only to later
    # work on this stream, which runs after these kernels.
    workspace = torch.empty(lib.llmd_latent_decode_workspace_bytes(batch, head_dim, splits),
                            dtype=torch.uint8, device=q.device)
    out = torch.empty_like(q)
    rc = lib.llmd_latent_decode_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), page_table.data_ptr(),
        ctx_lens.data_ptr(), tail_k_p, tail_v_p, tail_lens_p, out.data_ptr(), batch,
        q_heads, head_dim, int(shared_kv), page_size, page_table.shape[1], slots, window,
        n_sinks, head_dim ** -0.5, splits, workspace.data_ptr() if splits > 1 else None,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"latent decode kernel failed to launch (code {rc})")
    cuda_paged_latent_decode_attention.launches += 1
    return out


cuda_paged_latent_decode_attention.launches = 0


def cuda_paged_latent_prefill_attention(
    q: torch.Tensor,  # [batch, q_seq, q_heads, head_dim] (new tokens, padded)
    k_cache: torch.Tensor,  # [num_pages, 1, page_size, head_dim] latent pool (one layer)
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    ctx_lens: torch.Tensor,  # [batch] int32 cached tokens before the new ones
    total_lens: torch.Tensor,  # [batch] int32 ctx + valid new tokens
    *,
    sliding_window: int | None = None,
    sinks: int | None = None,
) -> torch.Tensor:
    """Flash prefill of every query head over the shared latent (absorbed
    MLA; the new tokens' latents already scattered): the latent pool is K
    and V. Query ``i`` of row ``b`` sits at ``ctx_lens[b] + i``. Returns
    ``[batch, q_seq, q_heads, head_dim]``, the full width. The kernel is
    built for head_dim 576 or 640 with 16 query heads (a 64-row tile of 4
    tokens) or 8 (a tp 2 rank's: tiles of 8 tokens); other shapes, and fp8
    pools, raise.
    When its query tiles cannot fill the card (a short chunk), each tile's
    keys are split across ``latent_prefill_splits`` CTAs and a combine pass
    merges them (counted as one launch).
    """
    batch, q_seq, q_heads, head_dim = q.shape
    if q.device.type == "cpu":
        positions = ctx_lens[:, None] + torch.arange(q_seq, device=q.device)[None]
        return paged_attention(
            q, k_cache, k_cache, page_table, positions, total_lens,
            sliding_window=sliding_window,
            attention_sinks=sinks if sliding_window is not None else None,
        )
    _refuse_fp8_single_head(k_cache)
    if k_cache.shape[1] != 1 or (head_dim, q_heads) not in _LATENT_PREFILL:
        raise NotImplementedError(
            f"the latent prefill kernel is built for one KV head and (head_dim, "
            f"q_heads) in {_LATENT_PREFILL}; got kv_heads {k_cache.shape[1]}, "
            f"({head_dim}, {q_heads})")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    window, n_sinks = _window_args(sliding_window, sinks)
    _check_cuda_operands(q, (("k_cache", k_cache),), page_table,
                         (("ctx_lens", ctx_lens), ("total_lens", total_lens)))
    if (page_table.shape[0] != batch or ctx_lens.shape != (batch,)
            or total_lens.shape != (batch,)):
        raise ValueError("page_table/ctx_lens/total_lens batch does not match q")
    lib = load_library()
    splits = latent_prefill_splits(
        batch, q_seq, page_table.shape[1], k_cache.shape[2],
        lib.llmd_latent_prefill_chunk_keys(head_dim),
        lib.llmd_latent_prefill_tile_tokens(q_heads), _sm_count(q.device.index or 0))
    workspace = torch.empty(
        lib.llmd_latent_prefill_workspace_bytes(batch, q_seq, q_heads, head_dim, splits),
        dtype=torch.uint8, device=q.device)
    out = torch.empty_like(q)
    rc = lib.llmd_latent_prefill_bf16(
        q.data_ptr(), k_cache.data_ptr(), page_table.data_ptr(), ctx_lens.data_ptr(),
        total_lens.data_ptr(), out.data_ptr(), batch, q_seq, q_heads, head_dim,
        k_cache.shape[2], page_table.shape[1], window, n_sinks, head_dim ** -0.5, splits,
        workspace.data_ptr() if splits > 1 else None,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"latent prefill kernel failed to launch (code {rc})")
    cuda_paged_latent_prefill_attention.launches += 1
    _count_shape(cuda_paged_latent_prefill_attention, f"s{q_seq}/splits{splits}")
    return out


cuda_paged_latent_prefill_attention.launches = 0
cuda_paged_latent_prefill_attention.launches_by_shape = {}


def sharded_paged_decode_attention(
    group,  # the rank's tp group (``parallel.mesh.TPGroup``): its ``size`` is read
    q: torch.Tensor,  # [batch, q_heads / tp, head_dim]: the rank's query heads
    k_cache: torch.Tensor,  # [num_pages, kv_heads / tp (or 1: whole), page_size, head_dim]
    v_cache: torch.Tensor | None,
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32, the same on every rank
    ctx_lens: torch.Tensor,  # [batch] int32
    *,
    q_heads: int,  # the model's query heads
    kv_heads: int,  # the model's pool heads (1 for an MLA latent pool)
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
    tail_k: torch.Tensor | None = None,  # [batch, T, local kv heads, head_dim]
    tail_v: torch.Tensor | None = None,
    tail_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash-decode of a tensor-parallel rank's heads: the counterpart of
    the JAX ``sharded_paged_decode_attention``
    (``llmd_kv_cache_tpu/ops/pallas_paged_attention.py:1593``), which runs
    the decode kernel on each tp shard's local kv heads under ``shard_map``.

    Here each rank is a process and passes its local operands: its ``q_heads
    / tp`` query heads and its ``kv_heads / tp`` kv heads, or, for a pool of
    one head (absorbed MLA's replicated latent), the whole pool, whose local
    query heads then run as one multi-query group (at tp 2 the latent
    kernels' 8-head instantiations). The local head counts are checked
    against ``group.size`` (``check_tp_heads``, ``ValueError``), then the
    call goes to ``cuda_paged_decode_attention`` with the JAX keyword
    surface (window, sinks, ``shared_kv``, the burst tail). Returns the
    rank's ``[batch, q_heads / tp, head_dim]``; no collective runs (the
    per-layer all-reduce comes after ``wo``). CUDA tensors launch the kernel
    or raise, and count one dispatch in ``.launches``; CPU tensors run the
    plain ``sharded_decode_attention``.
    """
    if q.device.type == "cpu":
        return sharded_decode_attention(
            group.size, q, k_cache, v_cache, page_table, ctx_lens, q_heads=q_heads,
            kv_heads=kv_heads, sliding_window=sliding_window, sinks=sinks, shared_kv=shared_kv,
            tail_k=tail_k, tail_v=tail_v, tail_lens=tail_lens)
    check_tp_heads(group.size, q.shape[1], k_cache.shape[1], q_heads, kv_heads)
    out = cuda_paged_decode_attention(
        q, k_cache, v_cache, page_table, ctx_lens, sliding_window=sliding_window, sinks=sinks,
        shared_kv=shared_kv, tail_k=tail_k, tail_v=tail_v, tail_lens=tail_lens)
    sharded_paged_decode_attention.launches += 1
    return out


sharded_paged_decode_attention.launches = 0


def sharded_paged_prefill_attention(
    group,
    q: torch.Tensor,  # [batch, q_seq, q_heads / tp, head_dim]: the rank's query heads
    k_cache: torch.Tensor,  # [num_pages, kv_heads / tp (or 1: whole), page_size, head_dim]
    v_cache: torch.Tensor | None,
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    ctx_lens: torch.Tensor,  # [batch] int32
    total_lens: torch.Tensor,  # [batch] int32
    *,
    q_heads: int,
    kv_heads: int,
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
) -> torch.Tensor:
    """Flash prefill of a tensor-parallel rank's heads: the counterpart of
    the JAX ``sharded_paged_prefill_attention``
    (``llmd_kv_cache_tpu/ops/pallas_paged_attention.py:1657``). As
    ``sharded_paged_decode_attention``: the local head counts checked
    against ``group.size``, then ``cuda_paged_prefill_attention`` on the
    rank's operands (``shared_kv``: the latent prefill at ``q_heads / tp``
    heads). Returns ``[batch, q_seq, q_heads / tp, head_dim]``. CUDA tensors
    launch the kernel or raise and count one dispatch in ``.launches``; CPU
    tensors run the plain ``sharded_prefill_attention``."""
    if q.device.type == "cpu":
        return sharded_prefill_attention(
            group.size, q, k_cache, v_cache, page_table, ctx_lens, total_lens,
            q_heads=q_heads, kv_heads=kv_heads, sliding_window=sliding_window, sinks=sinks,
            shared_kv=shared_kv)
    check_tp_heads(group.size, q.shape[2], k_cache.shape[1], q_heads, kv_heads)
    out = cuda_paged_prefill_attention(
        q, k_cache, v_cache, page_table, ctx_lens, total_lens, sliding_window=sliding_window,
        sinks=sinks, shared_kv=shared_kv)
    sharded_paged_prefill_attention.launches += 1
    return out


sharded_paged_prefill_attention.launches = 0
