"""Paged attention over a page-table-addressed KV cache: the plain version.

Port of ``llmd_kv_cache_tpu/ops/paged_attention.py``: gathers each
sequence's pages into logical order and runs masked multi-head attention.
Serves prefill (seq > 1, queries appended after a cached prefix) and decode
(seq == 1); ``paged_ragged_attention`` runs it row by row over a ragged
mixed batch, ``paged_decode_attention`` for one query a row at its
context's end. ``sharded_decode_attention`` and ``sharded_prefill_attention``
are a tensor-parallel rank's calls: the rank's local query heads over its
local kv heads (or the whole single-head pool), checked against the group
size (``check_tp_heads``, the pool part of ``tp_pool_heads``); attention
needs no collective. They are the plain
PyTorch versions of the Hopper kernels in ``cuda_paged_attention`` and of
its sharded wrappers: the wrappers run them for CPU tensors, the tests hold
them against the JAX package, and ``chip_smoke.py`` holds the kernels
against them on the card.

Numerics follow the JAX reference: the products take the cache-dtype
operands upcast to fp32 (a bf16·bf16 product is exact in fp32, so this is
"bf16 operands, fp32 accumulation"), the scale multiplies fp32 scores,
masked scores are ``-1e30``, the softmax is fp32, and the probabilities are
rounded to the value dtype before the PV product. The decode-burst tail is
the reference's: dense tail keys concatenated after the paged ones, with
their positions. An fp8 (e4m3) pool is the reference's quantized arm:
the gathered 1-byte pages, and a tail in the pool's dtype, are upcast to
the query dtype (exactly) before the same math.
"""

from __future__ import annotations

import torch

from .kv_pages import gather_kv_pages

_NEG_INF = -1e30


def paged_attention(
    q: torch.Tensor,  # [batch, q_seq, q_heads, head_dim]
    k_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim]
    v_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim]
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    q_positions: torch.Tensor,  # [batch, q_seq] logical position of each query
    total_lens: torch.Tensor,  # [batch] total tokens (context + new) per sequence
    scale: float | None = None,
    sliding_window: int | None = None,
    attention_sinks: int | None = None,
    tail_k: torch.Tensor | None = None,  # [batch, T, kv_heads, head_dim]
    tail_v: torch.Tensor | None = None,
    tail_lens: torch.Tensor | None = None,  # [batch] valid tail tokens
) -> torch.Tensor:
    """Causal attention of new queries against paged KV (cached + new).

    The KV for the new tokens must already be scattered into the cache.
    ``sliding_window=W`` restricts each query to the last W keys;
    ``attention_sinks=S`` additionally keeps the first S positions
    attendable past the window (StreamingLLM sinks). Returns
    ``[batch, q_seq, q_heads, head_dim]`` in the query dtype. A row with
    no attendable key averages every key uniformly, as the reference does.

    ``tail_k``/``tail_v``/``tail_lens`` append a dense decode-burst KV tail
    after the paged keys: tail slot ``j`` sits at position ``total_lens +
    j`` and is attendable while ``j < tail_lens``. With a tail,
    ``total_lens`` is the burst's frozen base length and the queries sit at
    ``q_positions >= total_lens``; a sink position inside the tail stays
    attendable past the window like any other sink.
    """
    logits, mask, v = _masked_scores(q, k_cache, v_cache, page_table, q_positions,
                                     total_lens, scale, sliding_window, attention_sinks,
                                     tail_k, tail_v, tail_lens)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(q.shape).to(q.dtype)


def _masked_scores(q, k_cache, v_cache, page_table, q_positions, total_lens, scale,
                   sliding_window, attention_sinks, tail_k=None, tail_v=None, tail_lens=None):
    """The scaled fp32 scores ``[b, kv_heads, group, q_seq, kv_len]`` with
    masked keys at -1e30, the mask, and the gathered V ``[b, kv_len,
    kv_heads, head_dim]``; the key axis is the gathered pages (logical
    positions 0..), then the burst tail."""
    batch, q_seq, q_heads, head_dim = q.shape
    _, kv_heads, page_size, _ = k_cache.shape
    if scale is None:
        scale = head_dim ** -0.5
    group = q_heads // kv_heads

    k = gather_kv_pages(k_cache, page_table)  # [b, kv_len, kvh, hd]
    v = gather_kv_pages(v_cache, page_table)
    if k.dtype.itemsize == 1:  # fp8 pages: the products run in q's dtype
        k, v = k.to(q.dtype), v.to(q.dtype)
    kv_len = k.shape[1]

    k_pos = torch.arange(kv_len, device=q.device)[None].expand(batch, kv_len)
    k_valid = k_pos < total_lens[:, None]
    if tail_k is not None:
        slots = torch.arange(tail_k.shape[1], device=q.device)[None]
        k = torch.cat([k, tail_k.to(k.dtype)], dim=1)
        v = torch.cat([v, tail_v.to(v.dtype)], dim=1)
        k_pos = torch.cat([k_pos, total_lens[:, None] + slots], dim=1)
        k_valid = torch.cat([k_valid, slots < tail_lens[:, None]], dim=1)

    qg = q.reshape(batch, q_seq, kv_heads, group, head_dim)
    # [b, kvh, group, q_seq, kv_len], fp32
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale

    k_pos = k_pos[:, None, None, None, :]
    q_pos = q_positions[:, None, None, :, None]
    mask = (k_pos <= q_pos) & k_valid[:, None, None, None, :]
    if sliding_window is not None:
        in_window = q_pos - k_pos < sliding_window
        if attention_sinks:
            in_window = in_window | (k_pos < attention_sinks)
        mask = mask & in_window
    return torch.where(mask, logits, _NEG_INF), mask, v


def paged_attention_split_states(
    q: torch.Tensor,  # [batch, q_seq, q_heads, head_dim]
    k_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim]
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [batch, pages_per_seq] int32
    q_positions: torch.Tensor,  # [batch, q_seq]
    total_lens: torch.Tensor,  # [batch]
    key_bounds: torch.Tensor,  # [batch, splits + 1] key positions cutting each row's keys
    *,
    sliding_window: int | None = None,
    attention_sinks: int | None = None,
    tail_k: torch.Tensor | None = None,  # [batch, T, kv_heads, head_dim]
    tail_v: torch.Tensor | None = None,
    tail_lens: torch.Tensor | None = None,  # [batch] valid tail tokens
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unnormalised states of a split-KV launch: split s of row b takes
    the paged keys at positions ``[key_bounds[b, s], key_bounds[b, s + 1])``,
    as one CTA of the kernels' split arms does, and keeps the fp32 ``O = sum
    p v`` with ``p = exp(score - m)`` (rounded to the value dtype before
    the product), the max ``m`` of its attendable scores and ``l = sum p``.
    A decode-burst tail (``paged_attention``'s) is folded by the last split
    only, as the decode kernels' last split of a row folds it. A split with
    no attendable key has ``m = -1e30``, ``l = 0`` and ``O = 0``. Returns O
    ``[splits, batch, q_seq, q_heads, head_dim]`` and m, l ``[splits,
    batch, q_seq, q_heads]``, for ``merge_split_states``."""
    batch, q_seq, q_heads, head_dim = q.shape
    logits, mask, v = _masked_scores(q, k_cache, v_cache, page_table, q_positions,
                                     total_lens, None, sliding_window, attention_sinks,
                                     tail_k, tail_v, tail_lens)
    # The key axis is the gathered pages (index = position), then the tail.
    paged_len = page_table.shape[1] * k_cache.shape[2]
    k_idx = torch.arange(logits.shape[-1], device=q.device)[None, :]
    is_tail = k_idx >= paged_len
    n_split = key_bounds.shape[1] - 1
    accs, ms, ls = [], [], []
    for s in range(n_split):
        inside = (k_idx >= key_bounds[:, s:s + 1]) & (k_idx < key_bounds[:, s + 1:s + 2])
        inside = (inside & ~is_tail) | (is_tail & (s == n_split - 1))
        keep = mask & inside[:, None, None, None, :]
        m = torch.where(keep, logits, _NEG_INF).amax(-1)
        p = torch.where(keep, torch.exp(logits - m[..., None]), 0.0)
        acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())

        def heads(x):  # [b, kvh, g, q] -> [b, q, q_heads]
            return x.permute(0, 3, 1, 2).reshape(batch, q_seq, q_heads)

        accs.append(acc.reshape(batch, q_seq, q_heads, head_dim))
        ms.append(heads(m))
        ls.append(heads(p.sum(-1)))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def merge_split_states(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The kernels' combine pass in plain PyTorch (``merge_split_row`` in
    ``csrc/attention_common.cuh``, which every combine kernel runs): over
    the split axis 0, ``out = sum_s
    O_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)`` with ``M = max_s
    m_s``. A row that no split saw a key for gets zeros."""
    w = torch.exp(m - m.amax(0))
    return (acc * w[..., None]).sum(0) / (l * w).sum(0).clamp(min=1e-30)[..., None]


def paged_ragged_attention(
    q: torch.Tensor,  # [total_q, q_heads, head_dim] flat mixed batch
    k_cache: torch.Tensor,  # [num_pages, kv_heads, page_size, head_dim]
    v_cache: torch.Tensor | None,
    page_table: torch.Tensor,  # [rows, pages_per_seq] int32
    row_starts: torch.Tensor,  # [rows + 1] int32 flat-token prefix sums
    ctx_lens: torch.Tensor,  # [rows] int32 cached tokens before each row's new ones
    *,
    sliding_window: int | None = None,
    sinks: int | None = None,
    shared_kv: bool = False,
    tail_k: torch.Tensor | None = None,  # [rows, T, kv_heads, head_dim]
    tail_v: torch.Tensor | None = None,
    tail_lens: torch.Tensor | None = None,  # [rows] valid tail tokens
) -> torch.Tensor:
    """Attention over a ragged mixed prefill+decode batch, row by row.

    Row r's new tokens occupy flat slots ``[row_starts[r],
    row_starts[r+1])`` at logical positions ``ctx_lens[r] + i`` and attend
    causally over that row's paged KV (their KV already scattered), as
    ``paged_attention`` does for one row. ``sinks`` count only with a
    sliding window, as in the prefill wrapper. Returns ``[total_q,
    q_heads, head_dim]``; flat slots at and past ``row_starts[-1]`` are
    zeros. Reads ``row_starts``, ``ctx_lens`` and ``tail_lens`` on the host.

    ``shared_kv`` is absorbed MLA: the K pool (the latent) is also V and
    ``v_cache`` is not read (an MLA engine's V pool has width 0).
    ``tail_k``/``tail_v``/``tail_lens`` fold a dense decode-burst tail per
    row, the JAX kernel's contract: a row with ``tail_lens[r] > 0`` keeps
    its new KV in the tail, so its paged keys are ``[0, ctx_lens[r])``,
    tail slot ``j`` is the key at ``ctx_lens[r] + j`` and its query sits at
    ``ctx_lens[r] + tail_lens[r] - 1``. Only 1-token rows may carry a tail
    (the queries of a longer one would all sit there, as in the JAX
    kernel). Under ``shared_kv`` the tail is also V and ``tail_v`` is unread.
    """
    if shared_kv:
        v_cache, tail_v = k_cache, tail_k
    out = torch.zeros_like(q)
    starts = row_starts.tolist()
    ctxs = ctx_lens.tolist()
    tails = tail_lens.tolist() if tail_k is not None else [0] * len(ctxs)
    for r, ctx in enumerate(ctxs):
        start, end = starts[r], starts[r + 1]
        if end <= start:
            continue
        tail = {}
        if tails[r] > 0:
            positions = torch.full((1, end - start), ctx + tails[r] - 1, device=q.device)
            total = ctx
            tail = dict(tail_k=tail_k[r:r + 1], tail_v=tail_v[r:r + 1],
                        tail_lens=tail_lens[r:r + 1])
        else:
            positions = torch.arange(ctx, ctx + end - start, device=q.device)[None]
            total = ctx + end - start
        out[start:end] = paged_attention(
            q[None, start:end], k_cache, v_cache, page_table[r:r + 1], positions,
            torch.tensor([total], device=q.device),
            sliding_window=sliding_window,
            attention_sinks=sinks if sliding_window is not None else None, **tail,
        )[0]
    return out


def paged_decode_attention(q, k_cache, v_cache, page_table, ctx_lens, sliding_window=None,
                           sinks=None, tail_k=None, tail_v=None, tail_lens=None):
    """One query a row (``q`` ``[batch, q_heads, head_dim]``) at ``ctx_len -
    1``, or at ``ctx_len + tail_len - 1`` past a decode-burst tail, over the
    row's ``ctx_len`` paged keys (and the tail): the decode wrappers' CPU
    path. ``sinks`` count only with a sliding window."""
    q_end = ctx_lens if tail_k is None else ctx_lens + tail_lens
    return paged_attention(
        q[:, None], k_cache, v_cache, page_table, (q_end - 1)[:, None], ctx_lens,
        sliding_window=sliding_window,
        attention_sinks=sinks if sliding_window is not None else None,
        tail_k=tail_k, tail_v=tail_v, tail_lens=tail_lens,
    )[:, 0]


def tp_pool_heads(kv_heads: int, tp: int) -> int:
    """The heads of a tensor-parallel rank's part of a pool of ``kv_heads``
    heads: the whole pool when it has one head (absorbed MLA's latent,
    MQA), else ``kv_heads / tp``. Raises ``ValueError`` when they do not
    split."""
    if tp < 1 or (kv_heads > 1 and kv_heads % tp):
        raise ValueError(f"{kv_heads} kv heads do not split into {tp} ranks")
    return 1 if kv_heads == 1 else kv_heads // tp


def check_tp_heads(tp: int, local_q_heads: int, local_kv_heads: int, q_heads: int,
                   kv_heads: int) -> None:
    """A tensor-parallel rank's head counts against the group size ``tp``
    and the model's ``q_heads`` and ``kv_heads`` (the pool's): the pool
    part of ``tp_pool_heads``, and the query's ``q_heads / tp`` heads
    (whole GQA groups, since ``kv_heads`` divides by ``tp``). Raises
    ``ValueError`` otherwise."""
    if tp < 1 or q_heads % tp:
        raise ValueError(f"{q_heads} query heads do not split into {tp} ranks")
    want_kv = tp_pool_heads(kv_heads, tp)
    if (local_q_heads, local_kv_heads) != (q_heads // tp, want_kv):
        pool = "the whole pool of one head" if kv_heads == 1 else \
            f"{want_kv} of {kv_heads} kv heads"
        raise ValueError(f"at tp {tp} a rank takes {q_heads // tp} of {q_heads} query heads "
                         f"and {pool}; got {local_q_heads} query heads over a pool of "
                         f"{local_kv_heads}")


def sharded_decode_attention(tp: int, q, k_cache, v_cache, page_table, ctx_lens, *,
                             q_heads: int, kv_heads: int, sliding_window=None, sinks=None,
                             shared_kv=False, tail_k=None, tail_v=None, tail_lens=None):
    """A tensor-parallel rank's decode (the JAX ``sharded_paged_decode_attention``
    on one shard): ``q`` ``[batch, q_heads / tp, head_dim]`` over the rank's
    pool, checked by ``check_tp_heads``; returns the rank's heads.
    ``shared_kv``: the K pool (the latent) is also V, and its tail too."""
    check_tp_heads(tp, q.shape[1], k_cache.shape[1], q_heads, kv_heads)
    if shared_kv:
        v_cache, tail_v = k_cache, tail_k
    return paged_decode_attention(q, k_cache, v_cache, page_table, ctx_lens, sliding_window,
                                  sinks, tail_k, tail_v, tail_lens)


def sharded_prefill_attention(tp: int, q, k_cache, v_cache, page_table, ctx_lens, total_lens,
                              *, q_heads: int, kv_heads: int, sliding_window=None, sinks=None,
                              shared_kv=False):
    """A tensor-parallel rank's prefill (the JAX
    ``sharded_paged_prefill_attention`` on one shard): ``q`` ``[batch,
    q_seq, q_heads / tp, head_dim]``, query i of row b at ``ctx_lens[b] +
    i``, over the rank's pool, checked by ``check_tp_heads``; returns the
    rank's heads. ``shared_kv``: the K pool is also V."""
    check_tp_heads(tp, q.shape[2], k_cache.shape[1], q_heads, kv_heads)
    positions = ctx_lens[:, None] + torch.arange(q.shape[1], device=q.device)[None]
    return paged_attention(
        q, k_cache, k_cache if shared_kv else v_cache, page_table, positions, total_lens,
        sliding_window=sliding_window,
        attention_sinks=sinks if sliding_window is not None else None)
