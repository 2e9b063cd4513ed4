"""The Hopper kernels against their plain PyTorch version, on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (they build the kernels);
elsewhere they skip. On a machine with the card, which has no JAX (the
repo's ``conftest.py`` tears JAX caches down, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

They cover every compiled (head_dim, GQA group) pair, page sizes 4 and 16,
ragged and padded rows, sliding windows with sinks, the GQA decode split
across 1, 2 or the planned number of CTAs and captured in a CUDA graph, the
GQA prefill over several query tiles with padded query slots, the ragged kernel's
mixes (rows that straddle its query tiles, an empty row, slots past the
last row, a decode-only dispatch whose decode arm runs split, decode rows at
contexts up to 4160 beside a chunk, rows at the decode/prefill arm
boundary, and enough decode rows to run unsplit), the latent kernels at
every built shape (absorbed MLA at latent widths 576 and 640 with 16 heads,
MQA at 128 with 8 and 16; decode contexts inside one 32-key chunk and at
and beside its edges, split across 1, 2 or the planned CTAs; prefill
chunks of 1, 7, 31, 33, 64 and 75 tokens,
the warm 64 over 4096 cached, ctx 0, split across CTAs by the planner or
forced), both decode kernels' decode-burst tail arms (tails
of 1, 8 and 64 slots, rows with no paged key, paged keys
ending at and beside a chunk boundary, every built shape, SWA + sinks and a
window the tail outruns), the engine's captured burst against the same burst
run eagerly (a GQA and an MLA model, and the GQA model over fp8 pools) and
the wrappers' checks, and the ragged kernel's last two arms: its
``shared_kv`` arm (the latent ragged kernel, widths 576 and 640, page sizes
4 and 16, an empty row, 2- and 3-token rows, a decode-only dispatch and a
chunk beside decode rows, decode rows split across 1, 3 or the planned
CTAs) and its burst-tail arm on both ragged kernels (1-token rows with
tails of 0 to 64 slots beside a prefill row, bf16 and fp8 pools, the
latent tail), the latent ragged kernel's prefill rows split across CTAs
(the 64-token chunk alone and beside 1 or 8 decode rows, the odd mix; the
planned splits or forced ones), both ragged kernels at 1, max_batch + 1 and
40 rows (each prefill CTA finds its row from row_starts in the kernel),
one ragged plan reused across layers, forward_ragged planning once a
dispatch, and the library's tile-slot rule against its plain mirror. The GQA decode (with its tail), prefill and ragged
kernels run over bf16 and over fp8 e4m3 pools (their fp8 arms; the pools
hold the bf16 values cast as the engine casts them, and the plain version
reads the same bytes), and the engine's fp8 cast is held on the card against
the CPU's. Tolerance as
in ``chip_smoke.py``: the kernels and the plain version round p and the
output to bf16 at different points, so they may differ by about two bf16
ulps of the output; the absolute term is scaled to each row's output.
"""

import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu_torch.ops.kv_pages import to_kv_dtype
from llmd_kv_cache_tpu_torch.ops.cuda_paged_attention import (
    cuda_paged_decode_attention,
    cuda_paged_latent_decode_attention,
    cuda_paged_latent_prefill_attention,
    cuda_paged_prefill_attention,
    cuda_paged_ragged_attention,
    latent_decode_splits,
)
from llmd_kv_cache_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_ragged_attention,
)

pytestmark = pytest.mark.cuda

ATOL = RTOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


FP8 = torch.float8_e4m3fn
# The pools' element type: bf16, or fp8 e4m3 (the kernels' fp8 arms).
KV_DTYPES = [torch.bfloat16, FP8]


def pool(gen, num_pages, kv_heads, page, head_dim, dtype=torch.bfloat16):
    shape = (num_pages, kv_heads, page, head_dim)
    return tuple(to_kv_dtype(torch.randn(shape, generator=gen, device="cuda")
                             .to(torch.bfloat16), dtype) for _ in range(2))


def table_for(gen, lens, page, pages_per_seq, num_pages):
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(len(lens), pages_per_seq, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lens):
        k = (n + page - 1) // page
        table[b, :k] = perm[used:used + k].to(torch.int32)
        used += k
    return table


def assert_close(got, ref):
    """|got - ref| <= ATOL * min(1, rms of the row's ref) + RTOL * |ref|, a
    row being an entry of the first axis (a decode row, a token): over N
    keys an output's rms is about sqrt(e / N), so a flat ATOL would pass an
    error of the output's own size at long contexts."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    rms = ref.reshape(ref.shape[0], -1).pow(2).mean(1).sqrt().clamp(max=1)
    atol = ATOL * rms.reshape((-1,) + (1,) * (ref.dim() - 1))
    err = (got - ref).abs()
    assert bool((err <= atol + RTOL * ref.abs()).all()), \
        float((err / (atol + RTOL * ref.abs())).max())


GEOMETRIES = [(hd, g) for hd in (64, 128) for g in (1, 2, 4, 8)]
WINDOWS = [(None, None), (37, 5)]


def force_decode_splits(monkeypatch, splits):
    """Plan ``splits`` CTAs a (row, kv head) for the GQA decode, or leave the
    planner alone (None)."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    if splits is not None:
        monkeypatch.setattr(ops, "decode_splits", lambda *a, **kw: splits)


# The GQA decode's key splits: one CTA a (row, kv head), two, or the plan.
DECODE_SPLITS = [1, 2, None]


@pytest.mark.parametrize("head_dim,group", GEOMETRIES)
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("splits", DECODE_SPLITS)
@pytest.mark.parametrize("kv", KV_DTYPES, ids=["bf16", "fp8"])
def test_decode_matches_plain(gen, monkeypatch, head_dim, group, page, window, sinks, splits,
                              kv):
    """Split across 1, 2 or the planned number of CTAs a (row, kv head)
    (the plan leaves splits with no chunk at the short rows); a padded row
    returns zeros."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    kv_heads = 2
    lens = [1, page, 3 * page + 1, 200, 1000, 0]
    pages_per_seq = -(-max(lens) // page) + 2
    num_pages = 1 + sum((n + page - 1) // page for n in lens) + 3
    k, v = pool(gen, num_pages, kv_heads, page, head_dim, kv)
    table = table_for(gen, lens, page, pages_per_seq, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), kv_heads * group, head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    if splits is None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert ops.decode_splits(q, k, table, 64, sms) > 2
    force_decode_splits(monkeypatch, splits)
    before = (cuda_paged_decode_attention.launches, cuda_paged_decode_attention.launches_fp8)
    out = cuda_paged_decode_attention(q, k, v, table, ctx,
                                      sliding_window=window, sinks=sinks)
    torch.cuda.synchronize()
    assert (cuda_paged_decode_attention.launches,
            cuda_paged_decode_attention.launches_fp8) == (before[0] + 1,
                                                           before[1] + (kv == FP8))
    ref = paged_attention(q[:, None], k, v, table, (ctx - 1)[:, None], ctx,
                          sliding_window=window, attention_sinks=sinks)[:, 0]
    live = ctx > 0
    assert_close(out[live], ref[live])
    assert bool((out[~live] == 0).all())  # padded row: zeros, never NaN


def test_decode_graph_replays_eager(gen):
    """The split decode captured in a CUDA graph (as the engine captures a
    burst) and replayed, with a tail and without: outputs identical to an
    eager call, also after the lengths change in place (the plan comes from
    shapes, so the graph serves any lengths)."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    kv_heads, group, head_dim, page, slots = 8, 2, 128, 16, 8
    lens = [4160, 3001, 17, 1, 0, 2048, 64, 4095]
    pages_per_seq = 272
    num_pages = 1 + sum((n + slots + page - 1) // page for n in lens) + 3
    k, v = pool(gen, num_pages, kv_heads, page, head_dim)
    table = table_for(gen, [n + slots for n in lens], page, pages_per_seq, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tl = torch.tensor([slots, 1, 0, slots, 0, 5, slots, 3], dtype=torch.int32, device="cuda")
    shape = (len(lens), slots, kv_heads, head_dim)
    tk, tv = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn(len(lens), kv_heads * group, head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.decode_splits(q, k, table, 64, sms) > 1

    def run():
        return (cuda_paged_decode_attention(q, k, v, table, ctx),
                cuda_paged_decode_attention(q, k, v, table, ctx, tail_k=tk, tail_v=tv,
                                            tail_lens=tl))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # warm-up: the launchers' one-time set-up, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for new_lens in (lens, [n // 2 for n in lens]):
        ctx.copy_(torch.tensor(new_lens, dtype=torch.int32))
        graph.replay()
        eager = run()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


@pytest.mark.parametrize("head_dim,group", GEOMETRIES)
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("kv", KV_DTYPES, ids=["bf16", "fp8"])
def test_prefill_matches_plain(gen, head_dim, group, page, window, sinks, kv):
    """Rows of 300 query slots (not a multiple of the 128 / group-token
    tile, several tiles at every group): a chunk at ctx 0, chunks over a
    cached prefix with padded slots past ``total_lens - ctx`` (compared
    too: they attend the keys below ``total_lens``, as the plain version's
    positions do), and a row with no key, which returns zeros."""
    kv_heads, q_seq = 2, 300
    ctx_l, new_l = [0, 2 * page + 3, 130, 0], [q_seq, 40, 1, 0]
    total_l = [c + n for c, n in zip(ctx_l, new_l)]
    pages_per_seq = -(-max(total_l) // page) + 2
    num_pages = 1 + sum((n + page - 1) // page for n in total_l) + 3
    k, v = pool(gen, num_pages, kv_heads, page, head_dim, kv)
    table = table_for(gen, total_l, page, pages_per_seq, num_pages)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    total = torch.tensor(total_l, dtype=torch.int32, device="cuda")
    q = torch.randn(len(ctx_l), q_seq, kv_heads * group, head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    before = cuda_paged_prefill_attention.launches
    out = cuda_paged_prefill_attention(q, k, v, table, ctx, total,
                                       sliding_window=window, sinks=sinks)
    torch.cuda.synchronize()
    assert cuda_paged_prefill_attention.launches == before + 1
    positions = ctx[:, None] + torch.arange(q_seq, device="cuda")[None]
    ref = paged_attention(q, k, v, table, positions, total,
                          sliding_window=window, attention_sinks=sinks)
    for b, n in enumerate(total_l):
        if n:
            assert_close(out[b], ref[b])
        else:
            assert bool((out[b] == 0).all())


# (q_lens, ctx_lens) of the ragged mixes. Rows of at most 16 / group tokens
# take the kernel's split-KV decode arm, longer ones its prefill tiles.
RAGGED_MIXES = {
    # Decode rows, an empty row, and chunks whose lengths straddle the
    # prefill tiles of 64 / group tokens.
    "straddle": ([1, 7, 0, 100, 33, 1, 70], [5, 0, 9, 40, 200, 3, 129]),
    # A decode-only dispatch: 1-token rows at contexts up to 4160.
    "decode_only": ([1] * 8, [1, 17, 300, 1023, 2048, 3001, 4100, 4159]),
    # Many decode rows at mixed contexts beside a long chunk.
    "mixed": ([1] * 12 + [300], [1, 2, 64, 65, 500, 1000, 2047, 2500, 3333, 4000, 4159, 7,
                                 2048]),
    # Rows at the arm boundary: 2 and 3 tokens (the largest decode rows of
    # group 8 and the smallest prefill rows), 4/5, 8/9 and 16/17.
    "boundary": ([2, 3, 4, 5, 8, 9, 16, 17, 1], [40, 41, 100, 3, 500, 77, 64, 1000, 0]),
}


@pytest.mark.parametrize("head_dim,group", GEOMETRIES)
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("mix", sorted(RAGGED_MIXES))
@pytest.mark.parametrize("kv", KV_DTYPES, ids=["bf16", "fp8"])
def test_ragged_matches_plain(gen, head_dim, group, page, window, sinks, mix, kv):
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    kv_heads, pad = 2, 5  # five slots past the last row
    q_lens, ctx_l = RAGGED_MIXES[mix]
    total_l = [c + n for c, n in zip(ctx_l, q_lens)]
    pages_per_seq = -(-max(total_l) // page) + 2
    num_pages = 1 + sum((n + page - 1) // page for n in total_l) + 3
    k, v = pool(gen, num_pages, kv_heads, page, head_dim, kv)
    table = table_for(gen, total_l, page, pages_per_seq, num_pages)
    starts = torch.tensor([0] + q_lens, device="cuda").cumsum(0).to(torch.int32)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    real = sum(q_lens)
    q = torch.randn(real + pad, kv_heads * group, head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    if mix == "decode_only":  # the decode arm runs split
        assert ops.ragged_decode_splits(
            len(q_lens), kv_heads, pages_per_seq, page, 64,
            torch.cuda.get_device_properties(0).multi_processor_count) > 1
    before = (cuda_paged_ragged_attention.launches, cuda_paged_ragged_attention.launches_fp8)
    out = cuda_paged_ragged_attention(q, k, v, table, starts, ctx,
                                      sliding_window=window, sinks=sinks)
    torch.cuda.synchronize()
    assert (cuda_paged_ragged_attention.launches,
            cuda_paged_ragged_attention.launches_fp8) == (before[0] + 1,
                                                           before[1] + (kv == FP8))
    ref = paged_ragged_attention(q, k, v, table, starts, ctx,
                                 sliding_window=window, sinks=sinks)
    assert_close(out[:real], ref[:real])
    assert bool((out[real:] == 0).all())  # slots past the last row: zeros


@pytest.mark.parametrize("head_dim,group", [(128, 2), (64, 8)])
def test_ragged_decode_arm_unsplit(gen, head_dim, group):
    """Enough decode rows to fill the card take one CTA a (row, kv head)
    and no combine pass; a chunk rides beside them."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    kv_heads, page = 2, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = sms * ops.RAGGED_CTAS_PER_SM // kv_heads + 1
    q_lens = [1] * (rows - 1) + [90]
    ctx_l = torch.randint(0, 700, (rows,), generator=gen, device="cuda").tolist()
    total_l = [c + n for c, n in zip(ctx_l, q_lens)]
    pages_per_seq = -(-max(total_l) // page)
    num_pages = 1 + sum((n + page - 1) // page for n in total_l) + 3
    k, v = pool(gen, num_pages, kv_heads, page, head_dim)
    table = table_for(gen, total_l, page, pages_per_seq, num_pages)
    assert ops.ragged_decode_splits(rows, kv_heads, pages_per_seq, page, 64, sms) == 1
    starts = torch.tensor([0] + q_lens, device="cuda").cumsum(0).to(torch.int32)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    q = torch.randn(sum(q_lens), kv_heads * group, head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    out = cuda_paged_ragged_attention(q, k, v, table, starts, ctx)
    torch.cuda.synchronize()
    assert_close(out, paged_ragged_attention(q, k, v, table, starts, ctx))


LATENT_DECODE = [(True, 576, 16), (True, 640, 16), (False, 128, 8), (False, 128, 16)]


@pytest.mark.parametrize("shared,width,heads", LATENT_DECODE)
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,sinks", WINDOWS)
def test_latent_decode_matches_plain(gen, shared, width, heads, page, window, sinks):
    """Through ``cuda_paged_decode_attention``, which routes one KV head and
    shared_kv to the latent kernel; a padded row returns zeros."""
    lens = [1, page, 3 * page + 1, 200, 0]
    pages_per_seq = 64
    num_pages = 1 + sum((n + page - 1) // page for n in lens) + 3
    k, v = pool(gen, num_pages, 1, page, width)
    if shared:
        v = k
    table = table_for(gen, lens, page, pages_per_seq, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), heads, width, generator=gen,
                    device="cuda").to(torch.bfloat16)
    before = (cuda_paged_latent_decode_attention.launches,
              cuda_paged_decode_attention.launches)
    out = cuda_paged_decode_attention(q, k, v, table, ctx, sliding_window=window,
                                      sinks=sinks, shared_kv=shared)
    torch.cuda.synchronize()
    assert (cuda_paged_latent_decode_attention.launches,
            cuda_paged_decode_attention.launches) == (before[0] + 1, before[1])
    ref = paged_attention(q[:, None], k, v, table, (ctx - 1)[:, None], ctx,
                          sliding_window=window, attention_sinks=sinks)[:, 0]
    live = ctx > 0
    assert_close(out[live], ref[live])
    assert bool((out[~live] == 0).all())


def force_latent_splits(monkeypatch, splits):
    """Plan ``splits`` CTAs a row for the latent decode, or leave the
    planner alone (None)."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    if splits is not None:
        monkeypatch.setattr(ops, "latent_decode_splits", lambda *a, **kw: splits)


# Paged contexts at the latent decode's 32-key chunk edges (inside one
# chunk, at and beside one, two and three chunks), a row with no paged key
# (with a tail when there is one) and a padded row.
LATENT_EDGE_LENS = [1, 5, 20, 31, 32, 33, 63, 64, 65, 96, 97, 0, 0]


def latent_edge_tails(slots):
    """Tail lengths of LATENT_EDGE_LENS' rows for a tail of ``slots`` slots:
    full, one, none, and lengths at the 32-slot chunk edge where they fit;
    the last row stays padded."""
    return [slots, 1, min(5, slots), slots, 0, min(31, slots), min(32, slots),
            min(33, slots), 1, min(63, slots), max(slots - 1, 0), slots, 0]


@pytest.mark.parametrize("shared,width,heads", LATENT_DECODE)
@pytest.mark.parametrize("window,sinks", [(None, None), (40, 5)])
@pytest.mark.parametrize("slots", [0, 1, 8, 64])
@pytest.mark.parametrize("splits", [1, 2, None])
def test_latent_decode_chunk_edges_match_plain(gen, monkeypatch, shared, width, heads, window,
                                               sinks, slots, splits):
    """The latent decode tile at its edges: contexts inside one 32-key chunk
    and at chunk boundaries, split across 1, 2 or the planned number of CTAs
    (which leaves splits, and a CTA's second team, with no chunk), SWA with
    sinks, burst tails of 1, 8 and 64 slots (one or two tail chunks, folded
    by the last split's second team, with or without paged keys), a padded
    row returning zeros."""
    force_latent_splits(monkeypatch, splits)
    page, lens = 16, LATENT_EDGE_LENS
    pages_per_seq = -(-max(lens) // page) + 2
    num_pages = 1 + sum((n + page - 1) // page for n in lens) + 3
    k, v = pool(gen, num_pages, 1, page, width)
    if shared:
        v = k
    table = table_for(gen, lens, page, pages_per_seq, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), heads, width, generator=gen, device="cuda").to(torch.bfloat16)
    tl = torch.zeros_like(ctx)
    tails = {}
    if slots:
        tl = torch.tensor(latent_edge_tails(slots), dtype=torch.int32, device="cuda")
        shape = (len(lens), slots, 1, width)
        tk, tv = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        tails = dict(tail_k=tk, tail_v=tk if shared else tv, tail_lens=tl)
    out = cuda_paged_latent_decode_attention(q, k, v, table, ctx, sliding_window=window,
                                             sinks=sinks, shared_kv=shared, **tails)
    torch.cuda.synchronize()
    if slots:
        ref = plain_with_tail(q, k, v, table, ctx, tails["tail_k"], tails["tail_v"], tl,
                              window, sinks)
    else:
        ref = paged_attention(q[:, None], k, v, table, (ctx - 1)[:, None], ctx,
                              sliding_window=window, attention_sinks=sinks)[:, 0]
    live = (ctx + tl) > 0
    assert_close(out[live], ref[live])
    assert bool((out[~live] == 0).all())


def latent_cta_slots():
    """The latent decode's CTA slots on this card: its SMs times the
    kernel's CTAs an SM."""
    from llmd_kv_cache_tpu_torch.ops.cuda_build import load_library

    return (torch.cuda.get_device_properties(0).multi_processor_count
            * load_library().llmd_latent_decode_ctas_per_sm())


def latent_plan(batch, pages_per_seq, page):
    """The latent decode's key splits a row for this card."""
    from llmd_kv_cache_tpu_torch.ops.cuda_build import load_library

    return latent_decode_splits(batch, pages_per_seq, page,
                                load_library().llmd_latent_decode_chunk_keys(),
                                latent_cta_slots())


def test_latent_decode_unsplit_at_a_batch_that_fills_the_card(gen):
    """A batch of a row for every CTA slot of the card (its SMs times the
    kernel's CTAs an SM) and more takes one CTA a row and no combine pass
    (the smaller batches above run split across CTAs)."""
    batch = latent_cta_slots() + 3
    lens = torch.randint(0, 300, (batch,), generator=gen, device="cuda").tolist()
    page, pages_per_seq = 16, 20
    num_pages = 1 + sum((n + page - 1) // page for n in lens) + 3
    k, _ = pool(gen, num_pages, 1, page, 576)
    table = table_for(gen, lens, page, pages_per_seq, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(batch, 16, 576, generator=gen, device="cuda").to(torch.bfloat16)
    assert latent_plan(batch, pages_per_seq, page) == 1
    out = cuda_paged_latent_decode_attention(q, k, None, table, ctx, shared_kv=True)
    torch.cuda.synchronize()
    ref = paged_attention(q[:, None], k, k, table, (ctx - 1)[:, None], ctx)[:, 0]
    live = ctx > 0
    assert_close(out[live], ref[live])
    assert bool((out[~live] == 0).all())


@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("splits", [None, 3])
def test_latent_prefill_matches_plain(gen, monkeypatch, width, page, window, sinks, splits):
    """Through ``cuda_paged_prefill_attention(shared_kv=True)``: chunks of
    75 (not a multiple of the 4-token tile), 64, 1 and 7 tokens, the warm
    chunk (64 over 4096 cached), an odd chunk over an odd prefix, and at
    ctx 0; each tile's keys unsplit as planned for this batch, or split
    across 3 CTAs (forced through the planning function)."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    if splits is not None:
        monkeypatch.setattr(ops, "latent_prefill_splits", lambda *a, **kw: splits)
    q_seq = 75
    ctx_l, new_l = [0, 2 * page + 3, 130, 9, 4096, 1037, 0], [q_seq, 64, 1, 7, 64, 33, 75]
    total_l = [c + n for c, n in zip(ctx_l, new_l)]
    pages_per_seq = -(-max(total_l) // page) + 1
    num_pages = 1 + sum((n + page - 1) // page for n in total_l) + 3
    k, _ = pool(gen, num_pages, 1, page, width)
    table = table_for(gen, total_l, page, pages_per_seq, num_pages)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    total = torch.tensor(total_l, dtype=torch.int32, device="cuda")
    q = torch.randn(len(ctx_l), q_seq, 16, width, generator=gen,
                    device="cuda").to(torch.bfloat16)
    before = (cuda_paged_latent_prefill_attention.launches,
              cuda_paged_prefill_attention.launches)
    out = cuda_paged_prefill_attention(q, k, k, table, ctx, total, shared_kv=True,
                                       sliding_window=window, sinks=sinks)
    torch.cuda.synchronize()
    assert (cuda_paged_latent_prefill_attention.launches,
            cuda_paged_prefill_attention.launches) == (before[0] + 1, before[1])
    positions = ctx[:, None] + torch.arange(q_seq, device="cuda")[None]
    ref = paged_attention(q, k, k, table, positions, total,
                          sliding_window=window, attention_sinks=sinks)
    for b, n in enumerate(new_l):
        assert_close(out[b, :n], ref[b, :n])


@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("ctx_len,new", [(4096, 64), (0, 64), (4000, 1), (2049, 31)])
def test_latent_prefill_short_chunk_splits(gen, width, ctx_len, new):
    """One short chunk, as the engine sends a warm one: the planner splits
    its tiles' keys across CTAs, and the combine pass merges them."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    page, pages_per_seq = 16, 272
    num_pages = pages_per_seq + 1
    k, _ = pool(gen, num_pages, 1, page, width)
    table = table_for(gen, [ctx_len + new], page, pages_per_seq, num_pages)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.latent_prefill_splits(1, new, pages_per_seq, page, 64, 4, sms) > 1
    ctx = torch.tensor([ctx_len], dtype=torch.int32, device="cuda")
    total = ctx + new
    q = torch.randn(1, new, 16, width, generator=gen, device="cuda").to(torch.bfloat16)
    out = cuda_paged_latent_prefill_attention(q, k, table, ctx, total)
    torch.cuda.synchronize()
    positions = ctx[:, None] + torch.arange(new, device="cuda")[None]
    assert_close(out, paged_attention(q, k, k, table, positions, total))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    k, v = pool(gen, 5, 2, 16, 128)
    table = torch.ones(1, 4, dtype=torch.int32, device="cuda")
    ctx = torch.tensor([3], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 4, 128, generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bf16"):
        cuda_paged_decode_attention(q.float(), k, v, table, ctx)
    with pytest.raises(ValueError, match="int32"):
        cuda_paged_decode_attention(q, k, v, table.long(), ctx)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_paged_decode_attention(q, k.transpose(1, 2), v, table, ctx)
    with pytest.raises(ValueError, match="is on"):
        cuda_paged_decode_attention(q, k, v, table.cpu(), ctx)
    with pytest.raises(NotImplementedError, match="head_dim"):
        cuda_paged_decode_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                                    v[..., :96].contiguous(), table, ctx)
    with pytest.raises(NotImplementedError, match="group"):
        cuda_paged_decode_attention(torch.cat([q] * 8, 1), k, v, table, ctx)
    starts = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="row_starts"):
        cuda_paged_ragged_attention(q, k, v, table, starts[:1], ctx)
    with pytest.raises(NotImplementedError, match="group"):
        cuda_paged_ragged_attention(torch.cat([q] * 8, 1), k, v, table, starts, ctx)
    latent, _ = pool(gen, 5, 1, 16, 576)
    q16 = torch.randn(1, 16, 576, generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="built for"):
        cuda_paged_latent_decode_attention(q16, k, k, table, ctx, shared_kv=True)
    with pytest.raises(NotImplementedError, match="built for"):
        cuda_paged_decode_attention(q16[:, :8].contiguous(), latent, None, table, ctx,
                                    shared_kv=True)
    with pytest.raises(NotImplementedError, match="bf16"):
        cuda_paged_decode_attention(q16.float(), latent, None, table, ctx, shared_kv=True)
    with pytest.raises(NotImplementedError, match="built for"):
        cuda_paged_prefill_attention(q16[:, None, :8].contiguous(), latent, None, table,
                                     ctx, ctx + 1, shared_kv=True)


# --------------------------------------------------------------------------
# the decode-burst tail arms, and a captured burst
# --------------------------------------------------------------------------

# SWA + sinks, and a window the tail outruns with a row below the sinks.
TAIL_WINDOWS = [(None, None), (37, 5), (3, 4)]


def tail_inputs(gen, kv_heads, head_dim, page, slots, dtype=torch.bfloat16):
    """Decode rows with their paged contexts and tail lengths: a row with
    no paged key and a tail, a full tail, an empty tail, a padded row, and
    paged keys ending at and beside a 64-key chunk boundary with tails of
    every length up to the slots (1, 63, 64 where they fit); pools and tail
    of ``dtype``."""
    lens = [0, 1, page, 3 * page + 1, 200, 0, 64, 127, 128, 129]
    tail_lens = [slots, slots, 0, min(5, slots), 1, 0, slots, min(63, slots), 1,
                 max(slots - 1, 0)]
    pages_per_seq = 64
    num_pages = 1 + sum((n + page - 1) // page for n in lens) + 3
    k, v = pool(gen, num_pages, kv_heads, page, head_dim, dtype)
    table = table_for(gen, lens, page, pages_per_seq, num_pages)
    shape = (len(lens), slots, kv_heads, head_dim)
    tail_k, tail_v = (to_kv_dtype(torch.randn(shape, generator=gen, device="cuda")
                                  .to(torch.bfloat16), dtype) for _ in range(2))
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tl = torch.tensor(tail_lens, dtype=torch.int32, device="cuda")
    return k, v, table, ctx, tail_k, tail_v, tl


def plain_with_tail(q, k, v, table, ctx, tail_k, tail_v, tl, window, sinks):
    return paged_attention(q[:, None], k, v, table, (ctx + tl - 1)[:, None], ctx,
                           sliding_window=window, attention_sinks=sinks, tail_k=tail_k,
                           tail_v=tail_v, tail_lens=tl)[:, 0]


@pytest.mark.parametrize("head_dim,group", GEOMETRIES)
@pytest.mark.parametrize("slots", [1, 8, 64])
@pytest.mark.parametrize("window,sinks", TAIL_WINDOWS)
@pytest.mark.parametrize("splits", DECODE_SPLITS)
@pytest.mark.parametrize("kv", KV_DTYPES, ids=["bf16", "fp8"])
def test_decode_tail_matches_plain(gen, monkeypatch, head_dim, group, slots, window, sinks,
                                   splits, kv):
    """The row's last split folds the tail, with or without paged keys of
    its own; over an fp8 pool the tail is fp8 too, as the engine keeps it."""
    force_decode_splits(monkeypatch, splits)
    kv_heads, page = 2, 16
    k, v, table, ctx, tail_k, tail_v, tl = tail_inputs(gen, kv_heads, head_dim, page, slots,
                                                       kv)
    q = torch.randn(len(ctx), kv_heads * group, head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    out = cuda_paged_decode_attention(q, k, v, table, ctx, sliding_window=window,
                                      sinks=sinks, tail_k=tail_k, tail_v=tail_v,
                                      tail_lens=tl)
    torch.cuda.synchronize()
    ref = plain_with_tail(q, k, v, table, ctx, tail_k, tail_v, tl, window, sinks)
    live = (ctx + tl) > 0
    assert_close(out[live], ref[live])
    assert bool((out[~live] == 0).all())


@pytest.mark.parametrize("shared,width,heads", LATENT_DECODE)
@pytest.mark.parametrize("slots", [1, 8, 64])
@pytest.mark.parametrize("window,sinks", TAIL_WINDOWS)
def test_latent_decode_tail_matches_plain(gen, shared, width, heads, slots, window, sinks):
    """Split across CTAs (the last split of a row folds the tail, with no
    paged key of its own at the short contexts) and, at a batch that fills
    the card, unsplit."""
    page = 16
    k, v, table, ctx, tail_k, tail_v, tl = tail_inputs(gen, 1, width, page, slots)
    if shared:
        v, tail_v = k, tail_k
    q = torch.randn(len(ctx), heads, width, generator=gen, device="cuda").to(torch.bfloat16)
    before = cuda_paged_latent_decode_attention.launches
    out = cuda_paged_decode_attention(q, k, v, table, ctx, sliding_window=window,
                                      sinks=sinks, shared_kv=shared, tail_k=tail_k,
                                      tail_v=tail_v, tail_lens=tl)
    torch.cuda.synchronize()
    assert cuda_paged_latent_decode_attention.launches == before + 1
    ref = plain_with_tail(q, k, v, table, ctx, tail_k, tail_v, tl, window, sinks)
    live = (ctx + tl) > 0
    assert_close(out[live], ref[live])
    assert bool((out[~live] == 0).all())
    # Unsplit: one row per SM and more, each row's CTA folds its own tail.
    reps = -(-latent_cta_slots() // len(ctx))
    rep = lambda x: x.repeat((reps,) + (1,) * (x.dim() - 1))  # noqa: E731
    assert latent_plan(len(ctx) * reps, table.shape[1], page) == 1
    out = cuda_paged_decode_attention(rep(q), k, v, rep(table), rep(ctx),
                                      sliding_window=window, sinks=sinks, shared_kv=shared,
                                      tail_k=rep(tail_k), tail_v=rep(tail_v), tail_lens=rep(tl))
    torch.cuda.synchronize()
    assert_close(out[rep(live)], rep(ref)[rep(live)])


BURST_MODELS = {
    "gqa": dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=8,
                num_kv_heads=2, head_dim=64, intermediate_size=512, page_size=16),
    "mla": dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=16,
                num_kv_heads=16, head_dim=32, intermediate_size=512, page_size=16,
                kv_lora_rank=512, qk_rope_head_dim=64),
}
BURST_MODELS["gqa-fp8"] = BURST_MODELS["gqa"]


@pytest.mark.parametrize("model", sorted(BURST_MODELS))
def test_burst_graph_matches_eager(gen, model):
    """The engine's captured burst against the same burst run eagerly
    through the kernels from identical caches and inputs: the same tokens
    and pool bytes, and the decode launches of layers x steps a replay
    (over fp8 pools, every one an fp8 launch)."""
    from llmd_kv_cache_tpu_torch.models import engine, llama

    cfg = llama.LlamaConfig(**BURST_MODELS[model])
    fp8 = model.endswith("fp8")
    eng = engine.MiniEngine(engine.EngineConfig(model=cfg, num_pages=64,
                                                max_pages_per_seq=16, max_batch=4,
                                                decode_burst=4,
                                                kv_cache_dtype="f8_e4m3" if fp8 else None),
                            seed=0)
    prompts = [torch.randint(1, 512, (n,), generator=gen, device="cuda").tolist()
               for n in (20, 37, 5)]
    reqs = [eng.add_request(f"r{i}", p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, (9, 3, 6)))]
    counted = (cuda_paged_latent_decode_attention if cfg.is_mla
               else cuda_paged_decode_attention)
    for _ in range(2):  # the capture, then a replay only
        last, ctx, tables = eng._decode_batch_arrays(
            [r for r in reqs if not r.done], eng.cfg.max_batch)
        budgets = torch.zeros(eng.cfg.max_batch, dtype=torch.int32)
        for i, r in enumerate(r for r in reqs if not r.done):
            budgets[i] = r.max_new_tokens - len(r.output)
        k, v = eng.k_cache.clone(), eng.v_cache.clone()
        eager, _, _ = llama.forward_decode_steps(
            eng.params, cfg, torch.from_numpy(last).cuda(), k, v,
            torch.from_numpy(tables).cuda(), torch.from_numpy(ctx).cuda(),
            budgets.cuda(), eng._burst)
        live = [r for r in reqs if not r.done]
        before = counted.launches
        before_fp8 = getattr(counted, "launches_fp8", 0)
        eng.step()
        assert counted.launches - before in (  # a replay (after the capture's warm-up)
            cfg.num_layers * eng._burst, 2 * cfg.num_layers * eng._burst)
        if fp8:
            assert counted.launches_fp8 - before_fp8 == counted.launches - before
        for i, r in enumerate(live):
            n = min(eng._burst, int(budgets[i]))
            assert r.output[-n:] == eager[i, :n].tolist()
        assert torch.equal(eng.k_cache.view(torch.uint8), k.view(torch.uint8))


# --------------------------------------------------------------------------
# fp8 pools: the cast, and what the fp8 arms refuse
# --------------------------------------------------------------------------

def test_fp8_cast_on_the_card_equals_the_cpu(gen):
    """The engine's cast into an fp8 pool gives the same bytes on the card
    as on the CPU (which the CPU tests hold against JAX): every bf16
    pattern, and fp32 values around every e4m3 midpoint and across the
    range."""
    words = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    finite = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(FP8).float()
    finite = finite[torch.isfinite(finite)].unique()
    mids = (finite[1:] + finite[:-1]) / 2
    sweep = torch.cat([mids, torch.nextafter(mids, torch.tensor(np.inf)),
                       torch.nextafter(mids, torch.tensor(-np.inf)),
                       torch.randn(100_000) * 10.0 ** (torch.rand(100_000) * 8 - 5),
                       torch.tensor([np.inf, -np.inf, np.nan, 0.0, -0.0, 464.0, -464.0])])
    for x in (words, sweep):
        cpu = to_kv_dtype(x, FP8).view(torch.uint8)
        card = to_kv_dtype(x.cuda(), FP8).view(torch.uint8).cpu()
        assert torch.equal(cpu, card)


def test_fp8_wrappers_launch_or_raise(gen, monkeypatch):
    """An fp8 call on the card reaches an fp8 kernel or raises; it never
    runs the plain version: shapes the kernels do not take, a K/V pair of
    two dtypes, a tail of another dtype than the pools, and a single KV
    head (as in JAX) are refused."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ops, "paged_attention", plain)
    monkeypatch.setattr(ops, "paged_ragged_attention", plain)
    k, v = pool(gen, 5, 2, 16, 128, FP8)
    kb, _ = pool(gen, 5, 2, 16, 128)
    table = torch.ones(1, 4, dtype=torch.int32, device="cuda")
    ctx = torch.tensor([3], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 4, 128, generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim"):
        cuda_paged_decode_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                                    v[..., :96].contiguous(), table, ctx)
    with pytest.raises(NotImplementedError, match="group"):
        cuda_paged_decode_attention(torch.cat([q] * 8, 1), k, v, table, ctx)
    with pytest.raises(NotImplementedError, match="group"):
        cuda_paged_prefill_attention(torch.cat([q] * 8, 1)[:, None], k, v, table, ctx, ctx + 1)
    starts = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="group"):
        cuda_paged_ragged_attention(torch.cat([q] * 8, 1), k, v, table, starts, ctx)
    with pytest.raises(NotImplementedError, match="one dtype"):
        cuda_paged_decode_attention(q, k, kb, table, ctx)
    with pytest.raises(NotImplementedError, match="bf16 q"):
        cuda_paged_decode_attention(q.float(), k, v, table, ctx)
    tail = k[:1, :, :8].transpose(1, 2).contiguous()  # [1, 8, kv_heads, 128] fp8
    tl = torch.tensor([2], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="pools' dtype"):
        cuda_paged_decode_attention(q, k, v, table, ctx, tail_k=tail.to(torch.bfloat16),
                                    tail_v=tail.to(torch.bfloat16), tail_lens=tl)
    with pytest.raises(ValueError, match="pools' dtype"):
        cuda_paged_decode_attention(q, kb, kb, table, ctx, tail_k=tail, tail_v=tail,
                                    tail_lens=tl)
    latent, _ = pool(gen, 5, 1, 16, 576, FP8)
    q16 = torch.randn(1, 16, 576, generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="fp8"):
        cuda_paged_decode_attention(q16, latent, None, table, ctx, shared_kv=True)
    with pytest.raises(ValueError, match="fp8"):
        cuda_paged_prefill_attention(q16[:, None], latent, None, table, ctx, ctx + 1,
                                     shared_kv=True)
    mqa, _ = pool(gen, 5, 1, 16, 128, FP8)
    q8 = torch.randn(1, 8, 128, generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="fp8"):
        cuda_paged_decode_attention(q8, mqa, mqa, table, ctx)
    # The taken shapes launch the fp8 kernels, tail included.
    before = cuda_paged_decode_attention.launches_fp8
    cuda_paged_decode_attention(q, k, v, table, ctx, tail_k=tail, tail_v=tail, tail_lens=tl)
    torch.cuda.synchronize()
    assert cuda_paged_decode_attention.launches_fp8 == before + 1


# --------------------------------------------------------------------------
# the ragged kernel's shared_kv (absorbed MLA) and decode-burst tail arms
# --------------------------------------------------------------------------

# (q_lens, ctx_lens) of the latent ragged mixes: 1-token rows take the
# latent decode tile, longer ones the latent prefill's 4-token wgmma tiles.
LATENT_RAGGED_MIXES = {
    # An empty row, 2- and 3-token rows (the smallest prefill rows), a
    # 1-token row at ctx 0 and chunks that straddle the 4-token tiles.
    "odd": ([1, 2, 3, 0, 1, 5, 33, 1], [0, 40, 41, 9, 4159, 100, 200, 63]),
    # A decode-only dispatch at contexts up to 4160.
    "decode_only": ([1] * 8, [1, 17, 300, 1023, 2048, 3001, 4100, 4159]),
    # Decode rows beside a chunk over a cached prefix.
    "mixed": ([1] * 8 + [300], [1, 64, 65, 500, 2047, 3333, 4159, 7, 2048]),
}


def ragged_rows(gen, q_lens, ctx_l, page, kv_heads, head_dim, dtype=torch.bfloat16, pad=3):
    """A pool holding each row's context and new tokens, its page table, row
    starts, context lengths, and the flat slots to make queries for: the
    rows' tokens and ``pad`` past the last row."""
    total_l = [c + n for c, n in zip(ctx_l, q_lens)]
    pages_per_seq = -(-max(total_l) // page) + 2
    num_pages = 1 + sum((n + page - 1) // page for n in total_l) + 3
    k, v = pool(gen, num_pages, kv_heads, page, head_dim, dtype)
    table = table_for(gen, total_l, page, pages_per_seq, num_pages)
    starts = torch.tensor([0] + list(q_lens), device="cuda").cumsum(0).to(torch.int32)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    return k, v, table, starts, ctx, sum(q_lens) + pad


def counts():
    fn = cuda_paged_ragged_attention
    return (fn.launches, fn.launches_fp8, fn.launches_shared_kv, fn.launches_tail)


def force_latent_ragged_splits(monkeypatch, splits, prefill_splits=None):
    """Plan ``splits`` CTAs a decode row and ``prefill_splits`` a prefill
    tile for the latent ragged kernel; None leaves that arm's planned count."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    planner = ops.latent_ragged_splits

    def forced(*args, **kwargs):
        planned = planner(*args, **kwargs)
        return (planned[0] if splits is None else splits,
                planned[1] if prefill_splits is None else prefill_splits)

    monkeypatch.setattr(ops, "latent_ragged_splits", forced)


@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("mix", sorted(LATENT_RAGGED_MIXES))
@pytest.mark.parametrize("splits", [1, 3, None])
def test_latent_ragged_matches_plain(gen, monkeypatch, width, page, window, sinks, mix,
                                     splits):
    """The ragged kernel's shared_kv arm (the latent pool is K and V, no V
    pool given), its decode rows split across 1, 3 or the planned number of
    CTAs; slots past the last row are zeros."""
    force_latent_ragged_splits(monkeypatch, splits)
    q_lens, ctx_l = LATENT_RAGGED_MIXES[mix]
    k, _, table, starts, ctx, slots = ragged_rows(gen, q_lens, ctx_l, page, 1, width)
    q = torch.randn(slots, 16, width, generator=gen, device="cuda").to(torch.bfloat16)
    before = counts()
    out = cuda_paged_ragged_attention(q, k, None, table, starts, ctx, sliding_window=window,
                                      sinks=sinks, shared_kv=True)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2] + 1, before[3])
    ref = paged_ragged_attention(q, k, None, table, starts, ctx, sliding_window=window,
                                 sinks=sinks, shared_kv=True)
    real = sum(q_lens)
    assert_close(out[:real], ref[:real])
    assert bool((out[real:] == 0).all())


def ragged_tail_mix(slots):
    """(q_lens, ctx_lens, tail_lens): 1-token rows with tails of 0, 1, 5, 8
    and every slot, one with no paged key, paged keys at and beside a
    64-key chunk edge, beside a 40-token prefill row (tail 0) and an empty
    row."""
    return ([1, 1, 1, 1, 1, 40, 0, 1, 1],
            [0, 1, 63, 64, 200, 100, 5, 4159, 17],
            [slots, 1, 0, min(5, slots), slots, 0, 0, min(8, slots), max(slots - 1, 0)])


@pytest.mark.parametrize("head_dim,group", GEOMETRIES)
@pytest.mark.parametrize("slots", [1, 8, 64])
@pytest.mark.parametrize("window,sinks", TAIL_WINDOWS)
@pytest.mark.parametrize("splits", [1, None])
@pytest.mark.parametrize("kv", KV_DTYPES, ids=["bf16", "fp8"])
def test_ragged_tail_matches_plain(gen, monkeypatch, head_dim, group, slots, window, sinks,
                                   splits, kv):
    """The GQA ragged kernel's tail arm: a 1-token row's last split folds
    its tail (of the pools' dtype); the prefill row beside it carries none."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    if splits is not None:
        monkeypatch.setattr(ops, "ragged_decode_splits", lambda *a, **kw: splits)
    kv_heads, page = 2, 16
    q_lens, ctx_l, tails = ragged_tail_mix(slots)
    k, v, table, starts, ctx, n = ragged_rows(gen, q_lens, ctx_l, page, kv_heads, head_dim, kv)
    shape = (len(q_lens), slots, kv_heads, head_dim)
    tail_k, tail_v = (to_kv_dtype(torch.randn(shape, generator=gen, device="cuda")
                                  .to(torch.bfloat16), kv) for _ in range(2))
    tl = torch.tensor(tails, dtype=torch.int32, device="cuda")
    q = torch.randn(n, kv_heads * group, head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    before = counts()
    out = cuda_paged_ragged_attention(q, k, v, table, starts, ctx, sliding_window=window,
                                      sinks=sinks, tail_k=tail_k, tail_v=tail_v, tail_lens=tl)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + (kv == FP8), before[2], before[3] + 1)
    ref = paged_ragged_attention(q, k, v, table, starts, ctx, sliding_window=window,
                                 sinks=sinks, tail_k=tail_k, tail_v=tail_v, tail_lens=tl)
    real = sum(q_lens)
    assert_close(out[:real], ref[:real])
    assert bool((out[real:] == 0).all())


@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("slots", [1, 8, 64])
@pytest.mark.parametrize("window,sinks", TAIL_WINDOWS)
@pytest.mark.parametrize("splits", [1, None])
def test_latent_ragged_tail_matches_plain(gen, monkeypatch, width, slots, window, sinks,
                                          splits):
    """The latent ragged kernel's tail arm: the latent tail is K and V, the
    last split of a 1-token row folds it (one or two 32-key chunks)."""
    force_latent_ragged_splits(monkeypatch, splits)
    page = 16
    q_lens, ctx_l, tails = ragged_tail_mix(slots)
    k, _, table, starts, ctx, n = ragged_rows(gen, q_lens, ctx_l, page, 1, width)
    tail_k = torch.randn(len(q_lens), slots, 1, width, generator=gen,
                         device="cuda").to(torch.bfloat16)
    tl = torch.tensor(tails, dtype=torch.int32, device="cuda")
    q = torch.randn(n, 16, width, generator=gen, device="cuda").to(torch.bfloat16)
    before = counts()
    out = cuda_paged_ragged_attention(q, k, None, table, starts, ctx, sliding_window=window,
                                      sinks=sinks, shared_kv=True, tail_k=tail_k, tail_lens=tl)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2] + 1, before[3] + 1)
    ref = paged_ragged_attention(q, k, None, table, starts, ctx, sliding_window=window,
                                 sinks=sinks, shared_kv=True, tail_k=tail_k, tail_lens=tl)
    real = sum(q_lens)
    assert_close(out[:real], ref[:real])
    assert bool((out[real:] == 0).all())


def test_ragged_shared_kv_refuses_what_the_kernel_does_not_take(gen):
    latent, _ = pool(gen, 5, 1, 16, 576)
    table = torch.ones(1, 4, dtype=torch.int32, device="cuda")
    starts = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    ctx = torch.tensor([3], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 16, 576, generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="fp8"):
        cuda_paged_ragged_attention(q, to_kv_dtype(latent, FP8), None, table, starts, ctx,
                                    shared_kv=True)
    with pytest.raises(NotImplementedError, match="built for"):
        cuda_paged_ragged_attention(q[:, :8].contiguous(), latent, None, table, starts, ctx,
                                    shared_kv=True)
    with pytest.raises(NotImplementedError, match="bf16"):
        cuda_paged_ragged_attention(q.float(), latent, None, table, starts, ctx,
                                    shared_kv=True)
    with pytest.raises(ValueError, match="tail_k must be"):
        cuda_paged_ragged_attention(q, latent, None, table, starts, ctx, shared_kv=True,
                                    tail_k=torch.zeros(2, 8, 1, 576, dtype=torch.bfloat16,
                                                       device="cuda"), tail_lens=ctx)


# --------------------------------------------------------------------------
# the latent ragged kernel's split prefill rows, the in-kernel tile lookup
# and the plan of a dispatch
# --------------------------------------------------------------------------

# (q_lens, ctx_lens): the 64-token chunk over 4096 cached latents alone and
# beside one (q65) and eight (q72) decode rows at 4159, and the odd mix.
LATENT_SPLIT_MIXES = {
    "chunk64": ([64], [4096]),
    "q65": ([1, 64], [4159, 4096]),
    "q72": ([1] * 8 + [64], [4159] * 8 + [4096]),
    "odd": LATENT_RAGGED_MIXES["odd"],
}


@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("mix", sorted(LATENT_SPLIT_MIXES))
@pytest.mark.parametrize("splits,prefill_splits", [(None, None), (3, 2), (1, 5), (2, 1)])
def test_latent_ragged_split_prefill_matches_plain(gen, monkeypatch, width, window, sinks, mix,
                                                   splits, prefill_splits):
    """The latent ragged kernel's prefill tiles split across CTAs (as
    planned from shapes, which splits the 64-token chunk's tiles alone and
    beside decode rows, or forced) and merged by the combine pass into
    their flat slots, beside split or unsplit decode rows."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    force_latent_ragged_splits(monkeypatch, splits, prefill_splits)
    q_lens, ctx_l = LATENT_SPLIT_MIXES[mix]
    k, _, table, starts, ctx, slots = ragged_rows(gen, q_lens, ctx_l, 16, 1, width)
    q = torch.randn(slots, 16, width, generator=gen, device="cuda").to(torch.bfloat16)
    plan = ops.plan_ragged_attention(slots, 16, k, table, shared_kv=True)
    if mix != "odd" and prefill_splits is None:
        assert plan.prefill_splits > 1  # split from shapes only
    out = cuda_paged_ragged_attention(q, k, None, table, starts, ctx, sliding_window=window,
                                      sinks=sinks, shared_kv=True)
    torch.cuda.synchronize()
    ref = paged_ragged_attention(q, k, None, table, starts, ctx, sliding_window=window,
                                 sinks=sinks, shared_kv=True)
    real = sum(q_lens)
    assert_close(out[:real], ref[:real])
    assert bool((out[real:] == 0).all())


@pytest.mark.parametrize("rows", [1, 9, 40])
@pytest.mark.parametrize("arm", ["bf16", "fp8", "latent"])
def test_ragged_kernels_find_rows_in_the_kernel(gen, rows, arm):
    """Both ragged kernels without a tile table, at 1 row, at the engine's
    max_batch + 1 (8 rows + a chunk) and at 40 (the in-kernel lookup
    counting rows in two groups of 32): decode rows, 2- and 3-token rows, an
    empty row and a chunk, with padded slots. Prefill rows sit at row 0 and
    at rows 1, 4, 8 and 16 (2- and 3-token rows are prefill rows of the
    latent kernel, 3 tokens and more of the GQA one at group 8), so each
    step of the lookup's prefix sum carries tiles."""
    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig

    assert EngineConfig.max_batch + 1 == 9
    pattern = [5, 2, 1, 0, 3, 1, 1, 1]
    q_lens = [90] if rows == 1 else [pattern[i % 8] for i in range(rows - 1)] + [90]
    ctx_l = [(37 * r) % 700 for r in range(rows)]
    latent = arm == "latent"
    width, heads = (576, 1) if latent else (128, 2)
    k, v, table, starts, ctx, slots = ragged_rows(gen, q_lens, ctx_l, 16, heads, width,
                                                  FP8 if arm == "fp8" else torch.bfloat16)
    q = torch.randn(slots, 16, width, generator=gen, device="cuda").to(torch.bfloat16)
    out = cuda_paged_ragged_attention(q, k, None if latent else v, table, starts, ctx,
                                      shared_kv=latent)
    torch.cuda.synchronize()
    ref = paged_ragged_attention(q, k, None if latent else v, table, starts, ctx,
                                 shared_kv=latent)
    real = sum(q_lens)
    assert_close(out[:real], ref[:real])
    assert bool((out[real:] == 0).all())


@pytest.mark.parametrize("arm", ["bf16", "latent"])
@pytest.mark.parametrize("mix", ["q72", "odd"])
def test_ragged_plan_reused_across_layers_is_identical(gen, arm, mix):
    """One plan (and its workspace) for three "layers" of the same shapes,
    launched in order on one stream, gives exactly the outputs of calls that
    plan for themselves."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    q_lens, ctx_l = LATENT_SPLIT_MIXES[mix]
    latent = arm == "latent"
    width, heads = (576, 1) if latent else (128, 2)
    layers = [ragged_rows(gen, q_lens, ctx_l, 16, heads, width) for _ in range(3)]
    table, starts, ctx, slots = layers[0][2:]
    qs = [torch.randn(slots, 16, width, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in layers]
    plan = ops.plan_ragged_attention(slots, 16, layers[0][0], table, shared_kv=latent)
    if latent:
        assert plan.workspace is not None  # at least one arm splits
    planned = [cuda_paged_ragged_attention(q, k, None if latent else v, table, starts, ctx,
                                           shared_kv=latent, plan=plan)
               for q, (k, v, *_) in zip(qs, layers)]
    alone = [cuda_paged_ragged_attention(q, k, None if latent else v, table, starts, ctx,
                                         shared_kv=latent)
             for q, (k, v, *_) in zip(qs, layers)]
    torch.cuda.synchronize()
    for a, b in zip(planned, alone):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="plan was made for"):
        cuda_paged_ragged_attention(qs[0][:-1].contiguous(), layers[0][0],
                                    None if latent else layers[0][1], table, starts, ctx,
                                    shared_kv=latent, plan=plan)


@pytest.mark.parametrize("model", ["gqa", "mla"])
def test_forward_ragged_plans_once_a_dispatch(gen, monkeypatch, model):
    """``forward_ragged`` makes one ragged plan a dispatch and hands that
    plan to every layer's launch; its logits and pools equal a run whose
    layers each plan for themselves (page 0 excepted: the padded slots
    all scatter to that garbage page, in no fixed order). Decode rows
    beside a chunk and an empty row, so the GQA decode arm and both latent
    arms run split."""
    from llmd_kv_cache_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**BURST_MODELS[model])
    params = llama.init_params(cfg, seed=0, device="cuda")
    q_lens, ctx_l = [1, 1, 0, 1, 40], [200, 17, 0, 63, 150]
    num_pages, pages_per_seq = 80, 16
    table = table_for(gen, [c + n for c, n in zip(ctx_l, q_lens)], cfg.page_size,
                      pages_per_seq, num_pages)
    starts = torch.tensor([0] + q_lens, device="cuda").cumsum(0).to(torch.int32)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (1, sum(q_lens) + 3), generator=gen, device="cuda")
    k, v = llama.init_kv_cache(cfg, num_pages, device="cuda")
    k.copy_(torch.randn(k.shape, generator=gen, device="cuda"))
    made, given = [], []
    planner, launch = llama.plan_ragged_attention, llama.cuda_paged_ragged_attention

    def planning(*args, **kwargs):
        made.append(planner(*args, **kwargs))
        return made[-1]

    def launching(*args, plan=None, **kwargs):
        given.append(plan)
        return launch(*args, plan=plan, **kwargs)

    monkeypatch.setattr(llama, "plan_ragged_attention", planning)
    monkeypatch.setattr(llama, "cuda_paged_ragged_attention", launching)
    planned = llama.forward_ragged(params, cfg, toks, k.clone(), v.clone(), table, starts, ctx)
    assert len(made) == 1 and len(given) == cfg.num_layers
    assert all(p is made[0] for p in given)
    assert made[0].splits > 1 and made[0].prefill_splits == (4 if cfg.is_mla else 1)
    monkeypatch.setattr(llama, "cuda_paged_ragged_attention",
                        lambda *args, plan=None, **kwargs: launch(*args, **kwargs))
    alone = llama.forward_ragged(params, cfg, toks, k.clone(), v.clone(), table, starts, ctx)
    torch.cuda.synchronize()
    assert torch.equal(planned[0], alone[0])
    for a, b in zip(planned[1:], alone[1:]):
        assert torch.equal(a[:, 1:], b[:, 1:])


def test_library_tile_slots_equal_the_plain_mirror(gen):
    """The kernels' grid rule for their prefill tile slots, as the library
    reports it (``llmd_ragged_tile_slots``), equals ``ragged_tile_slots``,
    the plain mirror the CPU tests replay a launch with, at the latent
    tile and every GQA group's."""
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    lib = ops.load_library()
    tiles = [(lib.llmd_latent_prefill_tile_tokens(), ops.LATENT_RAGGED_DECODE_TOKENS)] + [
        (lib.llmd_ragged_tile_tokens(g), lib.llmd_ragged_decode_tokens(g)) for g in (1, 2, 4, 8)]
    for tile, dec in tiles:
        for total_q in (1, 2, 3, 9, 17, 64, 72, 2056, 4160):
            for rows in (1, 3, 9, 40):
                assert (lib.llmd_ragged_tile_slots(total_q, rows, tile, dec)
                        == ops.ragged_tile_slots(total_q, rows, tile, dec)), (total_q, rows, tile)
