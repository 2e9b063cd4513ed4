"""Work planning and the split-KV merge of the redesigned kernels, on the CPU.

- The planners in ``ops.cuda_paged_attention`` (``plan_splits``,
  ``decode_splits``, ``latent_decode_splits``, ``latent_prefill_splits``,
  ``ragged_decode_splits``, ``latent_ragged_splits``,
  ``ragged_tile_slots`` and ``plan_ragged_attention``) read shapes only:
  split counts are at least 1 and never exceed the key chunks a row can
  hold, the latent ragged kernel's two arms share one wave of the SMs
  where they fit in one, and the ragged kernels' plan, replayed here as
  the kernels assign CTAs (each prefill CTA finding its row and tile from
  ``row_starts`` through ``ragged_tile_lookup``, the plain mirror of the
  kernels' ``ragged_tile``; the decode arm's rows of at most 16 / group
  tokens), covers every flat token exactly once, every (token, key) pair
  of a prefill row exactly once across its key splits, and gives empty
  rows nothing, as does the prefill kernel's grid of query tiles. The GQA
  decode's split count and a ragged dispatch's whole plan are computed on
  ``meta`` tensors, which hold no values: the plan needs no device value,
  so planning costs no host sync.
- ``merge_split_states`` (the plain mirror of the kernels' combine pass)
  over ``paged_attention_split_states`` (the states of key splits) matches
  the unsplit plain attention and the JAX Pallas kernels run in interpret
  mode, at fp32 within 1e-5: the ragged kernel's rows, the latent ragged
  kernel's prefill rows cut into 4-token tiles whose keys are split as its
  CTAs take them (with SWA and sinks), the GQA decode with a
  burst tail folded by the last split only, and the latent (shared-KV)
  decode (also cut as its kernel's CTA parts take its 32-key chunks, the
  tail to the last one) and prefill, with an empty split, a sliding window that excludes
  whole splits, sinks, and a row with no key (zeros).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.ops.pallas_paged_attention import (
    pallas_paged_decode_attention,
    pallas_paged_prefill_attention,
    pallas_paged_ragged_attention,
)
from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops
from llmd_kv_cache_tpu_torch.ops.paged_attention import (
    merge_split_states,
    paged_attention,
    paged_attention_split_states,
    paged_ragged_attention,
)

from test_torch_attention import make_table, t

ATOL = RTOL = 1e-5  # fp32 on every side: only summation order differs

H100_SMS = 132
TILE_TOKENS = {1: 128, 2: 64, 4: 32, 8: 16}  # the ragged prefill tile, by group
DECODE_TOKENS = {1: 16, 2: 8, 4: 4, 8: 2}  # the ragged decode arm's row limit


# --------------------------------------------------------------------------
# planning
# --------------------------------------------------------------------------

@pytest.mark.parametrize("units,max_chunks,slots,expected", [
    (1, 68, 132, 68),  # one stream: as many splits as chunks allow
    (16, 68, 132, 8),  # a 64-token warm chunk's 16 tiles fill 128 SMs
    (64, 65, 264, 4),  # 8 decode rows x 8 kv heads, two CTAs an SM
    (512, 68, 132, 1),  # tiles enough to fill the card: no split
    (5, 0, 132, 1),  # a page table with no key chunk still plans one CTA
    (0, 10, 132, 10),
])
def test_plan_splits(units, max_chunks, slots, expected):
    n = ops.plan_splits(units, max_chunks, slots)
    assert n == expected
    assert n >= 1 and (n == 1 or n <= max_chunks)
    assert n == 1 or units * n <= slots


@pytest.mark.parametrize("batch,q_seq,chunk_keys,expected", [
    (1, 2048, 64, 1), (1, 64, 64, 8), (1, 64, 32, 8), (1, 1, 64, 68), (1, 31, 64, 16),
    (2, 75, 64, 3), (40, 64, 64, 1),
])
def test_latent_prefill_splits(batch, q_seq, chunk_keys, expected):
    pages_per_seq, page_size, tile_tokens = 272, 16, 4
    n = ops.latent_prefill_splits(batch, q_seq, pages_per_seq, page_size, chunk_keys,
                                  tile_tokens, H100_SMS)
    assert n == expected
    assert 1 <= n <= -(-pages_per_seq * page_size // chunk_keys)


# (batch, pages_per_seq, page_size, chunk keys, expected splits)
LATENT_DECODE_PLANS = [
    (8, 272, 16, 32, 16),  # the MLA slice's decode: 8 rows, one CTA an SM
    (1, 272, 16, 32, 132),  # one row: a split an SM
    (1, 10, 16, 32, 5),  # 160 keys: 5 chunks, fewer than the SMs allow
    (132, 272, 16, 32, 1),  # a row an SM: no split
    (200, 20, 16, 32, 1),
    (3, 272, 4, 32, 34),  # page 4: 34 chunks a row
    (16, 272, 16, 64, 8),
]


def _no_library():
    raise AssertionError("a planner loaded the kernel library")


@pytest.mark.parametrize("batch,pages_per_seq,page_size,chunk_keys,expected",
                         LATENT_DECODE_PLANS)
def test_latent_decode_splits(monkeypatch, batch, pages_per_seq, page_size, chunk_keys,
                              expected):
    """Shapes only, and no library load (the chunk keys and the CTA slots
    come in, the kernel's one CTA an SM on the H100's SMs): at least 1,
    never more than the chunks the page table can hold, one wave of the
    slots."""
    monkeypatch.setattr(ops, "load_library", _no_library)
    n = ops.latent_decode_splits(batch, pages_per_seq, page_size, chunk_keys, H100_SMS)
    assert n == expected
    assert 1 <= n <= max(1, -(-pages_per_seq * page_size // chunk_keys))
    assert n == 1 or batch * n <= H100_SMS


LATENT_CHUNK = 32  # the latent decode kernel's keys a chunk


def latent_decode_runs(n_chunks, splits, tail_chunks):
    """The chunks each (split, team) CTA part of the latent decode kernel
    streams, as the kernel assigns them: split s takes the s-th run of
    ceil(n_chunks / splits) chunks, its first team the first ceil(half) of
    the run and its second team the rest, the last split's second team then
    the tail's chunks (numbered on from n_chunks)."""
    per = -(-n_chunks // splits)
    runs = {}
    for s in range(splits):
        b = min(s * per, n_chunks)
        e = min(b + per, n_chunks)
        h = (e - b + 1) // 2
        tail = range(n_chunks, n_chunks + tail_chunks) if s == splits - 1 else range(0)
        runs[s, 0] = list(range(b, b + h))
        runs[s, 1] = list(range(b + h, e)) + list(tail)
    return runs


def assert_runs_cover(runs, n_chunks, tail_chunks, splits):
    """Every paged chunk and every tail chunk is streamed by exactly one
    team of one split, a team's chunks are consecutive, and the tail only
    by the last split's second team."""
    seen = sorted(c for chunks in runs.values() for c in chunks)
    assert seen == list(range(n_chunks + tail_chunks))
    for (s, team), chunks in runs.items():
        assert chunks == list(range(chunks[0], chunks[0] + len(chunks))) if chunks else True
        if any(c >= n_chunks for c in chunks):
            assert (s, team) == (splits - 1, 1)


# (batch, kv_heads, pages_per_seq, page_size, expected splits)
DECODE_PLANS = [
    (8, 8, 272, 16, 4),  # the serving decode: 64 (row, kv head)s, two CTAs an SM
    (16, 8, 272, 16, 2),
    (1, 1, 272, 16, 68),  # one stream: as many splits as its chunks
    (8, 8, 4, 16, 1),  # a page table of one chunk
    (33, 8, 272, 16, 1),  # enough (row, kv head)s to fill the card
    (3, 2, 3, 4, 1),  # 12 keys: one chunk
    (2, 2, 100, 4, 7),  # 400 keys: 7 chunks, fewer than the slots allow
]


@pytest.mark.parametrize("batch,kv_heads,pages_per_seq,page_size,expected", DECODE_PLANS)
def test_decode_splits_from_shapes_only(batch, kv_heads, pages_per_seq, page_size, expected):
    """On meta tensors (shapes, no values): at least 1, never more than the
    64-key chunks a row's page table can hold."""
    group, head_dim = 2, 128
    q = torch.empty(batch, kv_heads * group, head_dim, dtype=torch.bfloat16, device="meta")
    k_cache = torch.empty(5, kv_heads, page_size, head_dim, dtype=torch.bfloat16,
                          device="meta")
    table = torch.empty(batch, pages_per_seq, dtype=torch.int32, device="meta")
    n = ops.decode_splits(q, k_cache, table, 64, H100_SMS)
    assert n == expected
    assert 1 <= n <= max(1, -(-pages_per_seq * page_size // 64))
    assert n == 1 or batch * kv_heads * n <= H100_SMS * ops.DECODE_CTAS_PER_SM


@pytest.mark.parametrize("rows,kv_heads,expected", [(8, 8, 4), (9, 8, 3), (1, 1, 65),
                                                    (140, 2, 1), (33, 8, 1)])
def test_ragged_decode_splits(rows, kv_heads, expected):
    n = ops.ragged_decode_splits(rows, kv_heads, 260, 16, 64, H100_SMS)
    assert n == expected
    assert 1 <= n <= 65


PAGE, CHUNK_KEYS = 16, 64  # the replay's page size and the prefill tiles' keys a chunk


def prefill_tile_chunks(ctx, t0, n_tok, tile_tokens, pages_per_seq, page=PAGE,
                        ck=CHUNK_KEYS, window=None, sinks=0):
    """The key positions each key chunk of one prefill tile streams, as the
    prefill tiles stream them (``make_stream`` and ``key_position`` in
    ``csrc/attention_common.cuh``): pages up to the tile's last query
    (causal), from its first query's window page, the sink pages first;
    -1 for a key past the row. Returns the positions [chunks, ck]."""
    q_start, total = ctx + t0, ctx + n_tok
    max_key = max(min(q_start + tile_tokens, total), 0)
    num_pages = -(-max_key // page)
    first = min(max(q_start - window + 1, 0) // page if window is not None else 0, num_pages)
    sink_pages = min(-(-sinks // page), num_pages) if sinks else 0
    first = max(first, sink_pages)
    iters = sink_pages + num_pages - first

    n_chunks = -(-iters * page // ck)
    v = np.arange(n_chunks * ck).reshape(n_chunks, ck)  # virtual keys of the stream
    vp = v // page
    pidx = np.minimum(np.where(vp < sink_pages, vp, first + vp - sink_pages), pages_per_seq - 1)
    pos = pidx * page + v % page
    return np.where((vp < iters) & (pos < total), pos, -1)


def split_runs(n_chunks, splits):
    """The chunks each of ``splits`` CTAs of a tile streams: split s the
    s-th run of ceil(n_chunks / splits) (``latent_prefill_wg``)."""
    per = -(-n_chunks // splits)
    return [range(min(s * per, n_chunks), min(s * per + per, n_chunks)) for s in range(splits)]


def replay_ragged_plan(q_lens, tile, dec, prefill_splits=1, ctx_l=None, pages_per_seq=300):
    """The ragged kernels' plan replayed as they assign CTAs: prefill CTA x
    serves split x % prefill_splits of tile slot x // prefill_splits, its
    row and tile from ``ragged_tile_lookup`` over the clamped row lengths
    (a slot past the last tile exits), and streams its split's run of the
    tile's key chunks; a decode row's tokens all sit in its decode tile.
    Returns the cover count of each flat slot (three padded slots
    included), the real tokens, and each prefill row's (token, key) cover
    counts {row: [tokens, keys]} over the keys its tokens may attend."""
    ctx_l = ctx_l or [37 * (r + 1) for r in range(len(q_lens))]
    starts = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    total_q = int(starts[-1]) + 3  # three padded slots
    covered = np.zeros(total_q, np.int64)
    pairs = {}
    slots = ops.ragged_tile_slots(total_q, len(q_lens), tile, dec)
    for x in range(slots * prefill_splits):
        slot, split = divmod(x, prefill_splits)
        found = ops.ragged_tile_lookup(starts.tolist(), total_q, tile, dec, slot)
        if found is None:
            continue
        r, start, n, t0 = found
        assert n > dec, "a decode or empty row owns a prefill tile"
        assert t0 % tile == 0 and 0 <= t0 < n
        if split == 0:
            covered[start + t0:start + min(t0 + tile, n)] += 1
        counts = pairs.setdefault(r, np.zeros((n, ctx_l[r] + n), np.int64))
        chunks = prefill_tile_chunks(ctx_l[r], t0, n, tile, pages_per_seq)
        keys = chunks[list(split_runs(len(chunks), prefill_splits)[split])].ravel()
        keys = keys[keys >= 0]
        tokens = np.arange(t0, min(t0 + tile, n))
        seen = keys[None, :] <= (ctx_l[r] + tokens)[:, None]  # causal
        np.add.at(counts, (np.repeat(tokens, keys.size), np.tile(keys, tokens.size)),
                  seen.ravel())
    for r, n in enumerate(q_lens):
        if 1 <= n <= dec:
            covered[starts[r]:starts[r] + n] += 1
    return covered, int(starts[-1]), pairs


RAGGED_PLAN_MIXES = {
    "decode": [1] * 8,
    "mixed": [1] * 8 + [2048],
    "empty rows": [0, 1, 0, 0, 300, 0],
    "boundary": [2, 3, 4, 5, 8, 9, 16, 17, 1, 128, 129],
    "straddle": [1, 7, 0, 100, 33, 1, 70],
    # A 64-token chunk beside 1 to 8 decode rows (the q65-q72 dispatches).
    "q65-q72": [1] * 3 + [64] + [1] * 5,
}
# The tile (tokens, decode-row limit) of each ragged arm: the GQA prefill
# tile by group, and the latent prefill tile (4 tokens x 16 heads), whose
# decode arm takes only 1-token rows.
RAGGED_TILES = {**{f"g{g}": (TILE_TOKENS[g], DECODE_TOKENS[g]) for g in TILE_TOKENS},
                "latent": (4, 1)}


@pytest.mark.parametrize("arm", sorted(RAGGED_TILES))
@pytest.mark.parametrize("mix", sorted(RAGGED_PLAN_MIXES))
def test_ragged_plan_covers_every_token_once(arm, mix):
    q_lens = RAGGED_PLAN_MIXES[mix]
    tile, dec = RAGGED_TILES[arm]
    ctx_l = [64 * r for r in range(len(q_lens))]
    prefill_splits = 3 if arm == "latent" else 1
    covered, real, pairs = replay_ragged_plan(q_lens, tile, dec, prefill_splits, ctx_l)
    assert (covered[:real] == 1).all()
    assert (covered[real:] == 0).all()  # padded slots: zeroed, never computed
    # Every (token, key) pair of a prefill row, key <= the token's position,
    # exactly once across the tile's splits, and no other pair.
    assert sorted(pairs) == [r for r, n in enumerate(q_lens) if n > dec]
    for r, counts in pairs.items():
        n = q_lens[r]
        causal = np.arange(ctx_l[r] + n)[None, :] <= ctx_l[r] + np.arange(n)[:, None]
        np.testing.assert_array_equal(counts, causal.astype(np.int64))


def test_ragged_tile_lookup_matches_prefix_sums():
    """The mirror against the plain prefix-sum form of the same lookup (each
    row's tiles cumulated, a tile's row the first whose sum passes it), on
    random row lengths, with clamped malformed starts, and past the tiles."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        rows = int(rng.integers(1, 40))
        starts = np.concatenate([[0], np.cumsum(rng.integers(0, 9, rows))]).tolist()
        total_q = int(starts[-1]) + int(rng.integers(0, 4))
        if rng.random() < 0.2:  # malformed: past the flat axis, decreasing
            starts[int(rng.integers(0, rows + 1))] = int(rng.integers(-5, total_q + 9))
        tile, dec = (4, 1) if rng.random() < 0.5 else (16, 2)
        clamped = []
        for r in range(rows):
            s0 = min(max(starts[r], 0), total_q)
            clamped.append((s0, min(max(starts[r + 1], s0), total_q) - s0))
        tiles = [-(-n // tile) if n > dec else 0 for _, n in clamped]
        ends = np.cumsum(tiles)
        total = int(ends[-1])
        assert total <= ops.ragged_tile_slots(total_q, rows, tile, dec) or any(
            starts[r + 1] < starts[r] for r in range(rows))
        for slot in range(total + 2):
            got = ops.ragged_tile_lookup(starts, total_q, tile, dec, slot)
            t = total - 1 - slot
            if t < 0:
                assert got is None
                continue
            r = int(np.searchsorted(ends, t, side="right"))
            first = int(ends[r - 1]) if r else 0
            assert got == (r, clamped[r][0], clamped[r][1], (t - first) * tile)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("q_seq", [1, 15, 16, 17, 75, 128, 129, 2048])
def test_prefill_grid_covers_every_token_once(group, q_seq):
    """The prefill kernel's grid replayed: (ceil(q_seq / QT), kv_heads,
    batch) CTAs, CTA x taking query tile ceil(q_seq / QT) - 1 - x (the
    last first) of QT = 128 / group tokens, clipped to q_seq, covers each
    token of each row exactly once."""
    tile, batch, kv_heads = TILE_TOKENS[group], 2, 3
    n_tiles = -(-q_seq // tile)
    covered = np.zeros((batch, kv_heads, q_seq), np.int64)
    first = []
    for b in range(batch):
        for h in range(kv_heads):
            for x in range(n_tiles):
                t0 = (n_tiles - 1 - x) * tile
                covered[b, h, t0:min(t0 + tile, q_seq)] += 1
                if x == 0:
                    first.append(t0)
    assert (covered == 1).all()
    assert all(t0 + tile >= q_seq for t0 in first)  # CTA 0 takes the last tile


# (q_lens, ctx_lens) of the latent ragged kernel's timed dispatches and the
# planned (splits, prefill_splits) on the H100's 132 SMs (one CTA an SM),
# 272 pages of 16 (32-key decode chunks, 64-key prefill chunks).
LATENT_RAGGED_PLANS = {
    "decode8": ([1] * 8, (16, 1)),
    "decode3": ([1] * 3, (44, 1)),
    "chunk64": ([64], (1, 8)),  # the standalone latent prefill's split
    "q65": ([1] + [64], (20, 7)),
    "q72": ([1] * 8 + [64], (6, 5)),
    "chunk2048": ([2048], (1, 1)),
    "mixed": ([1] * 8 + [2048], (14, 1)),  # the grid before the prefill split
}


@pytest.mark.parametrize("name", sorted(LATENT_RAGGED_PLANS))
def test_latent_ragged_splits_share_one_wave(name):
    """Both arms' splits from shapes only: the decode rows and the chunk's
    tiles (as the engine sends them) fit one wave of the SMs whenever the
    tiles alone do, a chunk that fills the card runs unsplit beside the
    decode rows' own plan, and every split respects its arm's key chunks."""
    q_lens, expected = LATENT_RAGGED_PLANS[name]
    rows, total_q = len(q_lens), sum(q_lens)
    pages_per_seq, page = 272, 16
    got = ops.latent_ragged_splits(rows, total_q, pages_per_seq, page, 32, 64, 4, H100_SMS)
    assert got == expected
    splits, prefill_splits = got
    assert 1 <= splits <= pages_per_seq * page // 32
    assert 1 <= prefill_splits <= pages_per_seq * page // 64
    decode_rows = sum(1 for n in q_lens if n == 1)
    tiles = sum(-(-n // 4) for n in q_lens if n > 1)
    if tiles < H100_SMS:
        assert decode_rows * splits + tiles * prefill_splits <= H100_SMS


class _FakeLibrary:
    """The kernel library's shape queries at the built kernels' values (no
    library is loaded on the CPU): tile and chunk sizes, workspace bytes."""

    @staticmethod
    def llmd_latent_prefill_tile_tokens(q_heads):
        return 64 // q_heads

    @staticmethod
    def llmd_latent_decode_chunk_keys():
        return 32

    @staticmethod
    def llmd_latent_prefill_chunk_keys(head_dim):
        return 64 if head_dim == 576 else 32

    @staticmethod
    def llmd_latent_decode_ctas_per_sm():
        return 1

    @staticmethod
    def llmd_latent_ragged_workspace_bytes(total_q, rows, head_dim, splits, prefill_splits):
        slots = ops.ragged_tile_slots(total_q, rows, 4, 1)
        return 4 * (head_dim + 2) * ((rows * splits * 16 if splits > 1 else 0)
                                     + (slots * prefill_splits * 64 if prefill_splits > 1 else 0))

    @staticmethod
    def llmd_decode_chunk_keys():
        return 64

    @staticmethod
    def llmd_decode_workspace_bytes(rows, kv_heads, head_dim, splits):
        return 0 if splits <= 1 else rows * kv_heads * splits * 16 * (head_dim + 2) * 4


@pytest.mark.parametrize("shared_kv,q_lens,q_heads,kv_heads,head_dim", [
    (True, [1] * 8 + [64], 16, 1, 576),
    (True, [64], 16, 1, 640),
    (True, [1] * 8, 16, 1, 576),
    (False, [1] * 8 + [2048], 16, 8, 128),
    (False, [1] * 3, 8, 1, 64),
])
def test_ragged_plan_needs_no_device_value(monkeypatch, shared_kv, q_lens, q_heads, kv_heads,
                                           head_dim):
    """On meta tensors (no values) a ragged dispatch's whole plan still
    computes: both arms' splits and the workspace, with the library's
    shape queries at the built kernels' values. It reads no length on the
    host (it never sees ``row_starts``)."""
    monkeypatch.setattr(ops, "load_library", lambda: _FakeLibrary)
    monkeypatch.setattr(ops, "_sm_count", lambda index: H100_SMS)
    rows, total_q = len(q_lens), sum(q_lens)
    k_cache = torch.empty(300, kv_heads, 16, head_dim, dtype=torch.bfloat16, device="meta")
    table = torch.empty(rows, 272, dtype=torch.int32, device="meta")
    plan = ops.plan_ragged_attention(total_q, q_heads, k_cache, table, shared_kv=shared_kv)
    if shared_kv:
        assert (plan.splits, plan.prefill_splits) == ops.latent_ragged_splits(
            rows, total_q, 272, 16, 32, _FakeLibrary.llmd_latent_prefill_chunk_keys(head_dim),
            4, H100_SMS)
    else:
        assert plan.splits == ops.ragged_decode_splits(rows, kv_heads, 272, 16, 64, H100_SMS)
        assert plan.prefill_splits == 1
    if plan.splits > 1 or plan.prefill_splits > 1:
        assert plan.workspace.device.type == "meta" and plan.workspace.numel() > 0
    else:
        assert plan.workspace is None
    assert plan.key[:3] == (rows, total_q, q_heads)


# --------------------------------------------------------------------------
# the split-KV merge against the unsplit plain attention and Pallas
# --------------------------------------------------------------------------

def even_bounds(totals, splits, extra_empty=True):
    """Each row's keys [0, total) cut into `splits` near-equal runs, plus an
    empty split past the end."""
    rows = []
    for n in totals:
        cuts = [round(n * i / splits) for i in range(splits + 1)]
        rows.append(cuts + ([n + 8] if extra_empty else []))
    return torch.tensor(rows, dtype=torch.int64)


def merged(q, k, v, table, positions, totals, bounds, window=None, sinks=None):
    return merge_split_states(*paged_attention_split_states(
        q, k, v, table, positions, totals, bounds, sliding_window=window,
        attention_sinks=sinks if window is not None else None))


RAGGED_MERGE_CASES = [
    pytest.param([1, 1, 1, 1], [7, 30, 61, 2], 2, None, None, 3, id="decode-g2-3splits"),
    pytest.param([1, 1, 1, 1], [7, 30, 61, 2], 2, 6, 3, 4, id="decode-g2-swa-sinks"),
    pytest.param([1, 1, 2, 5], [50, 3, 40, 20], 8, 5, None, 5, id="g8-swa-whole-splits-out"),
    pytest.param([2, 1, 3, 4], [0, 44, 9, 17], 4, None, None, 2, id="g4-multi-token-rows"),
]


@pytest.mark.parametrize("q_lens,ctx_l,group,window,sinks,splits", RAGGED_MERGE_CASES)
def test_ragged_split_merge_matches_unsplit_and_pallas(q_lens, ctx_l, group, window, sinks,
                                                       splits):
    """Rows of the ragged kernel's decode arm, their keys split: merged per
    row, they match paged_ragged_attention and the Pallas ragged kernel."""
    rng = np.random.default_rng(sum(q_lens) + group)
    kv_heads, head_dim, page, pages_per_seq, total_q = 2, 8, 4, 18, 16
    rows = len(q_lens)
    num_pages = 1 + rows * pages_per_seq
    shape = (num_pages, kv_heads, page, head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    table = rng.permutation(np.arange(1, num_pages)).reshape(rows, pages_per_seq)
    table = table.astype(np.int32)
    q = rng.normal(size=(total_q, kv_heads * group, head_dim)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    ctx = np.array(ctx_l, np.int32)
    real = int(starts[-1])

    plain = paged_ragged_attention(t(q), t(k), t(v), t(table), t(starts), t(ctx),
                                   sliding_window=window, sinks=sinks).numpy()
    ref = np.asarray(pallas_paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(ctx), sliding_window=window, sinks=sinks,
        interpret=True))
    got = np.zeros_like(plain)
    for r, n in enumerate(q_lens):
        s0 = starts[r]
        total = int(ctx[r]) + n
        positions = torch.arange(ctx[r], total)[None]
        got[s0:s0 + n] = merged(t(q[None, s0:s0 + n]), t(k), t(v), t(table[r:r + 1]),
                                positions, torch.tensor([total]),
                                even_bounds([total], splits), window, sinks)[0].numpy()
    np.testing.assert_allclose(got[:real], plain[:real], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[:real], ref[:real], atol=ATOL, rtol=RTOL)


def test_split_with_no_key_and_row_with_no_key():
    """A split past a row's keys, or wholly outside its window, keeps
    m = -1e30, l = 0, O = 0 and changes nothing; a row no split saw a key
    for merges to zeros (as the kernels return for a padded row)."""
    rng = np.random.default_rng(7)
    page, width = 4, 16
    k = rng.normal(size=(9, 1, page, width)).astype(np.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    q = rng.normal(size=(2, 1, 4, width)).astype(np.float32)
    totals = torch.tensor([13, 0])
    positions = (totals - 1).clamp(min=0)[:, None]
    bounds = torch.tensor([[0, 5, 9, 13, 16], [0, 4, 8, 12, 16]])
    acc, m, l = paged_attention_split_states(t(q), t(k), t(k), t(table), positions, totals,
                                             bounds, sliding_window=3)
    assert (m[:2, 0] == -1e30).all() and (l[:2, 0] == 0).all() and (acc[:2, 0] == 0).all()
    assert (l[3, 0] == 0).all()  # keys 13..15 lie past the row's 13
    assert (l[:, 1] == 0).all()
    out = merge_split_states(acc, m, l)
    assert (out[1] == 0).all()
    ref = paged_attention(t(q), t(k), t(k), t(table), positions, totals, sliding_window=3)
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("window,sinks", [(None, None), (6, None), (6, 3)])
@pytest.mark.parametrize("empty_last", [False, True])
def test_decode_split_merge_with_tail_matches_pallas(splits, window, sinks, empty_last):
    """The GQA decode's split-KV with a burst tail folded by the last split
    only (with ``empty_last`` a split past the paged keys, which folds the
    tail with no paged key of its own), merged: the unsplit plain attention
    with the tail and the Pallas merged decode kernel's tail fold. A row with
    a tail and no paged key, a row whose window excludes whole splits, and a
    row with no key at all, which merges to zeros (the Pallas kernel
    averages garbage there instead, so it is compared with zeros)."""
    rng = np.random.default_rng(10 * splits + (window or 0) + empty_last)
    kv_heads, group, head_dim, page, slots = 2, 2, 8, 4, 5
    ctx_l, tail_l = [13, 0, 30, 5, 0, 22], [3, 2, 0, 5, 0, 1]
    pages_per_seq = 9
    num_pages = 1 + len(ctx_l) * pages_per_seq
    shape = (num_pages, kv_heads, page, head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    table = make_table(rng, ctx_l, pages_per_seq, page, num_pages)
    q = rng.normal(size=(len(ctx_l), kv_heads * group, head_dim)).astype(np.float32)
    tail = (len(ctx_l), slots, kv_heads, head_dim)
    tk = rng.normal(size=tail).astype(np.float32)
    tv = rng.normal(size=tail).astype(np.float32)
    ctx, tl = np.array(ctx_l, np.int32), np.array(tail_l, np.int32)
    positions = t(ctx + tl - 1)[:, None]
    acc, m, l = paged_attention_split_states(
        t(q[:, None]), t(k), t(v), t(table), positions, t(ctx),
        even_bounds(ctx_l, splits, extra_empty=empty_last), sliding_window=window,
        attention_sinks=sinks if window is not None else None, tail_k=t(tk), tail_v=t(tv),
        tail_lens=t(tl))
    got = merge_split_states(acc, m, l)[:, 0].numpy()
    live = (ctx + tl) > 0
    plain = paged_attention(t(q[:, None]), t(k), t(v), t(table), positions, t(ctx),
                            sliding_window=window,
                            attention_sinks=sinks if window is not None else None,
                            tail_k=t(tk), tail_v=t(tv), tail_lens=t(tl))[:, 0].numpy()
    ref = np.asarray(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(ctx), sliding_window=window, sinks=sinks, tail_k=jnp.asarray(tk),
        tail_v=jnp.asarray(tv), tail_lens=jnp.asarray(tl), interpret=True))
    np.testing.assert_allclose(got[live], plain[live], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[live], ref[live], atol=ATOL, rtol=RTOL)
    assert not got[~live].any()
    # Only the last split sees the tail: every other split's state is the
    # same without it.
    if splits > 1:
        acc0, m0, l0 = paged_attention_split_states(
            t(q[:, None]), t(k), t(v), t(table), positions, t(ctx),
            even_bounds(ctx_l, splits, extra_empty=empty_last), sliding_window=window,
            attention_sinks=sinks if window is not None else None)
        torch.testing.assert_close(acc[:-1], acc0[:-1], rtol=0, atol=0)
        torch.testing.assert_close(l[:-1], l0[:-1], rtol=0, atol=0)


@pytest.mark.parametrize("splits", [2, 5])
@pytest.mark.parametrize("window,sinks", [(None, None), (6, 3)])
def test_latent_decode_split_merge_matches_pallas(splits, window, sinks):
    """The latent decode's split-KV (shared latent as K and V), merged: the
    plain unsplit attention and the Pallas per-head decode kernel; a padded
    ctx-0 row merges to zeros."""
    rng = np.random.default_rng(splits)
    page, width, q_heads = 4, 24, 4
    lens = [13, 4, 2, 9, 0]
    pages_per_seq, num_pages = 5, 1 + 5 * 5
    k = rng.normal(size=(num_pages, 1, page, width)).astype(np.float32)
    table = make_table(rng, lens, pages_per_seq, page, num_pages)
    q = rng.normal(size=(len(lens), q_heads, width)).astype(np.float32)
    ctx = torch.tensor(lens)
    positions = (ctx - 1).clamp(min=0)[:, None]
    got = merged(t(q[:, None]), t(k), t(k), t(table), positions, ctx,
                 even_bounds(lens, splits), window, sinks)[:, 0].numpy()
    live = np.array(lens) > 0
    plain = paged_attention(t(q[:, None]), t(k), t(k), t(table), positions, ctx,
                            sliding_window=window,
                            attention_sinks=sinks)[:, 0].numpy()
    ref = np.asarray(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(table),
        jnp.asarray(np.array(lens, np.int32)), sliding_window=window, sinks=sinks,
        shared_kv=True, interpret=True))
    np.testing.assert_allclose(got[live], plain[live], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[live], ref[live], atol=ATOL, rtol=RTOL)
    assert not got[~live].any()


def latent_kernel_bounds(lens, tails, splits, page, window):
    """Each row's keys cut as the latent decode kernel's CTA parts take them
    (``latent_decode_runs`` at its 32-key chunks of the row's page stream,
    which starts at the window's first page), as logical key positions
    [rows, 2 * splits + 1]: the last part also folds the tail."""
    rows = []
    for n, tl in zip(lens, tails):
        q_pos = n + tl - 1
        pages = -(-n // page)
        first = 0 if window is None else min(max(q_pos - window + 1, 0) // page, pages)
        n_chunks = -(-(pages - first) * page // LATENT_CHUNK)
        tail_chunks = -(-tl // LATENT_CHUNK)
        runs = latent_decode_runs(n_chunks, splits, tail_chunks)
        assert_runs_cover(runs, n_chunks, tail_chunks, splits)
        paged = {part: [c for c in chunks if c < n_chunks] for part, chunks in runs.items()}
        cuts = [paged[s, team][0] if paged[s, team] else None for s in range(splits)
                for team in (0, 1)] + [n_chunks]
        for i in range(len(cuts) - 2, -1, -1):  # an empty part starts where the next does
            if cuts[i] is None:
                cuts[i] = cuts[i + 1]
        rows.append([first * page + c * LATENT_CHUNK for c in cuts])
    return torch.tensor(rows, dtype=torch.int64)


def check_latent_kernel_plan(splits, window, tails, slots, seed):
    """The plain split states cut as ``latent_kernel_bounds`` cuts them,
    merged, against the unsplit plain attention and the Pallas per-head
    decode kernel over the shared latent (interpret mode), with a burst
    tail of ``slots`` slots when ``tails`` has one; a row with no key at all
    gets zeros."""
    rng = np.random.default_rng(seed)
    page, width, q_heads = 4, 24, 4
    lens = [100, 31, 32, 33, 64, 65, 0, 130, 0]
    with_tail = any(tails)
    pages_per_seq = -(-max(lens) // page) + 1
    num_pages = 1 + sum(-(-n // page) for n in lens) + 2
    k = rng.normal(size=(num_pages, 1, page, width)).astype(np.float32)
    table = make_table(rng, lens, pages_per_seq, page, num_pages)
    q = rng.normal(size=(len(lens), q_heads, width)).astype(np.float32)
    tk = rng.normal(size=(len(lens), slots, 1, width)).astype(np.float32)
    ctx, tl = np.array(lens, np.int32), np.array(tails, np.int32)
    positions = t(ctx + tl - 1)[:, None]
    tail = dict(tail_k=t(tk), tail_v=t(tk), tail_lens=t(tl)) if with_tail else {}
    bounds = latent_kernel_bounds(lens, tails, splits, page, window)
    got = merge_split_states(*paged_attention_split_states(
        t(q[:, None]), t(k), t(k), t(table), positions, t(ctx), bounds,
        sliding_window=window, **tail))[:, 0].numpy()
    live = (ctx + tl) > 0
    plain = paged_attention(t(q[:, None]), t(k), t(k), t(table), positions, t(ctx),
                            sliding_window=window, **tail)[:, 0].numpy()
    ref = np.asarray(pallas_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(table), jnp.asarray(ctx),
        sliding_window=window, shared_kv=True, interpret=True,
        **({"tail_k": jnp.asarray(tk), "tail_lens": jnp.asarray(tl)} if with_tail else {})))
    np.testing.assert_allclose(got[live], plain[live], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[live], ref[live], atol=ATOL, rtol=RTOL)
    assert not got[~live].any()


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("with_tail", [False, True])
def test_latent_decode_kernel_plan_merge_matches_pallas(splits, window, with_tail):
    """The latent decode's own plan at its 32-key chunks (each split's run
    halved between the CTA's two teams, a burst tail folded by the last
    split's second team), merged: the unsplit plain attention and the
    Pallas per-head decode kernel over the shared latent (interpret mode),
    at contexts at and beside the chunk boundary, a row with a tail and no
    paged key, and a row with no key at all (zeros)."""
    tails = [3, 0, 5, 1, 0, 2, 4, 6, 0] if with_tail else [0] * 9
    check_latent_kernel_plan(splits, window, tails, 6, splits + 10 * (window or 0) + with_tail)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("window", [None, 40])
def test_latent_decode_kernel_plan_two_tail_chunks_match_pallas(splits, window):
    """As above with burst tails of up to 64 slots: a tail of 33 to 64
    slots is two more 32-key chunks of the last split's second team."""
    tails = [64, 0, 33, 1, 0, 32, 40, 6, 0]
    check_latent_kernel_plan(splits, window, tails, 64, 7 + splits + 10 * (window or 0))


@pytest.mark.parametrize("splits", [3, 7])
def test_latent_prefill_split_merge_matches_pallas(splits):
    """The latent prefill's split-KV of a short chunk over a cached prefix
    (the warm chunk's shape, cut down), merged: the plain unsplit attention
    and the Pallas prefill kernel's shared_kv arm."""
    rng = np.random.default_rng(splits)
    page, width, q_heads, q_seq = 4, 24, 4, 8
    ctx = np.array([page * 5 + 3, 0], np.int32)
    new = np.array([q_seq - 3, q_seq], np.int32)
    total = ctx + new
    pages_per_seq = int(max(-(-total // page))) + 1
    num_pages = 1 + 2 * pages_per_seq
    k = rng.normal(size=(num_pages, 1, page, width)).astype(np.float32)
    table = make_table(rng, list(total), pages_per_seq, page, num_pages)
    q = rng.normal(size=(2, q_seq, q_heads, width)).astype(np.float32)
    positions = t(ctx)[:, None] + torch.arange(q_seq)[None]
    got = merged(t(q), t(k), t(k), t(table), positions, t(total),
                 even_bounds(list(total), splits)).numpy()
    plain = paged_attention(t(q), t(k), t(k), t(table), positions, t(total)).numpy()
    ref = np.asarray(pallas_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(table),
        jnp.asarray(ctx), jnp.asarray(total), q_tile=4, shared_kv=True, interpret=True))
    for b in range(2):
        np.testing.assert_allclose(got[b, :new[b]], plain[b, :new[b]], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[b, :new[b]], ref[b, :new[b]], atol=ATOL, rtol=RTOL)


# (q_lens, ctx_lens) of latent ragged mixes: decode rows beside a chunk over
# a cached prefix, and 2- and 3-token rows (the smallest prefill rows), an
# empty row and a chunk that straddles the 4-token tiles.
LATENT_SPLIT_MIXES = {
    "chunk+decode": ([1, 1, 13, 1, 0], [9, 40, 30, 2, 0]),
    "odd": ([2, 3, 0, 1, 7], [45, 0, 3, 20, 17]),
}


@pytest.mark.parametrize("mix", sorted(LATENT_SPLIT_MIXES))
@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("window,sinks", [(None, None), (6, 2)])
def test_latent_ragged_split_prefill_rows_match_pallas(mix, splits, window, sinks):
    """The latent ragged kernel's prefill rows cut into its 4-token tiles,
    each tile's key chunks split across ``splits`` CTAs as its CTAs take
    them (``prefill_tile_chunks`` at 8-key chunks, so a tile here streams
    several: the window's first page, the sink pages first), the decode
    rows' keys split evenly; merged: ``paged_ragged_attention`` and the
    Pallas ragged kernel's shared_kv arm (interpret mode)."""
    rng = np.random.default_rng(splits + 10 * (window or 0))
    q_lens, ctx_l = LATENT_SPLIT_MIXES[mix]
    page, width, q_heads, tile, ck, pages_per_seq, total_q = 4, 24, 4, 4, 8, 16, 32
    rows = len(q_lens)
    num_pages = 1 + rows * pages_per_seq
    k = rng.normal(size=(num_pages, 1, page, width)).astype(np.float32)
    table = rng.permutation(np.arange(1, num_pages)).reshape(rows, pages_per_seq)
    table = table.astype(np.int32)
    q = rng.normal(size=(total_q, q_heads, width)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    ctx = np.array(ctx_l, np.int32)
    real, paged_len = int(starts[-1]), pages_per_seq * page

    plain = paged_ragged_attention(t(q), t(k), None, t(table), t(starts), t(ctx),
                                   sliding_window=window, sinks=sinks, shared_kv=True).numpy()
    ref = np.asarray(pallas_paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(ctx), sliding_window=window, sinks=sinks,
        shared_kv=True, interpret=True))
    got = np.zeros_like(plain)
    n_tiles = 0
    for r, n in enumerate(q_lens):
        s0, c = int(starts[r]), int(ctx[r])
        if n == 1:
            got[s0] = merged(t(q[None, s0:s0 + 1]), t(k), t(k), t(table[r:r + 1]),
                             torch.tensor([[c]]), torch.tensor([c + 1]),
                             even_bounds([c + 1], splits), window, sinks)[0, 0].numpy()
            continue
        for t0 in range(0, n if n > 1 else 0, tile):
            n_tiles += 1
            chunks = prefill_tile_chunks(c, t0, n, tile, pages_per_seq, page, ck, window,
                                         sinks or 0)
            # Split s streams the chunks of its run: the positions from its
            # first chunk's first key on (monotone in the stream; keys in
            # the pages it skips are outside every query's window).
            firsts = [chunks[run[0], 0] if len(run) else paged_len
                      for run in split_runs(len(chunks), splits)]
            bounds = [max(b, 0) if b >= 0 else paged_len for b in firsts] + [paged_len]
            bounds = np.minimum.accumulate(np.array(bounds)[::-1])[::-1]  # empty runs
            m = min(tile, n - t0)
            got[s0 + t0:s0 + t0 + m] = merged(
                t(q[None, s0 + t0:s0 + t0 + m]), t(k), t(k), t(table[r:r + 1]),
                torch.arange(c + t0, c + t0 + m)[None], torch.tensor([c + n]),
                torch.from_numpy(bounds.astype(np.int64))[None], window, sinks)[0].numpy()
    assert n_tiles >= 3
    np.testing.assert_allclose(got[:real], plain[:real], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[:real], ref[:real], atol=ATOL, rtol=RTOL)
