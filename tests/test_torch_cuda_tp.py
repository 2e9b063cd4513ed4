"""Tensor-parallel serving's kernels and ranks on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc``; elsewhere they skip. On
a machine with the card (which has no JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tp.py -q

- The latent kernels' 8-head instantiations (a tp 2 rank's heads over the
  replicated latent) against the plain version: the decode at widths 576
  and 640, page sizes 4 and 16, with SWA + sinks, split across 1, 3 or the
  planned CTAs, with and without a decode-burst tail; the prefill over
  chunks of 1, 7, 31, 64 and 75 tokens (tiles of 8 tokens), the warm 64
  over 4096 cached (split across CTAs), at ctx 0.
- Both sharded wrappers at a rank's shapes (8 query heads over 4 kv heads
  of 128; 8 heads over the whole latent) against the plain sharded
  versions, each call counting one wrapper and one kernel launch.
- A gloo pair on one card: two ranks serve a small bf16 GQA model and a
  small MLA model through ``MiniEngine(tp=group)``: every step through the
  sharded wrappers (launches = layers x dispatches, no plain call), the
  ranks' tokens equal, rank 0's events equal a tp 1 engine's on the same
  weights, the MLA latent pools bit-equal across the ranks, and a prefill
  chunk's logits within 5% of max|logit| of the tp 1 engine's; the same
  weights handed to the engines as a host tree place the same shard on the
  card and serve the same tokens.

Tolerance as in ``chip_smoke.py``: ``2e-2 * min(1, rms of the row) +
2e-2 * |plain|`` (the kernels and the plain version round p and the output
to bf16 at different points).
"""

import pytest
import torch

from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops
from llmd_kv_cache_tpu_torch.ops.paged_attention import (
    paged_attention,
    sharded_decode_attention,
    sharded_prefill_attention,
)
from llmd_kv_cache_tpu_torch.parallel import mesh

pytestmark = pytest.mark.cuda

ATOL = RTOL = 2e-2
WINDOWS = [(None, None), (100, 4)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def assert_close(got, ref):
    """|got - ref| <= ATOL * min(1, rms of the row's ref) + RTOL * |ref|."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    rms = ref.reshape(ref.shape[0], -1).pow(2).mean(1).sqrt().clamp(max=1)
    atol = ATOL * rms.reshape((-1,) + (1,) * (ref.dim() - 1))
    err = (got - ref).abs()
    assert bool((err <= atol + RTOL * ref.abs()).all()), float(err.max())


def latent(gen, num_pages, page, width, heads=1):
    return torch.randn(num_pages, heads, page, width, generator=gen,
                       device="cuda").to(torch.bfloat16)


def table_for(gen, lens, page, pages_per_seq, num_pages):
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(len(lens), pages_per_seq, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lens):
        k = (n + page - 1) // page
        table[b, :k] = perm[used:used + k].to(torch.int32)
        used += k
    return table


def rank_group(rank=0, size=2):
    return mesh.TPGroup(rank=rank, size=size, process_group=None,
                        device=torch.device("cuda"), backend="none")


@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("tail", [0, 8])
def test_latent_decode_8_heads(gen, monkeypatch, width, page, window, sinks, splits, tail):
    if splits is not None:
        monkeypatch.setattr(ops, "latent_decode_splits", lambda *a, **kw: splits)
    lens = [1, 31, 32, 33, 300, 1025, 4160, 0]
    pages_per_seq = -(-max(lens) // page) + 1
    num_pages = 1 + sum(-(-n // page) for n in lens) + 3
    k = latent(gen, num_pages, page, width)
    table = table_for(gen, lens, page, pages_per_seq, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), 8, width, generator=gen, device="cuda").to(torch.bfloat16)
    tails, q_end = {}, ctx
    if tail:
        tk = torch.randn(len(lens), tail, 1, width, generator=gen,
                         device="cuda").to(torch.bfloat16)
        tl = torch.tensor([tail, 1, 0, 5, tail, 3, tail, 0], dtype=torch.int32, device="cuda")
        tails, q_end = dict(tail_k=tk, tail_lens=tl), ctx + tl
    before = ops.cuda_paged_latent_decode_attention.launches
    out = ops.cuda_paged_decode_attention(q, k, None, table, ctx, shared_kv=True,
                                          sliding_window=window, sinks=sinks, **tails)
    torch.cuda.synchronize()
    assert ops.cuda_paged_latent_decode_attention.launches == before + 1
    ref = paged_attention(q[:, None], k, k, table, (q_end - 1)[:, None], ctx,
                          sliding_window=window, attention_sinks=sinks,
                          **({"tail_k": tk, "tail_v": tk, "tail_lens": tl} if tail else {}))[:, 0]
    live = q_end > 0
    assert_close(out[live], ref[live])
    assert bool((out[~live] == 0).all())


@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,sinks", WINDOWS)
@pytest.mark.parametrize("splits", [None, 3])
def test_latent_prefill_8_heads(gen, monkeypatch, width, page, window, sinks, splits):
    """Chunks of 75 (not a multiple of the 8-token tile), 64, 1, 7 and 31
    tokens, the warm 64 over 4096 cached, ctx 0; unsplit as planned or
    split across 3 CTAs (forced)."""
    if splits is not None:
        monkeypatch.setattr(ops, "latent_prefill_splits", lambda *a, **kw: splits)
    q_seq = 75
    ctx_l, new_l = [0, 2 * page + 3, 130, 9, 4096, 1037, 0], [q_seq, 64, 1, 7, 64, 31, 75]
    total_l = [c + n for c, n in zip(ctx_l, new_l)]
    pages_per_seq = -(-max(total_l) // page) + 1
    num_pages = 1 + sum(-(-n // page) for n in total_l) + 3
    k = latent(gen, num_pages, page, width)
    table = table_for(gen, total_l, page, pages_per_seq, num_pages)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    total = torch.tensor(total_l, dtype=torch.int32, device="cuda")
    q = torch.randn(len(ctx_l), q_seq, 8, width, generator=gen,
                    device="cuda").to(torch.bfloat16)
    out = ops.cuda_paged_prefill_attention(q, k, k, table, ctx, total, shared_kv=True,
                                           sliding_window=window, sinks=sinks)
    torch.cuda.synchronize()
    positions = ctx[:, None] + torch.arange(q_seq, device="cuda")[None]
    ref = paged_attention(q, k, k, table, positions, total, sliding_window=window,
                          attention_sinks=sinks)
    for b, n in enumerate(new_l):
        assert_close(out[b, :n], ref[b, :n])


def test_latent_prefill_8_heads_warm_chunk_splits(gen):
    """The warm 64-token chunk over 4096 cached latents at 8 heads: 8 tiles
    of 8 tokens, which the planner splits across CTAs."""
    page, pages_per_seq = 16, 272
    lib = ops.load_library()
    assert lib.llmd_latent_prefill_tile_tokens(8) == 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.latent_prefill_splits(1, 64, pages_per_seq, page,
                                     lib.llmd_latent_prefill_chunk_keys(576), 8, sms) > 1
    k = latent(gen, pages_per_seq + 1, page, 576)
    table = table_for(gen, [4160], page, pages_per_seq, pages_per_seq + 1)
    ctx = torch.tensor([4096], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 64, 8, 576, generator=gen, device="cuda").to(torch.bfloat16)
    out = ops.cuda_paged_latent_prefill_attention(q, k, table, ctx, ctx + 64)
    torch.cuda.synchronize()
    positions = ctx[:, None] + torch.arange(64, device="cuda")[None]
    assert_close(out[0], paged_attention(q, k, k, table, positions, ctx + 64)[0])


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_sharded_wrappers_at_rank_shapes(gen, kind):
    shared = kind == "mla"
    width, pool_heads, q_heads = (576, 1, 8) if shared else (128, 4, 8)
    heads = dict(q_heads=16, kv_heads=1 if shared else 8)
    page, lens = 16, [1, 17, 300, 1024, 2049, 3001, 4160, 0]
    pages_per_seq = 272
    num_pages = 1 + sum(-(-n // page) for n in lens) + 300
    k = latent(gen, num_pages, page, width, pool_heads)
    v = k if shared else latent(gen, num_pages, page, width, pool_heads)
    table = table_for(gen, lens, page, pages_per_seq, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(8, q_heads, width, generator=gen, device="cuda").to(torch.bfloat16)
    inner = ops.cuda_paged_latent_decode_attention if shared else ops.cuda_paged_decode_attention
    before = (ops.sharded_paged_decode_attention.launches, inner.launches)
    out = ops.sharded_paged_decode_attention(rank_group(), q, k, v, table, ctx,
                                             shared_kv=shared, **heads)
    torch.cuda.synchronize()
    assert (ops.sharded_paged_decode_attention.launches, inner.launches) == (
        before[0] + 1, before[1] + 1)
    live = ctx > 0
    ref = sharded_decode_attention(2, q, k, v, table, ctx, shared_kv=shared, **heads)
    assert_close(out[live], ref[live])
    # The prefill: 2048 tokens over a 2048-token prefix, and 64 over 4096.
    table = table_for(gen, [4160], page, pages_per_seq, num_pages)
    for ctx_len, new in ((2048, 2048), (4096, 64)):
        c = torch.tensor([ctx_len], dtype=torch.int32, device="cuda")
        qp = torch.randn(1, new, q_heads, width, generator=gen,
                         device="cuda").to(torch.bfloat16)
        out = ops.sharded_paged_prefill_attention(rank_group(1), qp, k, v, table, c, c + new,
                                                  shared_kv=shared, **heads)
        torch.cuda.synchronize()
        assert_close(out[0], sharded_prefill_attention(2, qp, k, v, table, c, c + new,
                                                       shared_kv=shared, **heads)[0])
    with pytest.raises(ValueError, match="query heads"):  # a rank's q must be local
        ops.sharded_paged_decode_attention(rank_group(), torch.cat([q, q], 1), k, v, table[:1],
                                           ctx[:1], shared_kv=shared, **heads)


SMALL = {
    "gqa": dict(vocab_size=1024, hidden_size=512, num_layers=2, num_heads=8, num_kv_heads=4,
                head_dim=64, intermediate_size=1024, page_size=16),
    "mla": dict(vocab_size=1024, hidden_size=512, num_layers=2, num_heads=16,
                num_kv_heads=16, head_dim=32, intermediate_size=1024, page_size=16,
                kv_lora_rank=512, qk_rope_head_dim=64),
}


def flat(params):
    """A parameter tree's leaves in order."""
    return [t for k in sorted(params) for t in (
        [layer[n] for layer in params[k] for n in sorted(layer)] if k == "layers"
        else [params[k]])]


def pair_rank(group, kind, prompts):
    """One rank of the pair (a module-level function: the ranks import
    this module by name)."""
    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import (
        LlamaConfig,
        forward,
        init_kv_cache,
        init_params,
    )

    cfg = LlamaConfig(**SMALL[kind])
    events = []
    eng = MiniEngine(EngineConfig(model=cfg, num_pages=128, max_pages_per_seq=16,
                                  max_prefill_tokens=64, model_name=kind),
                     event_sink=events.extend, seed=3, tp=group)
    toks = torch.tensor([prompts[0][:64]], device="cuda")
    table = torch.arange(1, 5, dtype=torch.int32, device="cuda")[None]
    k, v = init_kv_cache(cfg, 5, tp_size=group.size)
    zero, n = (torch.tensor([x], dtype=torch.int32, device="cuda") for x in (0, 64))
    logits = forward(eng.params, cfg, toks, k, v, table, zero, n, tp=group)[0].cpu()
    dispatches = {"_decode_chunk": 0, "_prefill_chunk": 0}
    for name in dispatches:
        def counted(*args, _inner=getattr(eng, name), _name=name):
            dispatches[_name] += 1
            return _inner(*args)
        setattr(eng, name, counted)
    kernels = ((ops.cuda_paged_latent_decode_attention, ops.cuda_paged_latent_prefill_attention)
               if kind == "mla" else
               (ops.cuda_paged_decode_attention, ops.cuda_paged_prefill_attention))
    wrappers = (ops.sharded_paged_decode_attention, ops.sharded_paged_prefill_attention)
    for fn in (*kernels, *wrappers):
        fn.launches = 0
    reqs = [eng.enqueue(f"r{i}", p, max_new_tokens=6) for i, p in enumerate(prompts)]
    while any(not r.done for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    launches = tuple(fn.launches for fn in wrappers)
    kernel_launches = tuple(fn.launches for fn in kernels)
    # The same weights handed over as a host tree: the engine places only
    # the rank's shard on the card, and serves the same tokens.
    host = {k: ([{n_: t.cpu() for n_, t in layer.items()} for layer in leaf]
                if k == "layers" else leaf.cpu())
            for k, leaf in init_params(cfg, seed=3, device="cuda").items()}
    from_host = MiniEngine(EngineConfig(model=cfg, num_pages=128, max_pages_per_seq=16,
                                        max_prefill_tokens=64, model_name=kind),
                           params=host, tp=group)
    same_shard = all(
        a.device == b.device and torch.equal(a, b)
        for a, b in zip(flat(from_host.params), flat(eng.params)))
    again = [from_host.enqueue(f"r{i}", p, max_new_tokens=6) for i, p in enumerate(prompts)]
    while any(not r.done for r in again):
        from_host.step()
    return dict(outputs=[list(r.output) for r in reqs], events=len(events),
                host_tree_outputs=[list(r.output) for r in again], host_tree_shard=same_shard,
                stored=[tuple(e.block_hashes) for e in events if hasattr(e, "block_hashes")],
                dispatches=(dispatches["_decode_chunk"], dispatches["_prefill_chunk"]),
                launches=launches, kernel_launches=kernel_launches,
                logits=logits, pool=eng.k_cache.cpu() if kind == "mla" else None)


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_gloo_pair_on_one_card(gen, kind):
    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig, forward, init_kv_cache

    prompts = [torch.randint(1, 1000, (n,), generator=torch.Generator().manual_seed(n)).tolist()
               for n in (70, 40, 90)]
    prompts[1] = prompts[0][:48] + prompts[1]  # shares three blocks
    ranks = mesh.spawn_tp(pair_rank, 2, backend="gloo", devices=["cuda:0", "cuda:0"],
                          args=(kind, prompts), timeout_s=300, collective_timeout_s=120)
    cfg = LlamaConfig(**SMALL[kind])
    events = []
    tp1 = MiniEngine(EngineConfig(model=cfg, num_pages=128, max_pages_per_seq=16,
                                  max_prefill_tokens=64, model_name=kind),
                     event_sink=events.extend, seed=3)
    toks = torch.tensor([prompts[0][:64]], device="cuda")
    table = torch.arange(1, 5, dtype=torch.int32, device="cuda")[None]
    k, v = init_kv_cache(cfg, 5)
    zero, n = (torch.tensor([x], dtype=torch.int32, device="cuda") for x in (0, 64))
    ref = forward(tp1.params, cfg, toks, k, v, table, zero, n)[0].cpu()
    reqs = [tp1.enqueue(f"r{i}", p, max_new_tokens=6) for i, p in enumerate(prompts)]
    while any(not r.done for r in reqs):
        tp1.step()
    assert ranks[0]["outputs"] == ranks[1]["outputs"]
    for r in ranks:  # a host tree: the same shard on the card, the same tokens
        assert r["host_tree_shard"] and r["host_tree_outputs"] == r["outputs"]
    for r in ranks:
        assert float((r["logits"] - ref).abs().max()) <= 0.05 * float(ref.abs().max())
    stored = [tuple(e.block_hashes) for e in events if hasattr(e, "block_hashes")]
    assert ranks[0]["stored"] == stored and ranks[1]["events"] == 0
    for r in ranks:  # every dispatch through the sharded wrappers and their kernels
        want = tuple(cfg.num_layers * d for d in r["dispatches"])
        assert min(r["dispatches"]) > 0 and r["launches"] == r["kernel_launches"] == want
    if kind == "mla":
        assert torch.equal(ranks[0]["pool"], ranks[1]["pool"])
