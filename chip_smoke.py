#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmd_kv_cache_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA Hopper card
(H100) and the CUDA toolkit. It imports nothing of JAX or of the JAX
package. Phases, each of which fails loudly (an uncaught exception is a
non-zero exit):

1. Environment: torch/CUDA versions, the card's name and power limit; TF32
   off for the comparisons.
2. Build: compile the Hopper kernels from ``llmd_kv_cache_tpu_torch/csrc``.
3. Kernel parity: each kernel against its plain PyTorch version on the card,
   in bf16, at the main path's shapes (plus a sliding-window + sinks case
   each), and each kernel's time beside its bound and the plain version's.
4. Main path at full width: two ``MiniEngine`` pods of the bench's 0.9B
   paged Llama (random weights from a seed) feed their KV events into one
   ``Indexer``; a 4160-token prompt is served cold, a second prompt with the
   same 4096-token prefix is scored, routed to the warm pod and served with
   its prefix reused, then 8 more are enqueued and decoded to 16 tokens each.
   The kernels' launch counters are zeroed just before and read just after.
   Then one prefill chunk's logits through the kernels are held against the
   same forward with the plain attention.
5. Report: one ``{"kernels": [...]}`` line, a timing line, the card's name and
   power limit, and as the last line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or the port
package is not beside it.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Parity tolerance for the bf16 kernels against the plain version:
# |kernel - plain| <= ATOL + RTOL * |plain|. The two round p to bf16 at
# different points (the flash kernels round the unnormalised p of each key
# chunk, the plain version the normalised probabilities) and both round the
# output to bf16, so they may differ by about two bf16 ulps (2^-7 relative
# each) of the output; fp32 summation order adds far less.
PARITY_ATOL = 2e-2
PARITY_RTOL = 2e-2

# Logits of one prefill chunk through the kernels vs the plain attention:
# the per-layer differences above (a bf16 ulp or two of the attention
# output) pass through 16 residual layers and the lm_head. Relative to the
# largest logit.
LOGITS_REL_TOL = 5e-2


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches
    (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernel parity at the main path's shapes
# ---------------------------------------------------------------------------

KV_HEADS, Q_HEADS, HEAD_DIM, PAGE = 8, 16, 128, 16
PAGES_PER_SEQ = 272


def random_pool(torch, gen, num_pages):
    """A bf16 K/V pool of random values (page 0, the garbage page, too, so
    a read past a sequence's keys shows up) and a random page assignment."""
    shape = (num_pages, KV_HEADS, PAGE, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v


def page_table_for(torch, gen, lens, num_pages):
    """Distinct random physical pages (never page 0) for each row."""
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(len(lens), PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lens):
        n_pages = (n + PAGE - 1) // PAGE
        table[b, :n_pages] = perm[used:used + n_pages].to(torch.int32)
        used += n_pages
    return table


def check_close(name, got, ref, mask=None) -> float:
    import torch

    got, ref = got.float(), ref.float()
    if mask is not None:
        got, ref = got[mask], ref[mask]
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    err = (got - ref).abs()
    excess = err - (PARITY_ATOL + PARITY_RTOL * ref.abs())
    max_err = float(err.max())
    print(f"parity {name}: max_abs_err={max_err:.3e} "
          f"(tol {PARITY_ATOL} + {PARITY_RTOL}*|plain|)", flush=True)
    if float(excess.max()) > 0:
        fail(f"{name}: kernel disagrees with the plain version "
             f"(max_abs_err {max_err:.3e})")
    return max_err


def decode_parity(torch, ops, gen) -> dict:
    """Decode kernel vs plain: B 8, ragged contexts incl. a padded row."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    decode = ops.cuda_paged_decode_attention
    lens = [1, 17, 300, 1024, 2049, 3001, 4160, 0]  # row 7: padded (total 0)
    num_pages = sum((n + PAGE - 1) // PAGE for n in lens) + 64
    k, v = random_pool(torch, gen, num_pages)
    table = page_table_for(torch, gen, lens, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), Q_HEADS, HEAD_DIM, generator=gen,
                    device="cuda").to(torch.bfloat16)
    live = ctx > 0

    def plain(window=None, sinks=None):
        return paged_attention(q[:, None], k, v, table, (ctx - 1)[:, None], ctx,
                               sliding_window=window, attention_sinks=sinks)[:, 0]

    out = decode(q, k, v, table, ctx)
    torch.cuda.synchronize()
    if not bool((out[~live] == 0).all()):
        fail("decode: a padded row (total_len 0) did not return zeros")
    err = check_close("decode", out, plain(), live)
    out = decode(q, k, v, table, ctx, sliding_window=500, sinks=20)
    torch.cuda.synchronize()
    err = max(err, check_close("decode swa+sinks", out, plain(500, 20), live))

    # Time at the main path's decode shape: 8 rows at a 4160-token context.
    lens = [4160] * 8
    num_pages = 8 * 260 + 1
    k, v = random_pool(torch, gen, num_pages)
    table = page_table_for(torch, gen, lens, num_pages)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = decode(q, k, v, table, ctx)
    torch.cuda.synchronize()
    err = max(err, check_close("decode b8 ctx4160", out, plain()))
    ms = time_ms(lambda: decode(q, k, v, table, ctx))
    plain_ms = time_ms(plain, iters=5)
    keys = sum(lens)
    nbytes = (keys * KV_HEADS * HEAD_DIM * 2 * 2  # K and V, bf16
              + 2 * q.numel() * 2 + table.numel() * 4 + ctx.numel() * 4)
    flops = 4 * Q_HEADS * HEAD_DIM * keys  # QK^T and PV
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"decode b8 ctx4160: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def prefill_parity(torch, ops, gen) -> dict:
    """Prefill kernel vs plain: the cold prompt's 2048-token chunks at ctx 0
    and 2048, the 64-token tail chunk at ctx 4096, and SWA + sinks."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    prefill = ops.cuda_paged_prefill_attention
    num_pages = 272 + 1
    k, v = random_pool(torch, gen, num_pages)
    table = page_table_for(torch, gen, [4160], num_pages)
    err = 0.0
    timing = None
    cases = [  # (ctx, seq, valid new tokens, window, sinks)
        (0, 2048, 2048, None, None),
        (2048, 2048, 2048, None, None),
        (4096, 64, 64, None, None),
        (4096, 64, 50, None, None),  # padded tail of a bucket
        (2048, 2048, 2048, 1000, 20),
    ]
    for ctx_len, seq, new, window, sinks in cases:
        q = torch.randn(1, seq, Q_HEADS, HEAD_DIM, generator=gen,
                        device="cuda").to(torch.bfloat16)
        ctx = torch.tensor([ctx_len], dtype=torch.int32, device="cuda")
        total = ctx + new
        positions = ctx[:, None] + torch.arange(seq, device="cuda")[None]

        def plain(q=q, ctx=ctx, total=total, positions=positions,
                  window=window, sinks=sinks):
            return paged_attention(q, k, v, table, positions, total,
                                   sliding_window=window, attention_sinks=sinks)

        def kernel(q=q, ctx=ctx, total=total, window=window, sinks=sinks):
            return prefill(q, k, v, table, ctx, total,
                           sliding_window=window, sinks=sinks)

        out = kernel()
        torch.cuda.synchronize()
        name = f"prefill ctx{ctx_len} s{seq} new{new}" + (
            f" swa{window}+sinks{sinks}" if window else "")
        valid = (torch.arange(seq, device="cuda") < new)[None, :]
        err = max(err, check_close(name, out, plain(), valid))
        if (ctx_len, seq, window) == (2048, 2048, None):
            ms = time_ms(kernel)
            plain_ms = time_ms(plain, iters=5)
            qpos = torch.arange(ctx_len, ctx_len + seq, dtype=torch.float64)
            pairs = float((qpos + 1).sum())  # causal (query, key) pairs
            flops = 4 * Q_HEADS * HEAD_DIM * pairs
            nbytes = ((ctx_len + seq) * KV_HEADS * HEAD_DIM * 2 * 2
                      + 2 * q.numel() * 2 + table.numel() * 4 + 8)
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"prefill s2048 ctx2048: {ms:.4f} ms/launch, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return dict(max_abs_err=err, **timing)


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------

def count_calls(engine, name: str) -> list:
    """Count calls of one engine method (a one-element list as the cell)."""
    cell = [0]
    inner = getattr(engine, name)

    def wrapper(*args, **kwargs):
        cell[0] += 1
        return inner(*args, **kwargs)

    setattr(engine, name, wrapper)
    return cell


def main_path(torch, ops) -> dict:
    from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
    from llmd_kv_cache_tpu_torch.events.model import (
        BlockRemovedEvent,
        BlockStoredEvent,
        EventBatch,
    )
    from llmd_kv_cache_tpu_torch.events.pool import Pool
    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig, init_params
    from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig

    # The bench's accelerator model (bench.py, routing replay): ~0.89B.
    model = LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=16,
                        num_heads=16, num_kv_heads=8, head_dim=128,
                        intermediate_size=5632, page_size=16)
    t0 = time.perf_counter()
    params = init_params(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"]]) + sum(
        t.numel() for layer in params["layers"] for t in layer.values())
    print(f"model: {n_params / 1e9:.3f}B params (bf16, seed 0), "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)

    indexer = Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
        block_size_tokens=model.page_size)))
    pool = Pool(indexer.kv_block_index, indexer.token_processor)
    model_name = "llama-0.9b"
    events: dict[str, list] = {}
    engines: dict[str, MiniEngine] = {}
    for pod in ("pod-0", "pod-1"):
        events[pod] = []

        def sink(evs, pod=pod):
            events[pod].extend(evs)
            pool.process_event_batch(EventBatch(timestamp=time.time(), events=evs),
                                     pod, model_name)

        engines[pod] = MiniEngine(
            EngineConfig(model=model, num_pages=1024, max_pages_per_seq=272,
                         max_prefill_tokens=2048, model_name=model_name,
                         pod_identifier=pod),
            event_sink=sink, params=params, device="cuda")
    prefill_chunks = {p: count_calls(e, "_prefill_chunk") for p, e in engines.items()}
    decode_calls = {p: count_calls(e, "_decode_chunk") for p, e in engines.items()}

    rng = torch.Generator().manual_seed(1)

    def tokens(n):
        return torch.randint(1, model.vocab_size, (n,), generator=rng).tolist()

    prefix = tokens(4096)
    prompt_a = prefix + tokens(64)
    prompt_b = prefix + tokens(64)
    prompt_c = prefix[:1024] + tokens(64)  # pod-1 holds a shorter shared prefix

    def sync_ms(t_start):
        torch.cuda.synchronize()
        return (time.perf_counter() - t_start) * 1e3

    # Warm-up outside the timed requests, at the cold prompt's chunk shapes
    # (2048 + a 64-token tail): first launches of cuBLAS and the kernels pay
    # one-time set-up.
    warmup = tokens(2048 + 64)
    engines["pod-1"].generate("warmup", warmup, max_new_tokens=2)

    # --- the main path: counters zeroed just before, read just after ---
    ops.cuda_paged_decode_attention.launches = 0
    ops.cuda_paged_prefill_attention.launches = 0
    for cell in (*prefill_chunks.values(), *decode_calls.values()):
        cell[0] = 0

    t = time.perf_counter()
    req_a = engines["pod-0"].add_request("A", prompt_a, max_new_tokens=1)
    ttft_cold_ms = sync_ms(t)
    engines["pod-1"].add_request("C", prompt_c, max_new_tokens=1)

    scores = indexer.score_tokens(prompt_b, model_name)
    ranked = sorted(scores, key=lambda p: (-scores[p], p))
    print(f"score_tokens(prompt B): {scores}", flush=True)
    if not ranked or ranked[0] != "pod-0" or scores["pod-0"] != 256:
        fail(f"routing: expected pod-0 first with 256 blocks, got {scores}")
    target = engines[ranked[0]]
    t = time.perf_counter()
    req_b = target.add_request("B", prompt_b, max_new_tokens=1)
    ttft_warm_ms = sync_ms(t)
    print(f"routed B to {ranked[0]}: cached_len={req_b.cached_len}", flush=True)
    if req_b.cached_len != 4096:
        fail(f"routing: cached_len {req_b.cached_len}, expected 4096")

    batch = [target.enqueue(f"D{i}", prefix + tokens(64), max_new_tokens=16)
             for i in range(8)]
    step_ms = []
    while any(not r.done for r in batch):
        decoding = sum(1 for r in batch if r.prefill_pos is None and r.output
                       and not r.done)
        prefilling = any(r.prefill_pos is not None for r in batch)
        t = time.perf_counter()
        target.step()
        elapsed = sync_ms(t)
        if decoding == 8 and not prefilling:
            step_ms.append(elapsed)
    torch.cuda.synchronize()
    launches = {"decode": ops.cuda_paged_decode_attention.launches,
                "prefill": ops.cuda_paged_prefill_attention.launches}
    n_prefill = sum(c[0] for c in prefill_chunks.values())
    n_decode = sum(c[0] for c in decode_calls.values())
    # --- end of the main path ---

    print(f"main path: {n_prefill} prefill chunks, {n_decode} decode steps, "
          f"kernel launches {launches}", flush=True)
    layers = model.num_layers
    if launches["prefill"] != layers * n_prefill or n_prefill == 0:
        fail(f"prefill kernel launched {launches['prefill']} times for "
             f"{n_prefill} chunks x {layers} layers")
    if launches["decode"] != layers * n_decode or n_decode == 0:
        fail(f"decode kernel launched {launches['decode']} times for "
             f"{n_decode} steps x {layers} layers")
    for req in (req_a, req_b, *batch):
        want = req.max_new_tokens
        if len(req.output) != want or not all(0 <= x < model.vocab_size
                                               for x in req.output):
            fail(f"request {req.request_id}: bad output {req.output}")
    if not step_ms:
        fail("no decode step ran at batch 8")

    # Event accounting: each pod's stored minus removed blocks are the
    # blocks it holds.
    for pod, evs in events.items():
        stored = sum(len(e.block_hashes) for e in evs if isinstance(e, BlockStoredEvent))
        removed = sum(len(e.block_hashes) for e in evs if isinstance(e, BlockRemovedEvent))
        cached = engines[pod].block_manager.num_cached_blocks()
        if stored - removed != cached:
            fail(f"{pod}: {stored} stored - {removed} removed != {cached} cached")
        print(f"{pod}: {stored} blocks stored, {removed} removed, {cached} cached",
              flush=True)
    # Engine keys are the canonical request keys, so the index holds the
    # union of the pods' blocks (prompt C's first 64 blocks are pod-0's too).
    keys = set().union(*(e.block_manager.blocks for e in engines.values()))
    if len(indexer.kv_block_index) != len(keys):
        fail(f"index holds {len(indexer.kv_block_index)} keys, pods {len(keys)}")
    expected = {"pod-0": 260 + 4 + 8 * 4,  # A, then 4 new blocks for B and each D
                "pod-1": len(warmup) // model.page_size + 68}
    for pod, n in expected.items():
        if engines[pod].block_manager.num_cached_blocks() != n:
            fail(f"{pod}: expected {n} cached blocks")

    logits_err = logits_parity(torch, model, params, prompt_a)
    # Where the device time goes: 4 decode steps at batch 8 over the warm
    # 4160-token contexts, and one cold 4160-token prefill (3 chunks).
    run_decode = decode_steps(target, [prefix + tokens(64) for _ in range(8)], 4)
    cold = tokens(4160)
    profile = {
        "decode_4_steps_b8": profile_window(torch, run_decode),
        "cold_prefill_4160": profile_window(
            torch, lambda: engines["pod-1"].add_request("P", cold, max_new_tokens=1)),
    }
    return dict(launches=launches, ttft_cold_ms=ttft_cold_ms,
                ttft_warm_ms=ttft_warm_ms,
                decode_ms_per_step=sum(step_ms) / len(step_ms),
                decode_steps_timed=len(step_ms), logits_err=logits_err,
                profile=profile)


def decode_steps(engine, prompts, n_steps):
    """Admit ``prompts`` (warm prefixes), prefill them, and return a
    callable that runs ``n_steps`` decode steps with every row decoding."""
    reqs = [engine.enqueue(f"prof{i}", p, max_new_tokens=n_steps + 2)
            for i, p in enumerate(prompts)]
    while any(r.prefill_pos is not None for r in reqs):
        engine.step()
    engine.step()  # the last request's first decode step

    def run():
        for _ in range(n_steps):
            engine.step()
    return run


def profile_window(torch, run):
    """Device time by kind of kernel over one call of ``run``
    (torch.profiler), beside the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kinds: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        if "decode_kernel" in name or "prefill_kernel" in name:
            kind = "paged_attention"
        elif any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            kind = "matmul"
        elif "index" in name or "scatter" in name or "gather" in name:
            kind = "index_gather_scatter"
        elif "elementwise" in name or "reduce" in name or "vectorized" in name:
            kind = "elementwise_reduce"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + ms
        kernels[ev.key[:80]] = kernels.get(ev.key[:80], 0.0) + ms
    busy = sum(kinds.values())
    out = {"wall_ms": wall_ms, "device_ms": kinds or "not measured"}
    if kinds:
        out["device_busy_share"] = busy / wall_ms
        out["top_kernels_ms"] = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])
    print(f"profile: {out}", flush=True)
    return out


def logits_parity(torch, model, params, prompt) -> float:
    """One prefill chunk (2048 tokens over a 2048-token prefix) through the
    kernels vs the same forward with the plain attention."""
    from llmd_kv_cache_tpu_torch.models.llama import (
        forward,
        forward_prefill,
        init_kv_cache,
    )

    num_pages = 4096 // model.page_size + 1  # page 0 is the garbage page
    k, v = init_kv_cache(model, num_pages, device="cuda")
    table = torch.zeros(1, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[0, :num_pages - 1] = torch.arange(1, num_pages, device="cuda")
    toks = torch.tensor([prompt[:4096]], dtype=torch.int64, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = torch.full((1,), 2048, dtype=torch.int32, device="cuda")
    forward_prefill(params, model, toks[:, :2048], k, v, table, zero, n,
                    last_only=True)
    k2, v2 = k.clone(), v.clone()
    got, _, _ = forward_prefill(params, model, toks[:, 2048:], k, v, table, n, n)
    ref, _, _ = forward(params, model, toks[:, 2048:], k2, v2, table, n, n,
                        plain_attention=True)
    torch.cuda.synchronize()
    if got.shape != (1, 2048, model.vocab_size) or not torch.isfinite(got).all():
        fail(f"prefill logits: shape {tuple(got.shape)} or non-finite values")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"prefill chunk logits, kernels vs plain attention: max_abs_err="
          f"{err:.4e}, max|logit|={scale:.4e} (tol {LOGITS_REL_TOL} relative)",
          flush=True)
    if err > LOGITS_REL_TOL * scale:
        fail("prefill chunk logits through the kernels disagree with the plain path")
    return err


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from llmd_kv_cache_tpu_torch.ops import cuda_build
        from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops
    except ImportError as exc:
        print(f"chip_smoke: the port package is not importable here ({exc}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2

    # 1. Environment
    smi = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {kind}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. Build
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load_library()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)
    kernel = None
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        found = re.search(r"(decode|prefill)_kernelILi(\d+)ELi(\d+)E", line)
        if found and "Compiling entry" in line:
            kernel = f"{found[1]}<head_dim {found[2]}, group {found[3]}>"
        elif kernel and ("registers" in line or "spill" in line):
            print(f"ptxas {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)

    # 3. Kernel parity
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = decode_parity(torch, ops, gen)
    pre = prefill_parity(torch, ops, gen)

    # 4. Main path
    run = main_path(torch, ops)

    # 5. Report
    kernels = [
        dict(name="paged_decode", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/paged_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:375",
             launches=run["launches"]["decode"], max_abs_err=dec["max_abs_err"],
             ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
             bound_by=dec["bound_by"], library_ms=None),
        dict(name="paged_prefill", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/paged_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:597",
             launches=run["launches"]["prefill"], max_abs_err=pre["max_abs_err"],
             ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
             bound_by=pre["bound_by"], library_ms=None),
    ]
    print(json.dumps({"timing": {
        "ttft_cold_ms": run["ttft_cold_ms"], "ttft_warm_ms": run["ttft_warm_ms"],
        "decode_ms_per_step_b8": run["decode_ms_per_step"],
        "decode_steps_timed": run["decode_steps_timed"],
        "prefill_logits_max_abs_err": run["logits_err"], "profile": run["profile"],
        "card": smi}}), flush=True)
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
