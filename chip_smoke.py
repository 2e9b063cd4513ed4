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
   The ptxas report must show no spill in the wgmma kernels (the latent
   prefill, the latent ragged kernel with and without its burst tail, and
   the GQA prefill and the ragged kernel over bf16 and fp8 pools, the
   ragged kernel with and without its tail) or the GQA decode (every
   shape, tail and pool type), and the wgmma kernels' SASS (``cuobjdump
   -sass``) must hold wgmma (HGMMA) instructions, the fp8 and tail
   instantiations' too; the count of each kernel is printed.
3. Kernel parity: each kernel against its plain PyTorch version on the card,
   in bf16, at the main paths' shapes (plus a sliding-window + sinks case
   each, and for the ragged kernel a mix of odd lengths with an empty row
   and rows at its decode arm's limit), every kernel held to an absolute
   term scaled to each row's output (``PARITY_ATOL``), and each kernel's
   time beside its bound, the plain version's and, for the GQA decode and
   prefill, one ``scaled_dot_product_attention`` call over the same keys
   gathered contiguous (an informational yardstick, not the same function):
   the GQA decode at b 8 over ctx 4160 (split across CTAs) and prefill at
   S 2048 over ctx 2048, the latent prefill at the three shapes of the MLA
   path (2048 tokens at ctx 0 and 2048, the warm 64 at 4096, split across
   CTAs), the ragged kernel at the shape classes the ragged pods launch
   (``RAGGED_TIMED``: the mixed dispatch, decode-only at 8 and 3 rows, the
   64-token chunk beside 8 decode rows, a 2048-token chunk alone), by
   kernel, with each launch's plan (key splits of both arms, the CTAs that
   carry work and their waves); a dispatch's kernels must be the ragged
   kernel and, when an arm splits, its combine pass, and nothing else.
   Both decode kernels' decode-burst tail arms are held against the plain
   version with a tail (8 slots: contexts 1-4160 with tails of 0, 1, 5 and
   8 and a padded row; SWA 1000 + sinks 20; a window of 4 the tail
   outruns, with rows below the 20 sinks; latent widths 576 and 640 and MQA
   128 x 16 heads) and timed at b 8, ctx 4160 with and without the tail.
   The ragged kernel's last two arms: its ``shared_kv`` arm (the latent
   ragged kernel) at D 576 on the MLA pod's mixed dispatch (8 decode rows
   over 4160 latents + a 2048-token chunk at ctx 2048), decode-only ones of
   8 and 3 rows, the 64-token chunk over 4096 cached latents alone and
   beside 8 decode rows, a 2048-token chunk alone (the six timed as the GQA
   shapes are; the 64-token chunk's tiles must be planned split across
   CTAs, the 2048-token chunks' unsplit), an odd mix (an empty row, 2- and
   3-token rows, a 1-token row at ctx 0) and SWA 1000 + sinks 20, and at D
   640 the odd mix; its tail arm on the GQA
   ragged kernel (bf16 and fp8 pools) and on the latent one, with the
   decode kernels' tail cases as 1-token rows beside a prefill row of tail
   0, timed at 8 decode rows over 4160 keys with and without an 8-token
   tail.
4. Main path at full width: two ``MiniEngine`` pods of the bench's 0.9B
   paged Llama (random weights from a seed) feed their KV events into one
   ``Indexer``; a 4160-token prompt is served cold, a second prompt with the
   same 4096-token prefix is scored, routed to the warm pod and served with
   its prefix reused, then 8 more are enqueued and decoded to 16 tokens each.
   The kernels' launch counters are zeroed just before and read just after.
   Then one prefill chunk's logits through the kernels are held against the
   same forward with the plain attention.
5. Report (printed last): one ``{"kernels": [...]}`` line (the two decode
   kernels' entries, and the three ragged ones, bf16, fp8 and latent, with
   their ``tail_*`` fields), the timing lines, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.
6. The ragged path: a third pod, ``pod-r`` (``ragged_attention=True``),
   warms the 4096-token prefix, serves the main path's 8 prompts and then a
   cold 4160-token prompt whose chunks ride beside the 8 decode rows, with
   every launch counter zeroed just before and read just after (ragged
   launches = layers x dispatches, none of the padded kernels, and the
   ragged launches by shape class: flat tokens / rows), routes a
   prompt sharing the cold prefix to ``pod-r`` with 260 blocks, and holds
   one mixed dispatch's logits against the plain attention. One decode
   step's logits through the decode kernel, through the ragged kernel's
   decode arm and with the plain attention are each measured against the
   fp32 forward (printed, not held). Then the host
   time of a mixed step (8 decode rows + a 2048-token chunk) and of a
   decode step at batch 8 on ``pod-r`` beside the padded ``pod-0``, with a
   profile of the mixed step on each.
7. The absorbed-MLA path: a fourth pod, ``pod-m``, serves DeepSeek-V2-Lite's
   attention at full width (27 layers, latent rank 512 + rope 64, 16 heads,
   every MLP dense; 2.6B params, random weights from a seed) under its own
   model name on the same ``Indexer``: a cold 4160-token prompt, a second
   prompt with the same 4096-token prefix routed to ``pod-m`` (256 blocks,
   ``cached_len`` 4096), then 8 prompts decoded to 16 tokens at batch 8.
   Every counter is zeroed just before and read just after: latent decode
   launches = 27 x decode steps, latent prefill launches = 27 x chunks
   (and by shape class: chunk length / key splits), no GQA or ragged
   launch, every stored block tagged ``mla_attention``. Then
   one prefill chunk's and one decode step's logits against the plain
   attention, and profiles of 4 decode steps and a cold prefill.
8. Fused decode bursts: ``pod-b`` (the GQA model, ``pod-0``'s params) and
   ``pod-mb`` (the MLA model, ``pod-m``'s params), both with
   ``decode_burst=8``, on the same ``Indexer``. Each captures its burst
   graph in a warm-up; then, counters zeroed just before and read just
   after, serves a cold prompt on its own prefix, routes a second one to
   itself (256 blocks, ``cached_len`` 4096), and decodes the single-step
   pod's 8 batch prompts to 16 tokens: decode launches = layers x 8 x
   bursts, no single-step decode dispatch (greedy agreement with the
   single-step pod printed, not held). A burst replayed from the graph and
   the same burst run eagerly through the kernels from identical caches
   must give the same tokens; one burst tick's logits at tail length 8
   must be within 5% of the plain attention's. Then host ms per generated
   token at batch 8, burst pod beside single-step pod in turns, with a
   profile of one step each.
9. The offload path: a store in a temporary directory (removed at the end;
   its filesystem type printed, since a page-cache read is not a
   shared-storage read). ``pod-o`` (the GQA model, ``pod-0``'s params, a
   posix store of one block a file with crc32 footers) serves a cold
   4160-token prompt to 16 tokens and flushes: 260 block files under
   ``<root>/<model>_<fingerprint>``, 16 sampled files' payloads bit-equal to
   the pool's pages. A fresh ``pod-o2`` takes a second prompt with the same
   4096-token prefix through ``add_request``: 256 blocks restored,
   ``cached_len`` 4096, one 64-token prefill chunk (16 launches), restored
   pages bit-equal to ``pod-o``'s, the same 16 tokens as ``pod-0`` (the
   same params, no store) computing that prompt cold. A fresh ``pod-o3``
   decodes 8 rows and takes a third such prompt through ``enqueue``: the
   rows' tokens and the prompt's equal ``pod-0``'s without a restore (the
   steps the restore was in flight and their host times printed).
   ``pod-mo``/``pod-mo2`` do the same round trip on the MLA model (one
   stream, 27 layers, blocks tagged ``mla_attention``). Every kernel
   counter is zeroed just before each pod's run and read just after. Then,
   for both models, the write-through and the restore of 256 blocks split
   into legs (gather + device-to-pinned copy, CRC footer, kvio write; kvio
   read from the page cache and after evicting it, pinned-to-device copy +
   scatter), one contiguous pinned copy each way as a yardstick, and TTFT
   cold, restored from storage and HBM-warm, printed on an ``offload``
   line before the kernels line.
10. fp8 (e4m3) KV pools: the card's cast of all 65,536 bf16 patterns and
   of fp32 values around every e4m3 midpoint must equal the same cast on
   the CPU; the decode (with its tail), prefill and
   ragged kernels' fp8 arms are held against the plain version over the
   same fp8 pools at phase 3's cases (SWA 1000 + sinks 20 among them) and
   timed, their SDPA yardstick attending over the keys upcast; the decode
   is timed at b 32 over ctx 2048, bf16 and fp8 in turns (these run right
   after phase 3, before any profile of the serving phases). ``pod-f``
   (padded), ``pod-fr`` (ragged) and ``pod-fb`` (bursts of 8), with
   ``kv_cache_dtype="f8_e4m3"``, 2048 pages and ``pod-0``'s params, serve
   phase 8's traffic (phase 6's for ``pod-fr``) under their own model name:
   with counters zeroed just before and read just after, every GQA launch
   is an fp8 one (layers x steps, dispatches or ticks) and no plain
   attention runs; ``pod-fb``'s graph burst equals its eager one.
   ``pod-fo`` writes an fp8 store (260 files) that a fresh ``pod-fo2``
   restores (256 blocks, pages bit-equal, ``pod-f``'s 16 tokens). One
   prefill chunk's, one mixed dispatch's and one burst tick's logits
   through the fp8 arms are held against the plain attention over the same
   fp8 pools (5%); fp8 against bf16 logits, greedy agreement with
   ``pod-0`` and host ms per token beside ``pod-0``/``pod-b`` are printed
   on an ``fp8`` line, and the three fp8 arms join the kernels line.
11. Absorbed MLA on the ragged scheduler: ``pod-mr``, a ragged pod of the
   MLA model (``pod-m``'s params and EngineConfig with
   ``ragged_attention=True``, 1024 pages) on the same ``Indexer``, serves
   ``pod-r``'s traffic over ``pod-m``'s prefix and batch, counters zeroed
   just before and read just after: ragged launches = 27 x dispatches,
   every one on the ``shared_kv`` arm, no latent decode or prefill or GQA
   launch, no plain attention call, blocks tagged ``mla_attention``,
   ``stored - removed == cached``, the cold prompt + 64 routed to
   ``pod-mr`` with 260 blocks, the launches by shape class showing every
   64-token chunk's tiles split across CTAs and every 2048-token chunk's
   unsplit; one mixed dispatch's and three q72 dispatches' (8 decode rows
   beside a 64-token row over 4096 cached, three seeds) logits within 5% of
   the plain attention's, the q72 dispatches' kernel (also with its prefill
   tiles unsplit) and plain logits against an fp32 forward (printed). Printed, not held: greedy agreement with ``pod-m``,
   host ms of a mixed step and of a decode step at batch 8, ``pod-mr``
   beside ``pod-m`` in turns, a profile of one mixed step each, and the
   phase's wall time, on an ``mla_ragged`` line.
12. Disaggregated prefill/decode serving: ``pod-p`` (``role="prefill"``),
   ``pod-d`` (``role="decode"``, a CoDel shedder at 0.5 s / 0.1 s) and
   ``pod-d2`` (``role="both"``), the GQA model with ``pod-0``'s params,
   1024 pages each, on one posix store in a temporary directory (removed
   at the end); one ``HandoffCoordinator`` with a ``ResidencyTracker``
   (attached to the ``Indexer`` too) joins ``pod-p`` and ``pod-d``.
   ``pod-d`` serves a cold 4096-token prefix and decodes 7 of the main
   path's 8 prompts; then, counters zeroed just before and read just
   after each run: a fresh 4160-token prompt H is prefilled on ``pod-p``
   (3 chunks, each committed to the store as it is computed) and decoded
   on ``pod-d`` (``enqueue(handoff=True)``). Held: right after ``pod-p``'s
   first chunk landed, ``score_tokens(H, role="decode")`` gives ``pod-d``
   exactly 128.0 (all residency) and no role gives it nothing; every local
   row emits a token at every ``pod-d`` step while H waits; H settles
   "complete" with 260 restored blocks and ``cached_len`` 4160; ``pod-p``
   launches the prefill kernel 16 x 3 times and no decode kernel, ``pod-d``
   16 prefill launches (one 1-token chunk) and 16 decode launches a decode
   step; no plain attention call; 16 sampled restored pages equal
   ``pod-p``'s; H's tokens equal ``pod-d2``'s, which restores the same 260
   blocks through ``add_request``. Then a fresh prompt F: ``pod-p`` lands
   chunk 1 (128 blocks), ``pod-d`` pulls it, ``pod-p`` aborts F: F settles
   "fallback", ``pod-d`` keeps the 128 blocks and prefills 2048 + 64
   tokens, and its tokens equal ``pod-0``'s for F cold. Last, ``pod-d2``
   takes F through ``enqueue(deadline_s=0)``: no restore starts, the skip
   is counted, ``cached_len`` 0, ``pod-0``'s tokens. A ``disagg`` line
   (TTFTs, ``pod-p``'s host ms a chunk, ``pod-d``'s pulls, the rows' step
   ms with and without a pull in flight, the shedder's stats, the phase's
   wall time) precedes the kernels line.

13. The model families' attention layouts at public widths, after the
   earlier phases' pods and weights are freed (the device memory left and
   phase 13's peak, ``torch.cuda.max_memory_allocated``, printed). First
   the GQA kernels at group 4 (32 query heads over 8 kv heads of 128)
   against their plain versions at the pods' windows (none, 4096 with 4
   sinks, 1024): the decode over ragged contexts, its tail arm (the tail
   cases and 8 rows over 4160 keys with an 8-token tail), the prefill at
   the cold prompt's chunks, the ragged kernel at window 4096 over mixed
   dispatches; then the decode (8 rows over 4160 keys) and prefill (S 2048
   over ctx 2048), unwindowed and at windows 4096 and 1024, each checked
   and timed beside its bound over the keys the window leaves and an SDPA
   yardstick.
   Then, with random weights from a seed and one window-aware Indexer
   (``HybridAware``, the Pool's GroupCatalog attached), each pod serving
   phase 4's traffic (a warm-up, then counters zeroed: a cold 4160-token
   prompt, a routed prompt, 8 prompts decoded to 16 tokens):
   Mistral-7B-v0.1 (window 4096 on every layer) as ``pod-w`` (padded:
   routed with 256, ``cached_len`` 4096, launches = 32 x chunks and steps,
   no plain call, every block ``sliding_window`` 4096; the cold prompt's
   2048-token chunk over 2048 keys and 64-token chunk over 4096, every
   position's logits, through the kernels no further from the fp32
   forward than 1.1 x the plain attention's rms distance, and the 64-token
   chunk's more than 5% of max|logit| from the same weights' with no
   window), ``pod-wr``
   (ragged, phase 6's traffic, routed with 256: the window caps the
   score; a mixed dispatch's logits at 5% of the plain attention's) and
   ``pod-ws`` (4 sinks, bursts of 8: ``sink_full_attention`` blocks, a
   graph burst equal to the eager one, logits as ``pod-w``'s); the hybrid
   stand-in (Mistral's
   weights, Gemma 3's layout: layers 5, 11, 17, 23 and 29 global, the rest
   at window 1024, two pools) as ``pod-h`` (routed and batch prompts
   continue the cold one: 64.0 by window-aware scoring, ``cached_len``
   4160; the prompt sharing only the 4096-token prefix does not score;
   both groups cataloged; both managers' free pages after the traffic
   equal a CPU twin's on the same traffic), ``pod-hb`` (bursts of 8, graph
   equal to eager over both pools) and ``pod-ho`` -> ``pod-ho2`` (a
   hybrid store: 260 group-0 and 64 group-1 files; an all-or-nothing
   restore of 260 blocks, pages bit-equal in both groups, tokens equal the
   writer's), ``pod-h``'s logits as ``pod-w``'s; Qwen3-8B (QK-norm) as
   ``pod-q`` (routing, 36 launches a dispatch, logits as ``pod-w``'s, less
   the window). A failed logits check fails the phase
   at its end, after every other check. A ``families`` line (each pod's host ms for
   cold and warm TTFT and a decode step at batch 8, launches, routing, the
   G 4 times) precedes the kernels line, whose decode and prefill entries
   carry the G 4 times and the phase's launches.

14. Tensor-parallel serving at tp 2. In this process: the latent kernels'
   8-head instantiations (a rank's half of DeepSeek-V2-Lite's 16 heads over
   the replicated latent) against their plain versions (the decode at D 576
   and 640 over contexts 1..4160 with a padded row, SWA 1000 + 20 sinks,
   its tail arm; the prefill at the MLA path's chunks, an odd chunk and D
   640), timed beside their bounds (b 8 over 4160 latents with and without
   an 8-token tail; S 2048 over ctx 2048 and at ctx 0, S 64 over 4096); both
   sharded wrappers at a rank's shapes of both models (8 query heads over 4
   kv heads of 128; 8 heads over the whole latent) against the plain
   sharded versions, one wrapper and one kernel launch a call, timed. Then
   two ranks, spawned (``parallel.mesh.spawn_tp``: gloo when they share the
   one card, NCCL when each has its own, printed), serve ``pod-t`` (the GQA
   bench model) and ``pod-mt`` (DeepSeek-V2-Lite attention as ``pod-m``)
   through ``MiniEngine(tp=group)`` with ``pod-0``'s and ``pod-m``'s
   traffic, rank 0 feeding one Indexer. Held, exact, on each rank: the
   routed prompt first with 256 blocks and ``cached_len`` 4096; launches =
   layers x dispatches through the sharded wrappers and their kernels, no
   other launch, no plain call; rank 0's BlockStored hashes of the counted
   run equal ``pod-0``'s (``pod-m``'s), rank 1 hands its sink nothing;
   ``pod-mt``'s latent pools bit-equal across the ranks; the ranks' tokens
   equal. The cold prompt's second 2048-token chunk, every position,
   through tp 2 and through the tp 1 kernels (bf16, the same weights),
   each against the tp 1 forward in fp32 (weights upcast, plain
   attention): tp 2's rms distance from fp32 at most FP32_DISTANCE_RATIO x
   tp 1's (its max distance from tp 1, against 5% of max|logit|, is
   printed). The ranks make the weights on the card from the seed, move
   them to the host, and hand the engines that host tree: each rank's card
   then holds only its shard. Printed: greedy agreement with ``pod-0``/``pod-m``, cold and warm TTFT,
   the decode step at batch 8, the all-reduce's host ms (under gloo staged
   through the host: nothing of NVLink), the phase's wall time and each
   process's peak memory, on a ``tp`` line; the kernels line gains the
   8-head latent arms and both sharded wrappers.

15. Mixture-of-experts serving at public widths, after phase 14's memory
   is freed. First the MoE layer of each router on the card against the
   same layer on the CPU, in fp32 on 16 tokens from a seed: Moonlight's
   widths (DeepSeek-V3's sigmoid router over 64 experts of 1408, top 6,
   a non-zero ``router_bias``, 2 shared experts) and Mixtral-8x7B's (8
   experts of 14336, top 2, the capacity dispatch at factor 0.5 so that
   assignments drop): the chosen experts and the kept assignments equal,
   the outputs within 1e-4 of the CPU's largest |output|. Then, random
   weights from a seed, one Indexer, each pod under its own model name and
   with phase 13's traffic (``family_pod``; ``ragged_path`` for the ragged
   pods, the cold prompt's chunks beside 8 decode rows): Moonlight-16B-A3B
   at full width and depth (``moonlight_model``: 27 layers, layer 0 dense,
   the exact dense dispatch) as ``pod-e`` (padded), ``pod-eb`` (bursts of
   8: a graph burst equal to the eager one, the MoE layer inside the
   graph) and ``pod-er`` (ragged), every launch on the latent kernels (27 x
   dispatches), every block ``mla_attention``; Mixtral-8x7B-v0.1's widths
   at 8 of its 32 layers (``mixtral_model``, the capacity dispatch at
   factor 2) as ``pod-x`` (padded) and ``pod-xr`` (ragged: every capacity
   its MoE layers computed is ceil(t_pad * 2 * 2 / 8) with t_pad the JAX
   ragged engine's flat length, one line a shape class). Held as phase
   13's pods: routing (256, 260 for the ragged pods' cold prompt),
   ``cached_len`` 4096, launches, no plain call, and each model's 2048-
   and 64-token chunks' logits no further from the fp32 forward (the fp32
   copy made one layer at a time) than 1.1 x the plain attention's.
   Printed: TTFT cold and warm, the decode step at batch 8, host ms a token
   in bursts, the ragged pods' mixed step; device time by kind (attention
   kernels, the expert layers' GEMMs and their other work) over 4 decode
   steps and a cold prefill of ``pod-e`` and ``pod-x``; the MoE layer alone
   at a decode step's 8 tokens and a 2048-token chunk beside the bounds of
   every expert's bytes and of the routed work alone; on a ``moe`` line
   before the kernels line, whose latent and GQA entries gain the phase's
   launches.

17. Observability, run first, right after the build: its capture must
   come before any scheduled profiler session (``device_ms``), after which
   a capture recorded no kernel, and a process holds one profiler session
   at a time. The bench model
   at full width as ``pod-tel`` (padded), ``pod-telb`` (bursts of 8) and
   ``pod-telr`` (ragged), each with ``EngineConfig(telemetry=
   EngineTelemetryConfig(profile_dir=...))``, on one Indexer with an
   AuditLog and a WorkingSetTracker attached and one recording span
   exporter installed, each beside a twin with ``telemetry=None`` on the
   same weights and prompts. Phase 4's traffic, each pod's counters zeroed
   just before it and read just after: launches = 16 x dispatches (16 x 8 a
   burst replay, every burst from the graph), no plain call; routing 256,
   ``cached_len`` 4096. Held: the routed request's route, ``score_tokens``,
   admission, prefill-chunk and decode-step spans in one trace, each the
   root's child, and no engine span of an untraced request; histogram
   deltas 10 TTFT, 135 ITL, 9 TPOT and one step time a step; monotone
   timestamps and ``prefix_hit_blocks`` 256; pool gauges equal to
   ``pool_stats()``; the routed request's audit outcome (``hbm_blocks``
   256) joined to its prediction; the flight records; tokens equal the
   twin's. Then, printed: decode-step p50s and host ms a token with
   telemetry on and off, in turns; a 1 s ``ProfilerCapture`` on a thread
   of its own while ``pod-tel`` and ``pod-telb`` decode, whose Chrome trace
   must name the decode kernel, a second capture during it raising
   ``ProfileInProgress`` (one step profiled on the main thread first, so
   that the process's first session is the serving thread's); and JAX's
   analytic hook-cost gate (``on_step`` +
   8 rows' ``on_decode_tokens``, timed on this host, under 1% of the
   decode-step p50, single steps and bursts). A ``telemetry`` line
   precedes the kernels line, whose GQA entries gain the phase's launches.

It exits non-zero, printing no result, when CUDA is unavailable or the port
package is not beside it.

    python3 chip_smoke.py --kernel-times [--root DIR]

times only the GQA decode (with and without a tail), the GQA prefill, the
latent prefill and both ragged kernels (GQA over bf16 and fp8 pools,
latent) at the shapes above, the GQA decode and prefill at group 4
unwindowed and at windows 4096 and 1024 (phase 13's), each launch checked
against its plain version first, and one decode step's logits against the
fp32 forward, with the port package of the checkout at DIR, so that two
checkouts can be timed in turns on one card.

    python3 chip_smoke.py --families

builds the kernels and runs phase 13 alone: a shortcut while working on
it, whose output is not the smoke's result (only the full run's is).

    python3 chip_smoke.py --moe

does the same for phase 15, and ``--telemetry`` for phase 17.

"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Parity tolerance for the bf16 kernels against the plain version, one for
# every kernel: |kernel - plain| <= PARITY_ATOL * min(1, rms of the row's
# plain output) + PARITY_RTOL * |plain|, a row being one entry of the
# compared tensor's first axis (a decode row, a prefill token, a ragged
# row's tokens). The two versions round p to bf16 at different points (the
# flash kernels round the unnormalised p of each key chunk, the plain
# version the normalised probabilities) and both round the output to bf16,
# so they may differ by about two bf16 ulps (2^-7 relative each) of the
# output; fp32 summation order adds far less. The absolute term is scaled
# to the data: over N keys an output coordinate has an rms of about sqrt(e
# / N) (0.026 at 4160 keys), so a flat 2e-2 would pass an error of the
# output's own size; the p roundings of a correct kernel move an output by
# ~1e-3 of that rms.
PARITY_ATOL = 2e-2
PARITY_RTOL = 2e-2

# Logits of one prefill chunk through the kernels vs the plain attention:
# the per-layer differences above (a bf16 ulp or two of the attention
# output) pass through 16 residual layers (27 for the MLA model) and the
# lm_head. Relative to the largest logit.
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


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without its namespace, return type and
    arguments: "latent_decode_kernel<576, 16, true, false>"."""
    key = key.replace("(anonymous namespace)::", "").split("(")[0]
    return key[5:] if key.startswith("void ") else key


def device_ms(fn, iters: int = 20, by_kernel: bool = False):
    """Mean device time of one call of ``fn``: the summed device time of
    every CUDA kernel it launches (torch.profiler), over ``iters`` calls
    after a warm-up. Unlike ``time_ms`` it does not count the device idling
    while the host enqueues, which dominates a call whose kernels take less
    time than its host work. With ``by_kernel`` also each kernel's share,
    {kernel_name: ms a call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # A profiler session now and then records no device activity at all
    # (seen on the first session of a process), or only part of it (a GQA
    # prefill read 0.144 ms where CUDA events read 0.232 in the same run; a
    # ragged dispatch 15 of 20 launches in each of three sessions in a row;
    # a latent ragged launch 19 of 20 in five sessions in a row): every call
    # of fn launches the same kernels, so a complete session counts each a
    # multiple of iters times. Each session traces a warm-up cycle of iters
    # calls that it discards (the profiler's schedule), then counts the next
    # cycle; one that is not complete is taken again, up to four times.
    best = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up cycle, then the counted one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # The schedule's own step annotation ("ProfilerStep*") is no kernel.
        device = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and not ev.key.startswith("ProfilerStep") and ev.count > 0]
        if device and all(ev.count % iters == 0 for ev in device):
            return _per_call(device, iters, by_kernel)
        if sum(ev.count for ev in device) > sum(ev.count for ev in best):
            best = device
    # No complete session: each kernel's mean recorded launch, times its
    # launches a call, where every kernel lost less than half a cycle's
    # launches (so its launches a call are the count rounded up to iters).
    counts = json.dumps({kernel_name(ev.key)[:60]: ev.count for ev in best})
    if best and all(ev.count >= (math.ceil(ev.count / iters) - 0.5) * iters for ev in best):
        print(f"chip_smoke: device_ms: no complete profiler session in 5; {iters} calls "
              f"estimated from the recorded launches {counts}", file=sys.stderr)
        return _per_call(best, iters, by_kernel)
    if not best and not by_kernel:
        # No device activity recorded at all: the device time between CUDA
        # events instead, which also counts the device idling on the host.
        print(f"chip_smoke: device_ms: the profiler recorded no device activity in 5 "
              f"sessions; timed between CUDA events", file=sys.stderr)
        return time_ms(fn, iters)
    fail(f"the profiler recorded no complete session of device activity (most recorded "
         f"over {iters} calls: {counts})")


def _per_call(device, iters: int, by_kernel: bool):
    """``device_ms``'s result from a session's kernels: each kernel's mean
    launch time times its launches a call (the count rounded up to iters, so
    a complete session gives its total over iters)."""
    ms: dict[str, float] = {}
    for ev in device:
        name = kernel_name(ev.key)
        ms[name] = ms.get(name, 0.0) + (ev.self_device_time_total / ev.count
                                        * math.ceil(ev.count / iters) / 1e3)
    total = sum(ms.values())
    return (total, ms) if by_kernel else total


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernel parity at the main path's shapes
# ---------------------------------------------------------------------------

KV_HEADS, Q_HEADS, HEAD_DIM, PAGE = 8, 16, 128, 16
PAGES_PER_SEQ = 272
MLA_HEADS = 16  # DeepSeek-V2-Lite's query heads over the one latent head


def random_pool(torch, gen, num_pages, fp8=False):
    """A bf16 K/V pool of random values (page 0, the garbage page, too, so
    a read past a sequence's keys shows up), or with ``fp8`` the same
    values cast into an fp8 e4m3 pool as the engine casts them."""
    shape = (num_pages, KV_HEADS, PAGE, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return (as_pool(torch, k, fp8), as_pool(torch, v, fp8))


def as_pool(torch, x, fp8):
    """``x`` in an fp8 pool (the engine's cast, ``to_kv_dtype``), or as it is."""
    from llmd_kv_cache_tpu_torch.ops.kv_pages import to_kv_dtype

    return to_kv_dtype(x, torch.float8_e4m3fn) if fp8 else x


def kv_tag(fp8) -> str:
    return "fp8 " if fp8 else ""


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


def check_close(name, got, ref, atol=None, atol_text=None) -> float:
    """Fails unless |got - ref| <= atol + PARITY_RTOL * |ref| everywhere;
    ``atol`` (a tensor that broadcasts) is ``rms_atol(ref)`` by default."""
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    if atol is None:
        atol, atol_text = rms_atol(ref)
    err = (got - ref).abs()
    # An exact element (err 0) meets any tolerance, a zero one included; any
    # other error over a zero tolerance is an infinite ratio, and fails.
    tol = atol + PARITY_RTOL * ref.abs()
    ratio = float(torch.where(err == 0, 0.0, err / tol).max())
    max_err = float(err.max())
    print(f"parity {name}: max_abs_err={max_err:.3e}, worst |err|/tol={ratio:.3f} "
          f"(tol {atol_text} + {PARITY_RTOL}*|plain|)", flush=True)
    if not ratio <= 1:  # NaN fails too
        fail(f"{name}: kernel disagrees with the plain version "
             f"(max_abs_err {max_err:.3e})")
    return max_err


def decode_parity(torch, ops, gen, fp8=False) -> dict:
    """Decode kernel vs plain: B 8, ragged contexts incl. a padded row (with
    ``fp8``, over an fp8 pool: the kernel's fp8 arm)."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    decode = ops.cuda_paged_decode_attention
    tag = kv_tag(fp8)
    lens = [1, 17, 300, 1024, 2049, 3001, 4160, 0]  # row 7: padded (total 0)
    num_pages = sum((n + PAGE - 1) // PAGE for n in lens) + 64
    k, v = random_pool(torch, gen, num_pages, fp8)
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
        fail(f"{tag}decode: a padded row (total_len 0) did not return zeros")
    err = check_close(f"{tag}decode", out[live], plain()[live])
    window, sinks = (1000, 20) if fp8 else (500, 20)
    out = decode(q, k, v, table, ctx, sliding_window=window, sinks=sinks)
    torch.cuda.synchronize()
    err = max(err, check_close(f"{tag}decode swa{window}+sinks{sinks}", out[live],
                               plain(window, sinks)[live]))
    timing = decode_timing(torch, ops, gen, 0, fp8=fp8)
    return dict(timing, max_abs_err=max(err, timing["max_abs_err"]))


def contiguous_kv(torch, cache, table, rows, length):
    """Row r's first ``length`` keys of a paged cache gathered in order into
    a contiguous [rows, kv_heads, length, head_dim] tensor (an fp8 pool's
    upcast to bf16: the yardstick attends over what the kernel attends)."""
    pages = -(-length // PAGE)
    x = cache[table[:rows, :pages].long()]  # [rows, pages, kv_heads, PAGE, D]
    return x.permute(0, 2, 1, 3, 4).reshape(rows, KV_HEADS, pages * PAGE, HEAD_DIM)[
        :, :, :length].to(torch.bfloat16).contiguous()


def sdpa_yardstick(torch, name, q, k, v, want, mask=None) -> float:
    """Device ms of one torch scaled_dot_product_attention call (flash
    backend, GQA) on q [B, Hq, S, D] and keys gathered contiguous [B, Hkv,
    L, D]: an informational yardstick, contiguous and not paged, so not the
    same function as the kernel's; the port never calls it. Its distance
    from the kernel's output ``want`` is printed beside it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    got = call().transpose(1, 2)
    torch.cuda.synchronize()
    ms = device_ms(call)
    diff = float((got.reshape(want.shape).float() - want.float()).abs().max())
    print(f"{name}: scaled_dot_product_attention (flash, contiguous, not paged) "
          f"{ms:.4f} ms on the device; max |sdpa - kernel| {diff:.3e}", flush=True)
    return ms


def decode_timing(torch, ops, gen, tail_slots, batch=8, ctx_len=4160, fp8=False,
                  q_heads=Q_HEADS, window=None) -> dict:
    """The GQA decode at the main path's decode shape, 8 rows over 4160
    paged keys (or ``batch`` rows over ``ctx_len``; with a burst tail of
    ``tail_slots`` keys a row when > 0; over an fp8 pool with ``fp8``; at
    ``q_heads`` query heads over the 8 kv heads; with a sliding ``window``,
    whose bound and yardstick count only the keys it leaves), checked
    against its plain version first: the kernel's device ms (the
    profiler's, combine pass included, by kernel in ``by_kernel``: a split
    launch takes less device time than host time, so back-to-back CUDA
    events, kept as events_ms, would time the host) beside its bound and the plain version's, its key
    splits (planned over the table's capacity, whatever the window), and
    without a tail the SDPA yardstick; with a tail also the same inputs'
    device ms without it."""
    decode = ops.cuda_paged_decode_attention
    lens = [ctx_len] * batch
    k, v, table, ctx, tk, tv, tl = tail_case(torch, gen, lens, [max(tail_slots, 1)] * batch,
                                             KV_HEADS, HEAD_DIM, fp8)
    q = torch.randn(batch, q_heads, HEAD_DIM, generator=gen,
                    device="cuda").to(torch.bfloat16)
    tails = dict(tail_k=tk, tail_v=tv, tail_lens=tl) if tail_slots else {}

    def kernel():
        return decode(q, k, v, table, ctx, sliding_window=window, **tails)

    def plain():
        return plain_tail(q, k, v, table, ctx, *((tk, tv, tl) if tail_slots else (None,) * 3),
                          window=window)

    name = (f"{kv_tag(fp8)}decode{'' if q_heads == Q_HEADS else ' g' + str(q_heads // KV_HEADS)}"
            f" b{batch} ctx{ctx_len}" + (f" swa{window}" if window else "")
            + (f" + tail {tail_slots}" if tail_slots else ""))
    out = kernel()
    splits = getattr(decode, "last_splits", None)  # the plan this launch ran
    err = check_close(name, out, plain())
    (ms, by_kernel), events_ms = device_ms(kernel, by_kernel=True), time_ms(kernel)
    plain_ms = device_ms(plain, iters=5)
    seen = min(ctx_len, window or ctx_len)  # paged keys a row attends
    keys = batch * (seen + tail_slots)
    nbytes = (keys * KV_HEADS * HEAD_DIM * 2 * k.element_size()  # K and V
              + 2 * q.numel() * 2 + table.numel() * 4 + ctx.numel() * 4
              + (tl.numel() * 4 if tail_slots else 0))
    b_ms, b_by = bound_ms(nbytes, 4 * q_heads * HEAD_DIM * keys)  # QK^T and PV
    res = dict(max_abs_err=err, ms=ms, events_ms=events_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, splits=splits, by_kernel=by_kernel)
    extra = ""
    if tail_slots:
        res["no_tail_ms"] = device_ms(
            lambda: decode(q, k, v, table, ctx, sliding_window=window))
        extra = f" (without the tail {res['no_tail_ms']:.4f})"
    else:  # the keys the window leaves, the last ``seen``, contiguous
        res["sdpa_contiguous_ms"] = sdpa_yardstick(
            torch, name, q[:, :, None],
            contiguous_kv(torch, k, table, batch, ctx_len)[:, :, ctx_len - seen:].contiguous(),
            contiguous_kv(torch, v, table, batch, ctx_len)[:, :, ctx_len - seen:].contiguous(),
            out)
    print(f"{name}: {ms:.4f} ms/launch on the device{extra} ({events_ms:.4f} ms between "
          f"CUDA events, back to back; by kernel {json.dumps(by_kernel)}), {splits} key "
          f"splits a (row, kv head), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return res


TAIL_SLOTS = 8  # the burst pods' decode_burst


def tail_case(torch, gen, lens, tail_lens, kv_heads, width, fp8=False):
    """A pool (``random_pool`` or a single-head latent pool), its page table
    and a dense decode-burst tail [batch, TAIL_SLOTS, kv_heads, width] of
    random values (K and V), bf16 or, with ``fp8``, pool and tail fp8 as the
    engine keeps them, with its lengths."""
    num_pages = sum((n + PAGE - 1) // PAGE for n in lens) + 64
    if kv_heads == KV_HEADS:
        k, v = random_pool(torch, gen, num_pages, fp8)
    else:
        k, v = latent_pool(torch, gen, num_pages, width), latent_pool(torch, gen, num_pages, width)
    table = page_table_for(torch, gen, lens, num_pages)
    shape = (len(lens), TAIL_SLOTS, kv_heads, width)
    tail_k, tail_v = (as_pool(torch, torch.randn(shape, generator=gen, device="cuda")
                              .to(torch.bfloat16), fp8) for _ in range(2))
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tl = torch.tensor(tail_lens, dtype=torch.int32, device="cuda")
    return k, v, table, ctx, tail_k, tail_v, tl


def plain_tail(q, k, v, table, ctx, tail_k, tail_v, tl, window=None, sinks=None):
    """The plain version with a tail (the query at ctx + tail_len - 1), or
    without one when ``tail_k`` is None (at ctx - 1)."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    q_end = ctx if tail_k is None else ctx + tl
    return paged_attention(q[:, None], k, v, table, (q_end - 1)[:, None], ctx,
                           sliding_window=window, attention_sinks=sinks, tail_k=tail_k,
                           tail_v=tail_v, tail_lens=tl)[:, 0]


# Tail parity cases: (name, paged contexts, tail lengths, window, sinks). Row
# 7 is padded (no key at all). With SWA 1000 the window start moves with the
# tail; with window 4 the tail outruns the window and rows below 20 keys
# keep their tail slots at sink positions attendable.
TAIL_CASES = [
    ("t8", [1, 17, 300, 1024, 2049, 3001, 4160, 0], [8, 5, 1, 0, 8, 5, 8, 0], None, None),
    ("t8 swa1000+sinks20", [1, 10, 300, 1024, 2049, 3001, 4160, 0],
     [8, 8, 1, 0, 8, 5, 8, 0], 1000, 20),
    ("t8 swa4+sinks20", [0, 3, 10, 19, 40, 1000, 4160, 0], [8, 8, 8, 5, 8, 1, 8, 0], 4, 20),
]


def decode_tail_parity(torch, ops, gen, fp8=False) -> dict:
    """GQA decode kernel's tail arm vs the plain version with a tail, and
    its time at b 8, ctx 4160 with and without an 8-token tail
    (``decode_timing``); with ``fp8`` the fp8 arm, pools and tail fp8."""
    decode = ops.cuda_paged_decode_attention
    err = 0.0
    for name, lens, tails, window, sinks in TAIL_CASES:
        name = kv_tag(fp8) + name
        k, v, table, ctx, tk, tv, tl = tail_case(torch, gen, lens, tails, KV_HEADS, HEAD_DIM,
                                                 fp8)
        q = torch.randn(len(lens), Q_HEADS, HEAD_DIM, generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = decode(q, k, v, table, ctx, sliding_window=window, sinks=sinks, tail_k=tk,
                     tail_v=tv, tail_lens=tl)
        torch.cuda.synchronize()
        live = (ctx + tl) > 0
        if not bool((out[~live] == 0).all()):
            fail(f"decode {name}: a padded row did not return zeros")
        err = max(err, check_close(f"decode {name}", out[live], plain_tail(
            q, k, v, table, ctx, tk, tv, tl, window, sinks)[live]))

    timing = decode_timing(torch, ops, gen, TAIL_SLOTS, fp8=fp8)
    return dict(timing, max_abs_err=max(err, timing["max_abs_err"]))


def latent_tail_parity(torch, ops, gen) -> dict:
    """Latent decode kernel's tail arm (the last split of each row folds
    it) vs the plain version with a tail, at widths 576 and 640 (absorbed
    MLA: the latent tail is K and V) and MQA 128 x 16 heads with SWA +
    sinks, rms-scaled absolute term; timed at b 8, ctx 4160, D 576 with and
    without an 8-token tail (profiler device time, as the latent decode)."""
    decode = ops.cuda_paged_latent_decode_attention
    heads = MLA_HEADS
    err = 0.0
    cases = [(f"mla d{w} {name}", lens, tails, w, True, window, sinks)
             for w in (576, 640) for name, lens, tails, window, sinks in TAIL_CASES[:1]]
    cases += [(f"mqa d128 {name}", lens, tails, 128, False, window, sinks)
              for name, lens, tails, window, sinks in TAIL_CASES[1:]]
    for name, lens, tails, width, shared, window, sinks in cases:
        k, v, table, ctx, tk, tv, tl = tail_case(torch, gen, lens, tails, 1, width)
        if shared:
            v, tv = k, tk
        q = torch.randn(len(lens), heads, width, generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = decode(q, k, v, table, ctx, sliding_window=window, sinks=sinks,
                     shared_kv=shared, tail_k=tk, tail_v=tv, tail_lens=tl)
        torch.cuda.synchronize()
        live = (ctx + tl) > 0
        if not bool((out[~live] == 0).all()):
            fail(f"latent decode {name}: a padded row did not return zeros")
        ref = plain_tail(q, k, v, table, ctx, tk, tv, tl, window, sinks)[live]
        err = max(err, check_close(f"latent decode {name}", out[live], ref))

    timing = latent_decode_b8_timing(torch, ops, gen, TAIL_SLOTS)
    return dict(timing, max_abs_err=max(err, timing["max_abs_err"]))


def latent_decode_b8_timing(torch, ops, gen, tail_slots, heads=MLA_HEADS) -> dict:
    """The latent decode at the MLA slice's decode shape, 8 rows over 4160
    paged latents at D 576 (absorbed MLA, 16 heads, or ``heads``: a tp 2
    rank's 8; with a burst tail of
    ``tail_slots`` latents a row when > 0), checked against its plain
    version first: the kernel's device ms (the profiler's, combine pass
    included; by kernel in ``by_kernel``) and between CUDA events, beside
    its bound and the plain version's, the launch's key splits and how many
    saw a key (``latent_split_use``); without a tail the SDPA yardstick,
    with one also the same inputs' device ms without it."""
    decode = ops.cuda_paged_latent_decode_attention
    lens, width = [4160] * 8, 576
    k, _, table, ctx, tk, _, tl = tail_case(torch, gen, lens, [max(tail_slots, 1)] * 8, 1,
                                            width)
    q = torch.randn(8, heads, width, generator=gen, device="cuda").to(torch.bfloat16)
    tails = dict(tail_k=tk, tail_lens=tl) if tail_slots else {}

    def kernel():
        return decode(q, k, None, table, ctx, shared_kv=True, **tails)

    def plain():
        return plain_tail(q, k, k, table, ctx, *((tk, tk, tl) if tail_slots else (None,) * 3))

    name = (f"latent decode{'' if heads == MLA_HEADS else f' h{heads}'} b8 ctx4160 d{width}"
            + (f" + tail {tail_slots}" if tail_slots else ""))
    out = kernel()
    err = check_close(name, out, plain())
    ms, by_kernel = device_ms(kernel, by_kernel=True)
    events_ms = time_ms(kernel)
    plain_ms = device_ms(plain, iters=5)
    keys = sum(lens) + 8 * tail_slots
    nbytes = (keys * width * 2  # the latent, read once: it is K and V
              + 2 * q.numel() * 2 + table.numel() * 4 + ctx.numel() * 4
              + (tl.numel() * 4 if tail_slots else 0))
    b_ms, b_by = bound_ms(nbytes, 4 * heads * width * keys)  # QK^T and PV
    chunk = ops.load_library().llmd_latent_decode_chunk_keys()
    splits, busy = latent_split_use(torch, kernel, len(lens), width)
    res = dict(max_abs_err=err, ms=ms, events_ms=events_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, splits=splits, busy_splits=busy,
               chunk_keys=chunk, by_kernel=by_kernel)
    extra = ""
    if tail_slots:
        res["no_tail_ms"] = device_ms(lambda: decode(q, k, None, table, ctx, shared_kv=True))
        extra = f" (without the tail {res['no_tail_ms']:.4f})"
    else:
        res["sdpa_contiguous_ms"], res["sdpa_backend"] = latent_sdpa_yardstick(
            torch, name, q, k, table, out)
    print(f"{name}: {ms:.4f} ms/launch on the device{extra} ({events_ms:.4f} ms between "
          f"CUDA events, back to back; by kernel {json.dumps(by_kernel)}), {chunk}-key "
          f"chunks, {splits} key splits a row ({busy} saw a key in every row), plain "
          f"{plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return res


def latent_split_use(torch, launch, batch, width) -> tuple[int, int]:
    """The key splits a row of one latent decode launch (``launch``) and how
    many of them saw a key in every row, read from the launch itself: its
    workspace (the one uint8 tensor the wrapper allocates: [B, splits, 16,
    D] fp32 partial O, then [B, splits, 2, 16] m and l) is kept past the
    call, and a split saw a key where its l is above 0. (1, 1) for a launch
    the wrapper left unsplit."""
    kept, empty = [], torch.empty

    def keep(*args, **kwargs):
        x = empty(*args, **kwargs)
        if kwargs.get("dtype") is torch.uint8:
            kept.append(x)
        return x

    torch.empty = keep
    try:
        launch()
    finally:
        torch.empty = empty
    torch.cuda.synchronize()
    if len(kept) != 1:
        fail(f"latent decode: expected one workspace allocation, saw {len(kept)}")
    ws = kept[0].view(torch.float32)
    if ws.numel() == 0:
        return 1, 1
    splits = ws.numel() // (batch * 16 * (width + 2))
    ell = ws[batch * splits * 16 * width:].view(batch, splits, 2, 16)[:, :, 1]
    return splits, int((ell > 0).any(-1).sum(1).min())


def latent_sdpa_yardstick(torch, name, q, k, table, want) -> tuple[float, str]:
    """Device ms of one torch scaled_dot_product_attention call on the
    latent decode's inputs, each row's latents gathered into contiguous
    keys [B, 1, L, D] and passed as K and V (enable_gqa: the 16 query heads
    share them), under the backend PyTorch picks at this width, named by
    its kernels (the math backend at width 576: flash attention takes head
    dims up to 256): an informational yardstick, contiguous and not paged,
    so not the same function as the kernel's; the port never calls it."""
    import torch.nn.functional as F

    rows, length, width = q.shape[0], 4160, q.shape[-1]
    pages = -(-length // PAGE)
    lat = k[table[:rows, :pages].long()].reshape(rows, 1, pages * PAGE, width)[
        :, :, :length].contiguous()
    qs = q[:, :, None]  # [B, 16, 1, D]

    def call():
        return F.scaled_dot_product_attention(qs, lat, lat, enable_gqa=True)

    got = call()[:, :, 0]
    torch.cuda.synchronize()
    ms, by_kernel = device_ms(call, by_kernel=True)
    diff = float((got.float() - want.float()).abs().max())
    kernels = sorted(by_kernel, key=by_kernel.get, reverse=True)
    backend = next((b for b, marks in (("flash", ("flash",)), ("efficient", ("fmha", "efficient")),
                                       ("cudnn", ("cudnn",)))
                    if any(m in k.lower() for k in kernels for m in marks)), "math")
    print(f"{name}: scaled_dot_product_attention (the {backend} backend, which PyTorch picks at "
          f"width {width}; kernels {kernels}; contiguous, not paged) {ms:.4f} ms on the "
          f"device; max |sdpa - kernel| {diff:.3e}", flush=True)
    return ms, backend


def prefill_parity(torch, ops, gen, fp8=False) -> dict:
    """Prefill kernel vs plain: the cold prompt's 2048-token chunks at ctx 0
    and 2048, the 64-token tail chunk at ctx 4096, the decode pod's 1-token
    chunk (a 16-token bucket) over a 4159-token handoff, and SWA + sinks; timed at
    S 2048 over ctx 2048 (``prefill_timing``); with ``fp8`` over an fp8
    pool (the kernel's fp8 arm)."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    prefill = ops.cuda_paged_prefill_attention
    num_pages = 272 + 1
    k, v = random_pool(torch, gen, num_pages, fp8)
    table = page_table_for(torch, gen, [4160], num_pages)
    err = 0.0
    cases = [  # (ctx, seq, valid new tokens, window, sinks)
        (0, 2048, 2048, None, None),
        (2048, 2048, 2048, None, None),
        (4096, 64, 64, None, None),
        (4096, 64, 50, None, None),  # padded tail of a bucket
        (4159, 16, 1, None, None),  # a handoff's last prompt token, padded to a bucket
        (2048, 2048, 2048, 1000, 20),
    ]
    for ctx_len, seq, new, window, sinks in cases:
        q = torch.randn(1, seq, Q_HEADS, HEAD_DIM, generator=gen,
                        device="cuda").to(torch.bfloat16)
        ctx = torch.tensor([ctx_len], dtype=torch.int32, device="cuda")
        total = ctx + new
        positions = ctx[:, None] + torch.arange(seq, device="cuda")[None]
        out = prefill(q, k, v, table, ctx, total, sliding_window=window, sinks=sinks)
        ref = paged_attention(q, k, v, table, positions, total,
                              sliding_window=window, attention_sinks=sinks)
        name = f"{kv_tag(fp8)}prefill ctx{ctx_len} s{seq} new{new}" + (
            f" swa{window}+sinks{sinks}" if window else "")
        # Padded slots past new attend the keys below total, as the plain
        # version's positions do: compared too.
        err = max(err, check_close(name, out[0], ref[0]))
    timing = prefill_timing(torch, ops, gen, fp8)
    return dict(timing, max_abs_err=max(err, timing["max_abs_err"]))


def prefill_timing(torch, ops, gen, fp8=False, q_heads=Q_HEADS, window=None) -> dict:
    """The GQA prefill at the cold prompt's second chunk, S 2048 over ctx
    2048 (at ``q_heads`` query heads over the 8 kv heads; with a sliding
    ``window``, whose bound counts the (query, key) pairs and keys it
    leaves), checked against its plain version first: device ms (profiler)
    and between CUDA events, beside its bound, the plain version's and the
    SDPA yardstick over the keys gathered contiguous (flash with a
    lower-right causal mask; with a window, the memory-efficient backend
    with its boolean mask)."""
    from torch.nn.attention.bias import causal_lower_right

    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    ctx_len, seq = 2048, 2048
    total_len = ctx_len + seq
    k, v = random_pool(torch, gen, 273, fp8)
    table = page_table_for(torch, gen, [total_len], 273)
    q = torch.randn(1, seq, q_heads, HEAD_DIM, generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.tensor([ctx_len], dtype=torch.int32, device="cuda")
    total = ctx + seq
    positions = ctx[:, None] + torch.arange(seq, device="cuda")[None]

    def kernel():
        return ops.cuda_paged_prefill_attention(q, k, v, table, ctx, total,
                                                sliding_window=window)

    def plain():
        return paged_attention(q, k, v, table, positions, total, sliding_window=window)

    name = (f"{kv_tag(fp8)}prefill{'' if q_heads == Q_HEADS else ' g' + str(q_heads // KV_HEADS)}"
            " s2048 ctx2048" + (f" swa{window}" if window else ""))
    out = kernel()
    err = check_close(name, out[0], plain()[0])
    ms, events_ms = device_ms(kernel), time_ms(kernel)
    plain_ms = device_ms(plain, iters=3)
    w = window or total_len
    qpos = torch.arange(ctx_len, total_len, dtype=torch.float64)
    pairs = float(torch.clamp(qpos + 1, max=w).sum())  # causal (query, key) pairs in window
    keys = total_len - max(0, ctx_len - w + 1)  # keys some query attends
    nbytes = (keys * KV_HEADS * HEAD_DIM * 2 * k.element_size()
              + 2 * q.numel() * 2 + table.numel() * 4 + 8)
    b_ms, b_by = bound_ms(nbytes, 4 * q_heads * HEAD_DIM * pairs)
    kc = contiguous_kv(torch, k, table, 1, total_len)
    vc = contiguous_kv(torch, v, table, 1, total_len)
    if window is None:
        sdpa = sdpa_yardstick(torch, name, q.transpose(1, 2), kc, vc, out,
                              mask=causal_lower_right(seq, total_len))
    else:
        qp = torch.arange(ctx_len, total_len, device="cuda")[:, None]
        kp = torch.arange(total_len, device="cuda")[None]
        sdpa = sdpa_masked_yardstick(torch, name, q.transpose(1, 2), kc, vc, out,
                                     (kp <= qp) & (qp - kp < window))
    print(f"{name}: {ms:.4f} ms/launch on the device ({events_ms:.4f} ms "
          f"between CUDA events, back to back), plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, sdpa_contiguous_ms=sdpa)


def rms_atol(ref):
    """The parity check's absolute term for each row of ``ref`` (its first
    axis): PARITY_ATOL x min(1, rms of the row's plain output), shaped to
    broadcast over ``ref``, and its text for the parity line."""
    rms = ref.float().reshape(ref.shape[0], -1).pow(2).mean(1).sqrt()
    atol = (PARITY_ATOL * rms.clamp(max=1)).reshape((-1,) + (1,) * (ref.dim() - 1))
    text = (f"{PARITY_ATOL}*rms(row), rms(plain) per row "
            f"{float(rms.min()):.3e}..{float(rms.max()):.3e}")
    return atol, text


def latent_pool(torch, gen, num_pages, width):
    """A single-head bf16 latent pool of random values (page 0 too)."""
    return torch.randn(num_pages, 1, PAGE, width, generator=gen,
                       device="cuda").to(torch.bfloat16)


def latent_decode_parity(torch, ops, gen) -> dict:
    """Latent decode kernel vs plain (K passed as V): b 8 over contexts
    1..4160 with a padded row at D 576 and 640 (absorbed MLA, 16 heads),
    MQA at D 128 with a separate V pool, 16 heads under SWA + sinks and 8
    heads over contexts at the 32-key chunk boundary; timed at the MLA
    slice's decode (b 8, ctx 4160, D 576)."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    decode = ops.cuda_paged_latent_decode_attention
    heads = MLA_HEADS
    err = 0.0
    cases = [  # (name, lens, width, heads, shared, window, sinks)
        ("mla d576", [1, 17, 300, 1024, 2049, 3001, 4160, 0], 576, heads, True, None, None),
        ("mla d640", [1, 17, 300, 1024, 2049, 3001, 4160, 0], 640, heads, True, None, None),
        ("mqa d128 swa500+sinks20", [1, 17, 300, 1024, 2049, 3001, 4160, 0], 128, heads,
         False, 500, 20),
        ("mqa d128 h8", [1, 31, 32, 33, 1000, 3001, 4160, 0], 128, 8, False, None, None),
    ]
    for name, lens, width, heads, shared, window, sinks in cases:
        num_pages = sum((n + PAGE - 1) // PAGE for n in lens) + 64
        k = latent_pool(torch, gen, num_pages, width)
        v = k if shared else latent_pool(torch, gen, num_pages, width)
        table = page_table_for(torch, gen, lens, num_pages)
        ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(len(lens), heads, width, generator=gen,
                        device="cuda").to(torch.bfloat16)
        live = ctx > 0
        out = decode(q, k, v, table, ctx, sliding_window=window, sinks=sinks,
                     shared_kv=shared)
        torch.cuda.synchronize()
        if not bool((out[~live] == 0).all()):
            fail(f"latent decode {name}: a padded row (total_len 0) did not return zeros")
        ref = paged_attention(q[:, None], k, v, table, (ctx - 1)[:, None], ctx,
                              sliding_window=window, attention_sinks=sinks)[:, 0]
        err = max(err, check_close(f"latent decode {name}", out[live], ref[live]))
    timing = latent_decode_b8_timing(torch, ops, gen, 0)
    return dict(timing, max_abs_err=max(err, timing["max_abs_err"]))


# The latent prefill's shapes on the MLA path, (ctx, chunk): the cold
# prompt's two 2048-token chunks and the warm 64-token chunk over the
# 4096-token cached prefix (which the wrapper splits across CTAs).
LATENT_PREFILL_TIMED = ((0, 2048), (2048, 2048), (4096, 64))


def latent_prefill_timing(torch, kernel, plain, ctx_len, seq, width, q, table) -> dict:
    """Device ms of one latent prefill launch (combine pass included) and of
    its plain version, beside the bound for this chunk's causal pairs."""
    ms = device_ms(kernel)
    plain_ms = device_ms(plain, iters=3)
    qpos = torch.arange(ctx_len, ctx_len + seq, dtype=torch.float64)
    pairs = float((qpos + 1).sum())  # causal (query, key) pairs
    nbytes = (ctx_len + seq) * width * 2 + 2 * q.numel() * 2 + table.numel() * 4 + 8
    heads = q.shape[2]
    b_ms, b_by = bound_ms(nbytes, 4 * heads * width * pairs)
    print(f"latent prefill{'' if heads == MLA_HEADS else f' h{heads}'} s{seq} ctx{ctx_len} "
          f"d{width}: {ms:.4f} ms/launch on the "
          f"device, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def latent_prefill_parity(torch, ops, gen, heads=MLA_HEADS) -> dict:
    """Latent prefill kernel vs plain (K passed as V) at D 576 and 640 with
    16 heads (or ``heads``: a tp 2 rank's 8, in tiles of 8 tokens): the cold prompt's 2048-token chunks at ctx 0 and 2048, the
    64-token tail at ctx 4096 (split across CTAs), an odd length over an
    odd prefix; timed at LATENT_PREFILL_TIMED, D 576 (the kernels line
    carries the 2048-token chunk over a 2048-token prefix, as before)."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    prefill = ops.cuda_paged_latent_prefill_attention
    err = 0.0
    shapes = {}
    cases = [  # (width, ctx, seq, valid new tokens)
        (576, 0, 2048, 2048),
        (576, 2048, 2048, 2048),
        (576, 4096, 64, 64),
        (576, 1037, 333, 331),  # odd lengths, a padded token
        (640, 2048, 2048, 2048),
        (640, 4096, 64, 50),
    ]
    pools = {}
    for width, ctx_len, seq, new in cases:
        if width not in pools:
            num_pages = 272 + 1
            pools[width] = (latent_pool(torch, gen, num_pages, width),
                            page_table_for(torch, gen, [4160], num_pages))
        k, table = pools[width]
        q = torch.randn(1, seq, heads, width, generator=gen,
                        device="cuda").to(torch.bfloat16)
        ctx = torch.tensor([ctx_len], dtype=torch.int32, device="cuda")
        total = ctx + new
        positions = ctx[:, None] + torch.arange(seq, device="cuda")[None]

        def plain(q=q, k=k, table=table, total=total, positions=positions):
            return paged_attention(q, k, k, table, positions, total)

        def kernel(q=q, k=k, table=table, ctx=ctx, total=total):
            return prefill(q, k, table, ctx, total)

        out = kernel()
        torch.cuda.synchronize()
        tag = "" if heads == MLA_HEADS else f" h{heads}"
        err = max(err, check_close(f"latent prefill{tag} d{width} ctx{ctx_len} s{seq} new{new}",
                                   out[0, :new], plain()[0, :new]))
        if width == 576 and new == seq and (ctx_len, seq) in LATENT_PREFILL_TIMED:
            shapes[f"s{seq} ctx{ctx_len}"] = latent_prefill_timing(
                torch, kernel, plain, ctx_len, seq, width, q, table)
    timing = dict(shapes["s2048 ctx2048"], shapes=shapes)
    return dict(max_abs_err=err, **timing)


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------

def record_calls(obj, name: str, value=lambda *args, **kwargs: None) -> list:
    """Wrap one method of ``obj``: each call appends ``value`` of its
    arguments to the returned log, then runs the method. The log's length
    counts the calls; clearing it zeroes the count."""
    log = []
    inner = getattr(obj, name)

    def wrapper(*args, **kwargs):
        log.append(value(*args, **kwargs))
        return inner(*args, **kwargs)

    setattr(obj, name, wrapper)
    return log


def gqa_model():
    """The bench's accelerator model (bench.py, routing replay): ~0.89B."""
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=16, num_heads=16,
                       num_kv_heads=8, head_dim=128, intermediate_size=5632, page_size=16)


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

    model = gqa_model()
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

    def add_pod(pod, pod_model=model, pod_params=params, pod_model_name=model_name,
                offload_spec=None, num_pages=1024, **cfg_kw):
        """A pod of the fleet: 1024 pages (or ``num_pages``), its events into
        the one indexer (under its model's name), and a shared-storage tier
        when given an ``offload_spec``."""
        events[pod] = []

        def sink(evs):
            events[pod].extend(evs)
            pool.process_event_batch(EventBatch(timestamp=time.time(), events=evs),
                                     pod, pod_model_name)

        engines[pod] = MiniEngine(
            EngineConfig(model=pod_model, num_pages=num_pages, max_pages_per_seq=272,
                         max_prefill_tokens=2048, model_name=pod_model_name,
                         pod_identifier=pod, **cfg_kw),
            event_sink=sink, params=pod_params, device="cuda",
            offload_spec=offload_spec)
        return engines[pod]

    for pod in ("pod-0", "pod-1"):
        add_pod(pod)
    prefill_chunks = {p: record_calls(e, "_prefill_chunk") for p, e in engines.items()}
    decode_calls = {p: record_calls(e, "_decode_chunk") for p, e in engines.items()}

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
    zero_launches(ops)
    for cell in (*prefill_chunks.values(), *decode_calls.values()):
        cell.clear()

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

    batch_prompts = [prefix + tokens(64) for _ in range(8)]
    batch = [target.enqueue(f"D{i}", p, max_new_tokens=16)
             for i, p in enumerate(batch_prompts)]
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
    others = {k: n for k, n in read_launches(ops).items()
              if "ragged" in k or "latent" in k}
    n_prefill = sum(len(c) for c in prefill_chunks.values())
    n_decode = sum(len(c) for c in decode_calls.values())
    # --- end of the main path ---
    # Phase 14's reference: pod-0's counted traffic and what it stored (pod-0
    # served nothing before it) and decoded.
    tp_reference = dict(
        prompts=dict(a=prompt_a, b=prompt_b, batch=batch_prompts),
        stored=[h for e in events["pod-0"] if isinstance(e, BlockStoredEvent)
                for h in e.block_hashes],
        outputs=[list(r.output) for r in batch])

    print(f"main path: {n_prefill} prefill chunks, {n_decode} decode steps, "
          f"kernel launches {launches}", flush=True)
    layers = model.num_layers
    if launches["prefill"] != layers * n_prefill or n_prefill == 0:
        fail(f"prefill kernel launched {launches['prefill']} times for "
             f"{n_prefill} chunks x {layers} layers")
    if launches["decode"] != layers * n_decode or n_decode == 0:
        fail(f"decode kernel launched {launches['decode']} times for "
             f"{n_decode} steps x {layers} layers")
    if any(others.values()):
        fail(f"the main path went through the ragged or latent kernels: {others}")
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
    fleet = dict(model=model, params=params, indexer=indexer, events=events,
                 engines=engines, add_pod=add_pod, tokens=tokens, prefix=prefix,
                 batch_prompts=batch_prompts, batch_outputs=[r.output for r in batch],
                 model_name=model_name, tp_reference=tp_reference)
    return dict(launches=launches, ttft_cold_ms=ttft_cold_ms,
                ttft_warm_ms=ttft_warm_ms,
                decode_ms_per_step=sum(step_ms) / len(step_ms),
                decode_steps_timed=len(step_ms), logits_err=logits_err,
                profile=profile), fleet


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
        if any(k in name for k in ("decode_kernel", "prefill_kernel", "ragged_kernel",
                                   "combine_kernel")):
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


def logits_parity(torch, model, params, prompt, kv_dtype=None) -> float:
    """One prefill chunk (2048 tokens over a 2048-token prefix) through the
    kernels vs the same forward with the plain attention, over pools of
    ``kv_dtype`` (the model's by default)."""
    from llmd_kv_cache_tpu_torch.models.llama import (
        forward,
        forward_prefill,
        init_kv_cache,
    )

    tag = kv_tag(kv_dtype is not None)
    num_pages = 4096 // model.page_size + 1  # page 0 is the garbage page
    k, v = init_kv_cache(model, num_pages, kv_dtype, device="cuda")
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
        fail(f"{tag}prefill logits: shape {tuple(got.shape)} or non-finite values")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{tag}prefill chunk logits, kernels vs plain attention: max_abs_err="
          f"{err:.4e}, max|logit|={scale:.4e} (tol {LOGITS_REL_TOL} relative)",
          flush=True)
    if err > LOGITS_REL_TOL * scale:
        fail(f"{tag}prefill chunk logits through the kernels disagree with the plain path")
    return err


# ---------------------------------------------------------------------------
# Phase 6: the ragged mixed prefill + decode path
# ---------------------------------------------------------------------------

def ragged_work(q_lens, ctx_lens, tails=None) -> tuple[int, int]:
    """The keys a ragged launch must read (each row's context and new
    tokens, or for a row with a burst tail its context and tail) and the
    causal (query, key) pairs it computes."""
    tails = tails or [0] * len(q_lens)
    keys = sum(c + (t or n) for c, n, t in zip(ctx_lens, q_lens, tails) if n)
    pairs = sum(n * (c + t) if t else n * c + n * (n + 1) // 2
                for c, n, t in zip(ctx_lens, q_lens, tails))
    return keys, pairs


def ragged_bound(q_lens, ctx_lens, q_heads, rows, kv_bytes=2, tails=None) -> tuple[float, str]:
    """The least time of one ragged launch on these inputs: each row's keys
    (``ragged_work``, ``kv_bytes`` an element) read once, q read and the
    output written once, against the causal products' operations."""
    keys, pairs = ragged_work(q_lens, ctx_lens, tails)
    tokens = sum(q_lens)
    nbytes = (keys * KV_HEADS * HEAD_DIM * 2 * kv_bytes  # K and V
              + 2 * tokens * q_heads * HEAD_DIM * 2  # q in, out
              + rows * PAGES_PER_SEQ * 4 + (2 * rows + 1) * 4 + (rows * 4 if tails else 0))
    return bound_ms(nbytes, 4 * q_heads * HEAD_DIM * pairs)


# The ragged kernel's timed dispatches: the main path's mixed one (8 decode
# rows over 4160 keys and a 2048-token chunk at ctx 2048), a decode-only
# step's at 8 and at 3 rows (the decode arm alone), the warm 64-token chunk
# over 4096 cached keys beside 8 decode rows (the q72 dispatches), and a
# 2048-token chunk alone: the shape classes the ragged pods launch.
RAGGED_TIMED = {
    "timed": ([1] * 8 + [2048], [4159] * 8 + [2048]),
    "decode8": ([1] * 8, [4159] * 8),
    "chunk64+decode8": ([1] * 8 + [64], [4159] * 8 + [4096]),
    "chunk2048": ([2048], [2048]),
    "decode3": ([1] * 3, [4159] * 3),
}
# The kernels a ragged dispatch may launch (the profiler's by-kernel list):
# its kernel and, when an arm splits, its combine pass; nothing else.
RAGGED_KERNELS = {"ragged_kernel", "split_combine_kernel"}
LATENT_RAGGED_KERNELS = {"latent_ragged_kernel", "latent_ragged_combine_kernel"}


def ragged_plan_info(torch, ops, q, k, table, q_lens, shared_kv) -> dict:
    """The plan of one ragged launch (``ops.plan_ragged_attention``; {} for
    a port package without it): both arms' key splits, the CTAs that carry
    work (the rows' prefill tiles x prefill splits and decode rows x
    splits, per KV head) and the waves they make on this card's SMs (one
    CTA an SM in both ragged kernels), and the grid's CTAs (the surplus
    tile slots and non-decode rows' decode CTAs exit at once), with the
    tile sizes and the grid rule the library reports."""
    planner = getattr(ops, "plan_ragged_attention", None)
    if planner is None:
        return {}
    plan = planner(q.shape[0], q.shape[1], k, table, shared_kv=shared_kv)
    lib, heads = ops.load_library(), k.shape[1]
    if shared_kv:
        tile, dec = lib.llmd_latent_prefill_tile_tokens(q.shape[1]), ops.LATENT_RAGGED_DECODE_TOKENS
    else:
        group = q.shape[1] // heads
        tile, dec = lib.llmd_ragged_tile_tokens(group), lib.llmd_ragged_decode_tokens(group)
    tiles = sum(-(-n // tile) for n in q_lens if n > dec)
    decode_rows = sum(1 for n in q_lens if 1 <= n <= dec)
    work = (tiles * plan.prefill_splits + decode_rows * plan.splits) * heads
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(splits=plan.splits, prefill_splits=plan.prefill_splits, ctas=work,
                waves=-(-work // sms),
                grid_ctas=(lib.llmd_ragged_tile_slots(q.shape[0], len(q_lens), tile, dec)
                           * plan.prefill_splits + len(q_lens) * plan.splits) * heads)


def ragged_shape_timing(torch, label, kernel, plain, q_lens, bound, plan, allowed,
                        hold=True, plain_iters=3) -> dict:
    """Device ms of one ragged launch by kernel (the profiler's: the
    decode-only launches take less device time than host time, so back to
    back CUDA events, kept as events_ms, would time the host), its plan's
    splits, CTAs and waves, its plain version's ms (``plain_iters`` 0: not
    timed) and the bound. With ``hold``, the by-kernel list may hold only
    ``allowed`` kernels, the combine pass exactly when an arm splits."""
    (ms, by_kernel), events_ms = device_ms(kernel, by_kernel=True), time_ms(kernel)
    plain_ms = device_ms(plain, iters=plain_iters) if plain_iters else None
    b_ms, b_by = bound
    names = {n.split("<")[0] for n in by_kernel}
    if hold and plan:
        split = plan["splits"] > 1 or plan["prefill_splits"] > 1
        if not names <= allowed or any("combine" in n for n in names) != split:
            fail(f"{label}: the dispatch launched {sorted(by_kernel)}; expected only "
                 f"{sorted(allowed)}, the combine pass exactly when an arm splits ({plan})")
    print(f"{label}: {ms:.4f} ms/launch on the device ({events_ms:.4f} ms between CUDA "
          f"events, back to back; by kernel {json.dumps(by_kernel)}), plan {json.dumps(plan)}, "
          f"plain {'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                by_kernel=by_kernel, plan=plan)


def ragged_inputs(torch, gen, q_lens, ctx_l, pad=0, fp8=False, q_heads=Q_HEADS):
    """A random pool (fp8 with ``fp8``) holding each row's context and new
    tokens, its page table, row starts, context lengths, and random queries
    of ``q_heads`` heads (with ``pad`` slots past the last row)."""
    totals = [c + n for c, n in zip(ctx_l, q_lens)]
    num_pages = sum((n + PAGE - 1) // PAGE for n in totals) + 64
    k, v = random_pool(torch, gen, num_pages, fp8)
    table = page_table_for(torch, gen, totals, num_pages)
    starts = torch.tensor([0] + list(q_lens), device="cuda").cumsum(0).to(torch.int32)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    q = torch.randn(sum(q_lens) + pad, q_heads, HEAD_DIM, generator=gen,
                    device="cuda").to(torch.bfloat16)
    return q, k, v, table, starts, ctx


def ragged_timing(torch, ops, kernel, plain, name, inputs, q_lens, ctx_l, fp8=False,
                  hold=True, plain_iters=3) -> dict:
    """One of RAGGED_TIMED's dispatches on the GQA ragged kernel, timed by
    ``ragged_shape_timing`` beside its bound."""
    q, k, _, table, *_ = inputs
    return ragged_shape_timing(
        torch, f"{kv_tag(fp8)}ragged {name} (q_lens {describe_lens(q_lens, ctx_l)})", kernel,
        plain, q_lens, ragged_bound(q_lens, ctx_l, Q_HEADS, len(q_lens), 1 if fp8 else 2),
        ragged_plan_info(torch, ops, q, k, table, q_lens, False), RAGGED_KERNELS, hold,
        plain_iters)


def describe_lens(q_lens, ctx_l) -> str:
    """"8 x 1 @ 4159 + 64 @ 4096": each run of equal rows as count x new
    tokens @ context."""
    runs = []
    for n, c in zip(q_lens, ctx_l):
        if runs and runs[-1][1:] == [n, c]:
            runs[-1][0] += 1
        else:
            runs.append([1, n, c])
    return " + ".join(f"{k} x {n} @ {c}" if k > 1 else f"{n} @ {c}" for k, n, c in runs)


def check_ragged(torch, name, out, ref, q_lens) -> float:
    """A ragged launch's output against its plain version: zeros past the
    last row, and ``check_close`` on the rows' slots with the absolute term
    PARITY_ATOL x min(1, rms of the request row's plain output)."""
    torch.cuda.synchronize()
    real = sum(q_lens)
    if not bool((out[real:] == 0).all()):
        fail(f"{name}: slots past the last row are not zeros")
    ref = ref[:real]
    lens = torch.tensor(q_lens, device="cuda")
    row_of = torch.repeat_interleave(torch.arange(len(q_lens), device="cuda"), lens)
    sq = torch.zeros(len(q_lens), device="cuda").index_add_(
        0, row_of, ref.float().pow(2).mean((1, 2)))
    rms = (sq / lens.clamp(min=1)).sqrt()
    atol = PARITY_ATOL * rms.clamp(max=1)[row_of][:, None, None]
    live = rms[lens > 0]
    return check_close(name, out[:real], ref, atol=atol,
                       atol_text=f"{PARITY_ATOL}*rms(row), rms(plain) per row "
                                 f"{float(live.min()):.3e}..{float(live.max()):.3e}")


def ragged_parity(torch, ops, gen, fp8=False) -> dict:
    """Ragged kernel vs plain: the serving mix (8 decode rows at ragged
    contexts up to 4160, a 2048-token chunk at ctx 2048, a 64-token row at
    ctx 4096), odd lengths that straddle the query tiles with an empty row
    and padded slots, SWA 1000 + sinks 20, rows at the decode arm's limit;
    timed at RAGGED_TIMED (the kernels line carries the mixed dispatch);
    with ``fp8`` over fp8 pools (both arms' fp8 instantiations)."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_ragged_attention

    ragged = ops.cuda_paged_ragged_attention
    mixes = {  # name: (q_lens, ctx_lens, padded slots, window, sinks)
        "serving": ([1] * 8 + [2048, 64],
                    [16, 300, 1023, 2048, 3001, 3500, 4100, 4159, 2048, 4096],
                    0, None, None),
        "straddle": ([1, 7, 0, 33, 100, 1], [500, 0, 10, 1000, 77, 4000], 3, None, None),
        "serving swa1000+sinks20": ([1] * 8 + [2048, 64],
                                    [16, 300, 1023, 2048, 3001, 3500, 4100, 4159,
                                     2048, 4096], 0, 1000, 20),
        # Rows at the decode arm's limit (16 / group = 8 tokens) and past it.
        "arm boundary": ([8, 9, 1, 2, 16], [100, 4000, 4159, 3000, 0], 2, None, None),
        **{name: (*lens, 0, None, None) for name, lens in RAGGED_TIMED.items()},
    }
    err = 0.0
    timing = {}
    for name, (q_lens, ctx_l, pad, window, sinks) in mixes.items():
        q, k, v, table, starts, ctx = ragged_inputs(torch, gen, q_lens, ctx_l, pad, fp8)
        name = kv_tag(fp8) + name

        def kernel(q=q, k=k, v=v, table=table, starts=starts, ctx=ctx,
                   window=window, sinks=sinks):
            return ragged(q, k, v, table, starts, ctx, sliding_window=window, sinks=sinks)

        def plain(q=q, k=k, v=v, table=table, starts=starts, ctx=ctx,
                  window=window, sinks=sinks):
            return paged_ragged_attention(q, k, v, table, starts, ctx,
                                          sliding_window=window, sinks=sinks)

        err = max(err, check_ragged(torch, f"ragged {name}", kernel(), plain(), q_lens))
        key = name.removeprefix(kv_tag(fp8))
        if key in RAGGED_TIMED:
            timing[key] = ragged_timing(torch, ops, kernel, plain, key,
                                        (q, k, v, table, starts, ctx), q_lens, ctx_l, fp8)
    return dict(max_abs_err=err, decode_only=timing["decode8"],
                shapes={k: v for k, v in timing.items() if k != "timed"}, **timing["timed"])


# The latent ragged arm's timed dispatches at D 576 (DeepSeek-V2-Lite's
# latent, 16 heads): the MLA pod's mixed one (8 decode rows over 4160
# latents and a 2048-token chunk at ctx 2048), a decode-only step's at 8
# and 3 rows, the warm 64-token chunk over 4096 cached latents alone and
# beside 8 decode rows (the q72 dispatches), and a 2048-token chunk alone.
# The planner must split the 64-token chunk's tiles across CTAs, alone and
# beside decode rows, and leave the 2048-token chunks' unsplit.
LATENT_RAGGED_TIMED = {
    "mixed": ([1] * 8 + [2048], [4159] * 8 + [2048]),
    "decode8": ([1] * 8, [4159] * 8),
    "chunk64": ([64], [4096]),
    "chunk64+decode8": ([1] * 8 + [64], [4159] * 8 + [4096]),
    "chunk2048": ([2048], [2048]),
    "decode3": ([1] * 3, [4159] * 3),
}
LATENT_PREFILL_SPLIT = {"chunk64": True, "chunk64+decode8": True, "mixed": False,
                        "chunk2048": False}


def latent_ragged_timing(torch, ops, kernel, plain, name, inputs, q_lens, ctx_l, width,
                         hold=True, plain_iters=3) -> dict:
    """One of LATENT_RAGGED_TIMED's dispatches on the latent ragged kernel,
    timed by ``ragged_shape_timing`` beside its bound; with ``hold`` the
    planned prefill split must be as LATENT_PREFILL_SPLIT says."""
    q, k, table, *_ = inputs
    plan = ragged_plan_info(torch, ops, q, k, table, q_lens, True)
    if hold and name in LATENT_PREFILL_SPLIT and (
            plan.get("prefill_splits", 1) > 1) != LATENT_PREFILL_SPLIT[name]:
        fail(f"latent ragged {name}: planned prefill splits {plan}, expected "
             f"{'more than one' if LATENT_PREFILL_SPLIT[name] else 'one'}")
    return ragged_shape_timing(
        torch, f"latent ragged {name} d{width} (q_lens {describe_lens(q_lens, ctx_l)})", kernel,
        plain, q_lens, latent_ragged_bound(q_lens, ctx_l, width), plan, LATENT_RAGGED_KERNELS,
        hold, plain_iters)


def latent_ragged_inputs(torch, gen, q_lens, ctx_l, width, pad=0):
    """A random latent pool holding each row's context and new tokens, its
    page table, row starts, context lengths and random queries of the 16
    heads (with ``pad`` slots past the last row)."""
    totals = [c + n for c, n in zip(ctx_l, q_lens)]
    num_pages = sum((n + PAGE - 1) // PAGE for n in totals) + 64
    k = latent_pool(torch, gen, num_pages, width)
    table = page_table_for(torch, gen, totals, num_pages)
    starts = torch.tensor([0] + list(q_lens), device="cuda").cumsum(0).to(torch.int32)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    q = torch.randn(sum(q_lens) + pad, MLA_HEADS, width, generator=gen,
                    device="cuda").to(torch.bfloat16)
    return q, k, table, starts, ctx


def latent_ragged_bound(q_lens, ctx_lens, width, tails=None) -> tuple[float, str]:
    """The least time of one latent ragged launch: each row's latents
    (``ragged_work``) read once, as K and V, q read and the output written
    once, against the causal products' operations (Q K^T and P V over the
    full width, 16 heads)."""
    keys, pairs = ragged_work(q_lens, ctx_lens, tails)
    rows = len(q_lens)
    nbytes = (keys * width * 2 + 2 * sum(q_lens) * MLA_HEADS * width * 2
              + rows * PAGES_PER_SEQ * 4 + (2 * rows + 1) * 4 + (rows * 4 if tails else 0))
    return bound_ms(nbytes, 4 * MLA_HEADS * width * pairs)


def latent_ragged_parity(torch, ops, gen) -> dict:
    """The ragged kernel's shared_kv arm (the latent ragged kernel) vs the
    plain version (the latent pool as K and V, no V pool), rms-scaled per
    request row: at D 576 LATENT_RAGGED_TIMED's dispatches (timed, device
    ms beside the bound and the plain version), an odd mix (an empty row,
    2- and 3-token rows, a 1-token row at ctx 0, chunks that straddle the
    4-token tiles, padded slots) and the mixed dispatch under SWA 1000 +
    sinks 20; at D 640 the odd mix."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_ragged_attention

    ragged = ops.cuda_paged_ragged_attention
    odd = ([1, 2, 3, 0, 1, 5, 33, 1, 17], [0, 40, 41, 9, 4159, 100, 2000, 63, 4096])
    mixes = {  # name: (q_lens, ctx_lens, padded slots, window, sinks, width)
        **{name: (*lens, 0, None, None, 576) for name, lens in LATENT_RAGGED_TIMED.items()},
        "odd": (*odd, 3, None, None, 576),
        "mixed swa1000+sinks20": (*LATENT_RAGGED_TIMED["mixed"], 0, 1000, 20, 576),
        "d640 odd": (*odd, 3, None, None, 640),
    }
    err, timing = 0.0, {}
    for name, (q_lens, ctx_l, pad, window, sinks, width) in mixes.items():
        q, k, table, starts, ctx = latent_ragged_inputs(torch, gen, q_lens, ctx_l, width, pad)

        def kernel(q=q, k=k, table=table, starts=starts, ctx=ctx, window=window, sinks=sinks):
            return ragged(q, k, None, table, starts, ctx, sliding_window=window, sinks=sinks,
                          shared_kv=True)

        def plain(q=q, k=k, table=table, starts=starts, ctx=ctx, window=window, sinks=sinks):
            return paged_ragged_attention(q, k, None, table, starts, ctx,
                                          sliding_window=window, sinks=sinks, shared_kv=True)

        err = max(err, check_ragged(torch, f"latent ragged {name}", kernel(), plain(), q_lens))
        if name in LATENT_RAGGED_TIMED:
            timing[name] = latent_ragged_timing(torch, ops, kernel, plain, name,
                                                (q, k, table, starts, ctx), q_lens, ctx_l,
                                                width)
    return dict(max_abs_err=err, decode_only=timing["decode8"], chunk_only=timing["chunk64"],
                shapes={k: v for k, v in timing.items() if k != "mixed"}, **timing["mixed"])


def ragged_tail_parity(torch, ops, gen, arm) -> dict:
    """The ragged kernels' decode-burst tail arm vs the plain version with
    a tail, rms-scaled per request row: ``arm`` "bf16" and "fp8" (the GQA
    ragged kernel over bf16 or fp8 pools, the tail in the pools' dtype) or
    "latent" (the latent ragged kernel at D 576, the latent tail K and V).
    Each of TAIL_CASES (1-token rows with tails of 0, 1, 5 and 8 at
    contexts up to 4160, with SWA 1000 + sinks 20, and a window of 4 the
    tail outruns) beside a 100-token prefill row with tail 0; then a
    decode-only dispatch of 8 rows over 4160 paged keys with an 8-token
    tail each, timed beside its bound and the plain version, and without
    the tail on the same inputs."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_ragged_attention

    ragged = ops.cuda_paged_ragged_attention
    fp8, latent = arm == "fp8", arm == "latent"
    width = 576 if latent else HEAD_DIM
    cases = [(name, [1] * len(lens) + [100], lens + [300], tails + [0], window, sinks)
             for name, lens, tails, window, sinks in TAIL_CASES]
    cases.append(("decode8 t8", [1] * 8, [4160] * 8, [TAIL_SLOTS] * 8, None, None))
    err, res = 0.0, {}
    for name, q_lens, ctx_l, tails, window, sinks in cases:
        if latent:
            q, k, table, starts, ctx = latent_ragged_inputs(torch, gen, q_lens, ctx_l, width)
            v, heads = None, 1
        else:
            q, k, v, table, starts, ctx = ragged_inputs(torch, gen, q_lens, ctx_l, fp8=fp8)
            heads = KV_HEADS
        shape = (len(q_lens), TAIL_SLOTS, heads, width)
        tk, tv = (as_pool(torch, torch.randn(shape, generator=gen, device="cuda")
                          .to(torch.bfloat16), fp8) for _ in range(2))
        tail = dict(tail_k=tk, tail_v=None if latent else tv,
                    tail_lens=torch.tensor(tails, dtype=torch.int32, device="cuda"))

        def kernel(q=q, k=k, v=v, table=table, starts=starts, ctx=ctx, window=window,
                   sinks=sinks, tail=tail):
            return ragged(q, k, v, table, starts, ctx, sliding_window=window, sinks=sinks,
                          shared_kv=latent, **tail)

        def plain(q=q, k=k, v=v, table=table, starts=starts, ctx=ctx, window=window,
                  sinks=sinks, tail=tail):
            return paged_ragged_attention(q, k, v, table, starts, ctx, sliding_window=window,
                                          sinks=sinks, shared_kv=latent, **tail)

        err = max(err, check_ragged(torch, f"{arm} ragged tail {name}", kernel(), plain(),
                                    q_lens))
        if name.startswith("decode8"):
            res = dict(ms=device_ms(kernel), plain_ms=device_ms(plain, iters=3),
                       no_tail_ms=device_ms(lambda: ragged(q, k, v, table, starts, ctx,
                                                           shared_kv=latent)))
            if latent:
                b_ms, b_by = latent_ragged_bound(q_lens, ctx_l, width, tails)
            else:
                b_ms, b_by = ragged_bound(q_lens, ctx_l, Q_HEADS, len(q_lens),
                                          1 if fp8 else 2, tails)
            print(f"{arm} ragged 8 decode rows over 4160 keys + tail {TAIL_SLOTS}: "
                  f"{res['ms']:.4f} ms/launch on the device (without the tail "
                  f"{res['no_tail_ms']:.4f}), plain {res['plain_ms']:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
            res.update(bound_ms=b_ms, bound_by=b_by)
    return dict(res, max_abs_err=err)


def ragged_path(torch, ops, fleet, pod_name="pod-r", model_name=None, padded="pod-0",
                routed=260, **pod_kw) -> dict:
    """A third pod, pod-r, serves through the ragged path: the 4096-token
    prefix is warmed with one request, the eight prompts of the main path's
    batch are enqueued (16 new tokens each), and after their first decode a
    cold 4160-token prompt arrives, whose three chunks ride in mixed
    dispatches beside the eight decode rows. Every kernel's launch counter
    is zeroed just before and read just after; no plain attention may run.
    ``pod_name``, ``model_name`` and ``pod_kw`` (the pod's EngineConfig, or
    ``add_pod``'s ``pod_model``/``pod_params``) serve the same traffic on
    another ragged pod, with ``fleet``'s model, prefix and batch (the single
    step pod ``padded``'s outputs); with ``kv_cache_dtype`` (an fp8 pod)
    every ragged launch must be an fp8 one; for an MLA model every ragged
    launch must take the shared_kv arm and every stored block be tagged
    mla_attention. ``routed`` is the score the cold prompt + 64 must route
    with (a uniform window caps it under window-aware scoring)."""
    from llmd_kv_cache_tpu_torch.events.model import BlockRemovedEvent, BlockStoredEvent

    model, tokens, prefix = fleet["model"], fleet["tokens"], fleet["prefix"]
    model_name = model_name or fleet["model_name"]
    pod = fleet["add_pod"](pod_name, pod_model_name=model_name, ragged_attention=True,
                           **pod_kw)
    dispatches = record_calls(pod, "_ragged_dispatch")
    cold = tokens(4160)

    # --- the ragged path: counters zeroed just before, read just after ---
    plain = PlainCalls()
    zero_launches(ops)
    dispatches.clear()

    warm = pod.enqueue("RW", prefix + tokens(64), max_new_tokens=1)
    while not warm.done:
        pod.step()
    batch = [pod.enqueue(f"R{i}", p, max_new_tokens=16)
             for i, p in enumerate(fleet["batch_prompts"])]
    while any(len(r.output) < 2 for r in batch):  # through every first decode
        pod.step()
    if any(r.cached_len != 4096 for r in batch):
        fail(f"{pod_name}: cached_len {[r.cached_len for r in batch]}, expected 4096")
    req_cold = pod.enqueue("RC", cold, max_new_tokens=4)
    mixed_ms = []
    while not all(r.done for r in (*batch, req_cold)):
        chunk = (min(2048, len(cold) - req_cold.prefill_pos)
                 if req_cold.prefill_pos is not None else 0)
        decoding = sum(1 for r in batch if not r.done)
        t = time.perf_counter()
        pod.step()
        torch.cuda.synchronize()
        if chunk == 2048 and decoding == 8:
            mixed_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    counted, counted_fp8 = read_launches(ops), read_launches_fp8(ops)
    plain.stop()
    launches = {"decode": counted["cuda_paged_decode_attention"],
                "prefill": counted["cuda_paged_prefill_attention"],
                "ragged": counted["cuda_paged_ragged_attention"],
                "latent": counted["cuda_paged_latent_decode_attention"]
                + counted["cuda_paged_latent_prefill_attention"],
                "ragged_shared_kv": ops.cuda_paged_ragged_attention.launches_shared_kv,
                "ragged_tail": ops.cuda_paged_ragged_attention.launches_tail}
    by_shape = read_launches_by_shape(ops, "cuda_paged_ragged_attention")
    n_dispatch = len(dispatches)
    # --- end of the ragged path ---

    print(f"ragged path ({pod_name}): {n_dispatch} dispatches, kernel launches "
          f"{launches}" + (f", of them fp8 {counted_fp8}"
                           if "kv_cache_dtype" in pod_kw else ""), flush=True)
    if "kv_cache_dtype" in pod_kw:
        check_fp8_pod(pod_name, counted, counted_fp8, plain)
    print(f"ragged launches by shape (flat tokens / rows): {by_shape}", flush=True)
    if sum(by_shape.values()) != launches["ragged"]:
        fail(f"ragged launches by shape {by_shape} do not sum to {launches['ragged']}")
    if launches["ragged"] != model.num_layers * n_dispatch or n_dispatch == 0:
        fail(f"ragged kernel launched {launches['ragged']} times for "
             f"{n_dispatch} dispatches x {model.num_layers} layers")
    if launches["decode"] or launches["prefill"] or launches["latent"]:
        fail(f"{pod_name} went through the padded or latent kernels: {launches}")
    if plain.calls:
        fail(f"{pod_name} ran the plain attention {plain.calls} times")
    if launches["ragged_shared_kv"] != (launches["ragged"] if model.is_mla else 0):
        fail(f"{pod_name}: {launches['ragged_shared_kv']} of {launches['ragged']} ragged "
             f"launches took the shared_kv arm, expected {'all' if model.is_mla else 'none'}")
    if len(mixed_ms) != 2:
        fail(f"expected 2 mixed steps of 8 decode rows + a 2048-token chunk, "
             f"timed {len(mixed_ms)}")
    for req in (warm, *batch, req_cold):
        if len(req.output) != req.max_new_tokens or not all(
                0 <= x < model.vocab_size for x in req.output):
            fail(f"request {req.request_id}: bad output {req.output}")

    evs = fleet["events"][pod_name]
    stored = sum(len(e.block_hashes) for e in evs if isinstance(e, BlockStoredEvent))
    removed = sum(len(e.block_hashes) for e in evs if isinstance(e, BlockRemovedEvent))
    cached = pod.block_manager.num_cached_blocks()
    kinds = {e.kv_cache_spec_kind for e in evs if isinstance(e, BlockStoredEvent)}
    print(f"{pod_name}: {stored} blocks stored ({sorted(kinds)}), {removed} removed, "
          f"{cached} cached", flush=True)
    if model.is_mla and kinds != {"mla_attention"}:
        fail(f"{pod_name}'s BlockStored events carry {kinds}, expected mla_attention")
    if stored - removed != cached:
        fail(f"{pod_name}: {stored} stored - {removed} removed != {cached} cached")
    scores = fleet["indexer"].score_tokens(cold + tokens(64), model_name)
    ranked = sorted(scores, key=lambda p: (-scores[p], p))
    print(f"score_tokens(cold prompt + 64): {scores}", flush=True)
    if not ranked or ranked[0] != pod_name or scores[pod_name] != routed:
        fail(f"routing: expected {pod_name} first with {routed} blocks, got {scores}")

    # Information only: bf16 near-ties may flip a greedy token between the
    # ragged kernel and the padded kernels.
    pairs = [(a, b) for r, ref in zip(batch, fleet["batch_outputs"])
             for a, b in zip(r.output, ref)]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    print(f"greedy tokens on which {pod_name} and {padded} (padded) agree: {agree:.4f} "
          f"of {len(pairs)}", flush=True)
    return dict(launches=launches, launches_by_shape=by_shape, dispatches=n_dispatch,
                mixed_step_ms_in_window=mixed_ms, greedy_agreement=agree,
                launches_fp8=counted_fp8, plain_calls=plain.calls)


def ragged_logits_parity(torch, model, params, kv_dtype=None) -> float:
    """One mixed dispatch (8 decode rows at ctx 4096 over a shared prefix,
    a 2048-token chunk at ctx 2048) through ``forward_ragged``: the kernel
    vs the plain attention, over pools of ``kv_dtype``."""
    from llmd_kv_cache_tpu_torch.models.llama import forward_ragged, init_kv_cache

    tag = kv_tag(kv_dtype is not None)
    rng = torch.Generator().manual_seed(2)
    prefix = torch.randint(1, model.vocab_size, (1, 4096), generator=rng).cuda()
    prefix_pages = 4096 // model.page_size
    num_pages = 1 + prefix_pages + 8 + 128  # garbage page, prefix, rows, chunk
    k, v = init_kv_cache(model, num_pages, kv_dtype, device="cuda")
    table = torch.zeros(10, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[:, :prefix_pages] = torch.arange(1, 1 + prefix_pages, device="cuda")
    table[:8, prefix_pages] = torch.arange(1 + prefix_pages, 9 + prefix_pages,
                                           device="cuda")
    table[8, 128:256] = torch.arange(9 + prefix_pages, num_pages, device="cuda")

    def starts_of(lens):
        return torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)

    def ints(xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    # The shared prefix through the kernel, as one 4096-token row.
    forward_ragged(params, model, prefix, k, v, table[9:], starts_of([4096]), ints([0]))
    toks = torch.cat([torch.randint(1, model.vocab_size, (1, 8), generator=rng).cuda(),
                      prefix[:, 2048:]], 1)
    lens, ctx = [1] * 8 + [2048], ints([4096] * 8 + [2048])
    k2, v2 = k.clone(), v.clone()
    got, _, _ = forward_ragged(params, model, toks, k, v, table[:9], starts_of(lens), ctx)
    ref, _, _ = forward_ragged(params, model, toks, k2, v2, table[:9], starts_of(lens),
                               ctx, plain_attention=True)
    torch.cuda.synchronize()
    if got.shape != (9, model.vocab_size) or not torch.isfinite(got).all():
        fail(f"{tag}mixed dispatch logits: shape {tuple(got.shape)} or non-finite values")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{tag}mixed dispatch logits, ragged kernel vs plain attention: max_abs_err="
          f"{err:.4e}, max|logit|={scale:.4e} (tol {LOGITS_REL_TOL} relative)",
          flush=True)
    if err > LOGITS_REL_TOL * scale:
        fail(f"{tag}mixed dispatch logits through the ragged kernel disagree with the "
             "plain path")
    return err


def fp32_copy(torch, model, params):
    """The model and its params upcast to fp32 (the reference forward of the
    logits-vs-fp32 checks); a fused tree's ``fused_interleave`` marker is
    carried as it is."""
    import dataclasses

    return dataclasses.replace(model, dtype=torch.float32), {
        name: [{k: t.float() for k, t in layer.items()} for layer in leaf]
        if name == "layers" else leaf.float() if torch.is_tensor(leaf) else leaf
        for name, leaf in params.items()}


Q72_SEEDS = (5, 6, 7)


def ragged_q72_logits(torch, ops, model, params) -> dict:
    """q72 dispatches of the MLA model (8 decode rows at ctx 4096 over a
    shared 4096-token prefix beside a 64-token row continuing it: the
    latent ragged kernel's split prefill tiles beside split decode rows)
    through ``forward_ragged``, one a seed of Q72_SEEDS: the kernel vs the
    plain attention from the same pools (held at LOGITS_REL_TOL), and, as
    information (ROADMAP C.5, its MLA half), the kernel, the kernel with its
    prefill tiles unsplit and the plain attention each against the same
    dispatch of the forward in fp32 (weights upcast, plain attention, its
    own fp32 prefix): max |logit difference| over the reference's max
    |logit|."""
    from llmd_kv_cache_tpu_torch.models.llama import forward_ragged, init_kv_cache

    prefix_pages = 4096 // model.page_size
    num_pages = 1 + prefix_pages + 8 + 4  # garbage page, prefix, a page a row, the 64
    table = torch.zeros(9, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[:, :prefix_pages] = torch.arange(1, 1 + prefix_pages, device="cuda")
    table[:8, prefix_pages] = torch.arange(1 + prefix_pages, 9 + prefix_pages, device="cuda")
    table[8, prefix_pages:prefix_pages + 4] = torch.arange(9 + prefix_pages, num_pages,
                                                           device="cuda")
    starts = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 72], dtype=torch.int32, device="cuda")
    ctx = torch.full((9,), 4096, dtype=torch.int32, device="cuda")
    one_row = torch.tensor([0, 4096], dtype=torch.int32, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")

    def prefilled(mdl, prm, prefix, plain):
        k, v = init_kv_cache(mdl, num_pages, device="cuda")
        forward_ragged(prm, mdl, prefix, k, v, table[8:], one_row, zero, plain_attention=plain)
        return k, v

    def unsplit(*args):  # the planner with the prefill tiles unsplit
        return planner(*args)[0], 1

    model32, params32 = fp32_copy(torch, model, params)
    planner, out = ops.latent_ragged_splits, []
    for seed in Q72_SEEDS:
        rng = torch.Generator().manual_seed(seed)
        prefix = torch.randint(1, model.vocab_size, (1, 4096), generator=rng).cuda()
        toks = torch.randint(1, model.vocab_size, (1, 72), generator=rng).cuda()
        k32, v32 = prefilled(model32, params32, prefix, True)
        exact = forward_ragged(params32, model32, toks, k32, v32, table, starts, ctx,
                               plain_attention=True)[0]
        del k32, v32
        k, v = prefilled(model, params, prefix, False)
        got = forward_ragged(params, model, toks, k.clone(), v.clone(), table, starts, ctx)[0]
        ops.latent_ragged_splits = unsplit
        try:
            got_unsplit = forward_ragged(params, model, toks, k.clone(), v.clone(), table,
                                         starts, ctx)[0]
        finally:
            ops.latent_ragged_splits = planner
        ref = forward_ragged(params, model, toks, k, v, table, starts, ctx,
                             plain_attention=True)[0]
        torch.cuda.synchronize()
        if got.shape != (9, model.vocab_size) or not torch.isfinite(got).all():
            fail(f"q72 dispatch logits: shape {tuple(got.shape)} or non-finite values")
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        top = float(exact.abs().max())
        vs_fp32 = {name: float((x.float() - exact).abs().max()) / top for name, x in (
            ("ragged kernel", got), ("ragged kernel, prefill unsplit", got_unsplit),
            ("plain attention", ref))}
        print(f"q72 dispatch logits, seed {seed} (8 decode rows + 64 tokens over 4096, "
              f"{model.num_layers} layers), ragged kernel vs plain attention: "
              f"max_abs_err={err:.4e}, max|logit|={scale:.4e} (tol {LOGITS_REL_TOL} "
              "relative); against the fp32 forward, max |diff| / max|logit|: "
              + ", ".join(f"{n} {d:.4f}" for n, d in vs_fp32.items()), flush=True)
        if err > LOGITS_REL_TOL * scale:
            fail("q72 dispatch logits through the latent ragged kernel disagree with the "
                 "plain path")
        out.append(dict(seed=seed, max_abs_err=err, max_logit=scale, vs_fp32=vs_fp32))
    return out


def decode_logits_vs_fp32(torch, model, params) -> dict:
    """One decode step of the GQA model (8 rows at ctx 4096 over a shared
    4096-token prefix, prefilled through the prefill kernel) through the
    decode kernel (the padded pods' path), through the ragged kernel's
    decode arm (``pod-r``'s: a decode-only dispatch) and with the plain
    attention, each held against the same step of the forward in fp32
    (weights upcast, plain attention, its own fp32 prefill): max |logit
    difference| over the fp32 forward's max |logit|. Information: how far
    each decode path sits from the truth (ROADMAP Queue C.2)."""
    from llmd_kv_cache_tpu_torch.models.llama import (
        forward,
        forward_decode,
        forward_prefill,
        forward_ragged,
        init_kv_cache,
    )

    rng = torch.Generator().manual_seed(4)
    prefix_pages = 4096 // model.page_size
    num_pages = 1 + prefix_pages + 8  # the garbage page, the prefix, a page a row
    table = torch.zeros(8, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[:, :prefix_pages] = torch.arange(1, 1 + prefix_pages, device="cuda")
    table[:, prefix_pages] = torch.arange(1 + prefix_pages, num_pages, device="cuda")
    toks = torch.randint(1, model.vocab_size, (1, 4096), generator=rng).to("cuda")
    step = torch.randint(1, model.vocab_size, (8, 1), generator=rng).to("cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = torch.full((1,), 2048, dtype=torch.int32, device="cuda")
    ctx = torch.full((8,), 4096, dtype=torch.int32, device="cuda")
    one = torch.ones(8, dtype=torch.int32, device="cuda")
    starts = torch.arange(9, dtype=torch.int32, device="cuda")

    model32, params32 = fp32_copy(torch, model, params)
    k, v = init_kv_cache(model32, num_pages, device="cuda")
    forward(params32, model32, toks[:, :2048], k, v, table[:1], zero, n, last_only=True,
            plain_attention=True)
    forward(params32, model32, toks[:, 2048:], k, v, table[:1], n, n, last_only=True,
            plain_attention=True)
    exact, _, _ = forward(params32, model32, step, k, v, table, ctx, one,
                          plain_attention=True)
    exact = exact[:, 0]
    del params32, k, v

    k, v = init_kv_cache(model, num_pages, device="cuda")
    forward_prefill(params, model, toks[:, :2048], k, v, table[:1], zero, n, last_only=True)
    forward_prefill(params, model, toks[:, 2048:], k, v, table[:1], n, n, last_only=True)
    paths = {
        "decode kernel": lambda k, v: forward_decode(params, model, step, k, v, table, ctx,
                                                     one)[0][:, 0],
        "ragged decode arm": lambda k, v: forward_ragged(params, model, step.reshape(1, 8), k, v, table,
                                                         starts, ctx)[0],
        "plain attention": lambda k, v: forward(params, model, step, k, v, table, ctx, one,
                                                plain_attention=True)[0][:, 0],
    }
    scale = float(exact.abs().max())
    out = {}
    for name, run in paths.items():
        got = run(k.clone(), v.clone())
        torch.cuda.synchronize()
        if got.shape != exact.shape or not torch.isfinite(got).all():
            fail(f"decode step logits ({name}): shape {tuple(got.shape)} or non-finite")
        out[name] = float((got.float() - exact).abs().max()) / scale
    print(f"decode step logits (b8, ctx 4096, {model.num_layers} layers) against the fp32 "
          "forward, max |diff| / max|logit|: "
          + ", ".join(f"{n} {d:.4f}" for n, d in out.items()), flush=True)
    return out


def mixed_step_timing(torch, engine, prompts, cold) -> dict:
    """Host clock (ending in a sync) of the steps that carry a 2048-token
    chunk of ``cold`` beside 8 decode rows, of decode-only steps at batch
    8, and a profile of the mixed step at ctx 2048. ``prompts`` share a
    prefix the engine holds."""
    reqs = [engine.enqueue(f"T{i}", p, max_new_tokens=24) for i, p in enumerate(prompts)]
    while any(len(r.output) < 2 for r in reqs):
        engine.step()
    req = engine.enqueue("TC", cold, max_new_tokens=2)

    def timed_step():
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    mixed = [timed_step()]  # the chunk at ctx 0
    profile = profile_window(torch, engine.step)  # the chunk at ctx 2048
    while req.prefill_pos is not None or not req.done:
        engine.step()
    decode = [timed_step() for _ in range(4) if all(not r.done for r in reqs)]
    while not all(r.done for r in reqs):
        engine.step()
    return dict(mixed_step_ms=mixed, decode_step_ms_b8=decode, profile_mixed_step=profile)


# ---------------------------------------------------------------------------
# Phase 7: the absorbed-MLA path
# ---------------------------------------------------------------------------

def mla_model_and_params(torch):
    """DeepSeek-V2-Lite's attention at full width (deepseek-ai/DeepSeek-V2-Lite
    config.json, converted as the JAX hf_loader._config_from_deepseek does:
    v_head_dim = qk_nope_head_dim = 128, no q-LoRA, yarn with attention
    factor 1.0 because mscale = mscale_all_dim, no mscale^2 on the softmax
    scale for V2). Reduced: the 26 MoE layers (64 routed + 2 shared experts,
    top-6) take layer 0's dense MLP. Random weights from seed 0; each layer
    carries a ones latent_norm, as a checkpoint's kv_a_layernorm does."""
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig, init_params

    model = LlamaConfig(vocab_size=102400, hidden_size=2048, num_layers=27,
                        num_heads=16, num_kv_heads=16, head_dim=128,
                        intermediate_size=10944, rope_theta=10000.0, norm_eps=1e-6,
                        page_size=16, kv_lora_rank=512, qk_rope_head_dim=64,
                        rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0))
    t0 = time.perf_counter()
    params = init_params(model, seed=0, device="cuda")
    for layer in params["layers"]:
        layer["latent_norm"] = torch.ones(model.kv_lora_rank, dtype=torch.float32,
                                          device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"]]) + sum(
        t.numel() for layer in params["layers"] for t in layer.values())
    print(f"MLA model: {n_params / 1e9:.3f}B params (bf16, seed 0), latent row "
          f"{model.kv_cache_head_dim}, init {time.perf_counter() - t0:.1f} s", flush=True)
    return model, params


def zero_launches(ops) -> None:
    """Every launch counter of every wrapper to 0 (``launches``, the counts
    of an arm apart, ``launches_by_shape``)."""
    for fn in LAUNCH_COUNTED:
        counters = vars(getattr(ops, fn))
        for attr in [a for a in counters if a.startswith("launches")]:
            counters[attr] = {} if attr == "launches_by_shape" else 0


def read_launches(ops) -> dict:
    return {fn: getattr(ops, fn).launches for fn in LAUNCH_COUNTED}


def read_launches_fp8(ops) -> dict:
    """The fp8 launches of the wrappers that count them apart."""
    return {fn: getattr(ops, fn).launches_fp8 for fn in LAUNCH_COUNTED
            if hasattr(getattr(ops, fn), "launches_fp8")}


class PlainCalls:
    """Counts calls of the plain attention (``paged_attention``,
    ``paged_ragged_attention``, the decode and sharded plain versions) from
    the two modules that call it, the wrappers' CPU path and the model's
    ``plain_attention`` switch, from its creation until ``stop()``: a pod on
    the card must make none."""

    def __init__(self):
        from llmd_kv_cache_tpu_torch.models import llama
        from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention

        self.calls = 0
        names = ("paged_attention", "paged_ragged_attention", "paged_decode_attention",
                 "sharded_decode_attention", "sharded_prefill_attention")
        self.saved = [(mod, name, getattr(mod, name)) for mod in (cuda_paged_attention, llama)
                      for name in names if hasattr(mod, name)]
        for mod, name, inner in self.saved:
            def counted(*args, _inner=inner, **kwargs):
                self.calls += 1
                return _inner(*args, **kwargs)
            setattr(mod, name, counted)

    def stop(self) -> None:
        for mod, name, inner in self.saved:
            setattr(mod, name, inner)


def check_fp8_pod(pod_name, launches, launches_fp8, plain) -> None:
    """An fp8 pod's counted run: every GQA launch an fp8 one, no plain call."""
    if any(launches[fn] != n for fn, n in launches_fp8.items()) or plain.calls:
        fail(f"{pod_name}: launches {launches}, of them fp8 {launches_fp8}, "
             f"{plain.calls} plain attention calls")


def read_launches_by_shape(ops, fn: str) -> dict:
    """The launches of one wrapper on the counted run by shape class (its
    keys: "q<flat tokens>/rows<rows>" for the ragged kernel, a decode-only
    dispatch having as many tokens as rows; "s<chunk>/splits<n>" for the
    latent prefill)."""
    return dict(sorted(getattr(ops, fn).launches_by_shape.items()))


LAUNCH_COUNTED = ("cuda_paged_decode_attention", "cuda_paged_prefill_attention",
                  "cuda_paged_ragged_attention", "cuda_paged_latent_decode_attention",
                  "cuda_paged_latent_prefill_attention")


def mla_path(torch, ops, fleet) -> dict:
    """A fourth pod, pod-m, serves the MLA model under its own model name on
    the same Indexer: a cold 4160-token prompt (chunks 2048 + 2048 + 64), a
    second prompt with the same 4096-token prefix scored and routed to
    pod-m, then 8 prompts decoded to 16 tokens each at batch 8. Every
    kernel's launch counter is zeroed just before and read just after."""
    from llmd_kv_cache_tpu_torch.events.model import BlockRemovedEvent, BlockStoredEvent

    model, params = mla_model_and_params(torch)
    name = "deepseek-v2-lite-dense"
    pod = fleet["add_pod"]("pod-m", pod_model=model, pod_params=params,
                           pod_model_name=name)
    prefill_chunks = record_calls(pod, "_prefill_chunk")
    decode_calls = record_calls(pod, "_decode_chunk")
    tokens = fleet["tokens"]

    def sync_ms(t_start):
        torch.cuda.synchronize()
        return (time.perf_counter() - t_start) * 1e3

    pod.generate("MW", tokens(2048 + 64), max_new_tokens=2)  # warm-up, first launches
    prefix = tokens(4096)
    prompt_a, prompt_b = prefix + tokens(64), prefix + tokens(64)

    # --- the MLA path: counters zeroed just before, read just after ---
    zero_launches(ops)
    prefill_chunks.clear()
    decode_calls.clear()
    n_events = len(fleet["events"]["pod-m"])
    t = time.perf_counter()
    req_a = pod.add_request("MA", prompt_a, max_new_tokens=1)
    ttft_cold_ms = sync_ms(t)
    scores = fleet["indexer"].score_tokens(prompt_b, name)
    ranked = sorted(scores, key=lambda p: (-scores[p], p))
    print(f"score_tokens(MLA prompt B): {scores}", flush=True)
    if not ranked or ranked[0] != "pod-m" or scores["pod-m"] != 256:
        fail(f"routing: expected pod-m first with 256 blocks, got {scores}")
    t = time.perf_counter()
    req_b = fleet["engines"][ranked[0]].add_request("MB", prompt_b, max_new_tokens=1)
    ttft_warm_ms = sync_ms(t)
    print(f"routed MLA B to {ranked[0]}: cached_len={req_b.cached_len}", flush=True)
    if req_b.cached_len != 4096:
        fail(f"routing: MLA cached_len {req_b.cached_len}, expected 4096")
    batch_prompts = [prefix + tokens(64) for _ in range(8)]
    batch = [pod.enqueue(f"MD{i}", p, max_new_tokens=16) for i, p in enumerate(batch_prompts)]
    step_ms = []
    while any(not r.done for r in batch):
        decoding = sum(1 for r in batch if r.prefill_pos is None and r.output
                       and not r.done)
        prefilling = any(r.prefill_pos is not None for r in batch)
        t = time.perf_counter()
        pod.step()
        elapsed = sync_ms(t)
        if decoding == 8 and not prefilling:
            step_ms.append(elapsed)
    torch.cuda.synchronize()
    launches = read_launches(ops)
    prefill_by_shape = read_launches_by_shape(ops, "cuda_paged_latent_prefill_attention")
    n_prefill, n_decode = len(prefill_chunks), len(decode_calls)
    # --- end of the MLA path ---
    tp_reference = dict(  # phase 14's, as main_path's
        prompts=dict(a=prompt_a, b=prompt_b, batch=batch_prompts),
        stored=[h for e in fleet["events"]["pod-m"][n_events:]
                if isinstance(e, BlockStoredEvent) for h in e.block_hashes],
        outputs=[list(r.output) for r in batch])

    print(f"MLA path (pod-m): {n_prefill} prefill chunks, {n_decode} decode steps, "
          f"kernel launches {launches}", flush=True)
    print(f"latent prefill launches by shape (chunk / key splits): {prefill_by_shape}",
          flush=True)
    if sum(prefill_by_shape.values()) != launches["cuda_paged_latent_prefill_attention"]:
        fail(f"latent prefill launches by shape {prefill_by_shape} do not sum to the count")
    layers = model.num_layers
    if launches["cuda_paged_latent_prefill_attention"] != layers * n_prefill or not n_prefill:
        fail(f"latent prefill kernel launched {launches} for {n_prefill} chunks x "
             f"{layers} layers")
    if launches["cuda_paged_latent_decode_attention"] != layers * n_decode or not n_decode:
        fail(f"latent decode kernel launched {launches} for {n_decode} steps x "
             f"{layers} layers")
    gqa = {k: n for k, n in launches.items() if "latent" not in k}
    if any(gqa.values()):
        fail(f"pod-m went through the GQA or ragged kernels: {gqa}")
    if not step_ms:
        fail("no MLA decode step ran at batch 8")
    for req in (req_a, req_b, *batch):
        if len(req.output) != req.max_new_tokens or not all(
                0 <= x < model.vocab_size for x in req.output):
            fail(f"request {req.request_id}: bad output {req.output}")
    evs = fleet["events"]["pod-m"]
    stored_evs = [e for e in evs if isinstance(e, BlockStoredEvent)]
    kinds = {e.kv_cache_spec_kind for e in stored_evs}
    if kinds != {"mla_attention"}:
        fail(f"pod-m's BlockStored events carry {kinds}, expected mla_attention")
    stored = sum(len(e.block_hashes) for e in stored_evs)
    removed = sum(len(e.block_hashes) for e in evs if isinstance(e, BlockRemovedEvent))
    cached = pod.block_manager.num_cached_blocks()
    print(f"pod-m: {stored} blocks stored ({len(stored_evs)} events, all "
          f"mla_attention), {removed} removed, {cached} cached", flush=True)
    if stored - removed != cached:
        fail(f"pod-m: {stored} stored - {removed} removed != {cached} cached")

    logits_err = mla_logits_parity(torch, model, params, prompt_a)
    run_decode = decode_steps(pod, [prefix + tokens(64) for _ in range(8)], 4)
    cold = tokens(4160)
    profile = {
        "decode_4_steps_b8": profile_window(torch, run_decode),
        "cold_prefill_4160": profile_window(
            torch, lambda: pod.add_request("MP", cold, max_new_tokens=1)),
    }
    return dict(launches=launches, prefill_launches_by_shape=prefill_by_shape,
                prefill_chunks=n_prefill, decode_steps=n_decode,
                ttft_cold_ms=ttft_cold_ms, ttft_warm_ms=ttft_warm_ms,
                decode_ms_per_step=sum(step_ms) / len(step_ms),
                decode_steps_timed=len(step_ms), logits_err=logits_err, profile=profile,
                model=model, params=params, model_name=name, prefix=prefix,
                batch_prompts=batch_prompts, batch_outputs=[r.output for r in batch],
                tp_reference=tp_reference)


def mla_logits_parity(torch, model, params, prompt) -> dict:
    """One prefill chunk (2048 tokens over a 2048-token prefix) and one
    decode step (8 rows at ctx 4096 over the shared prefix) of the MLA model
    through the latent kernels vs the same forward with plain attention.
    Both are also held, for information, against the forward in fp32
    (weights upcast, plain attention): how far bf16 alone moves these
    logits, which for 27 random layers is the same size as the kernels'
    distance from the plain path."""
    import dataclasses

    from llmd_kv_cache_tpu_torch.models.llama import (
        forward,
        forward_decode,
        forward_prefill,
        init_kv_cache,
    )

    prefix_pages = 4096 // model.page_size
    num_pages = 1 + prefix_pages + 8  # the garbage page, the prefix, a page a row
    table = torch.zeros(8, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[:, :prefix_pages] = torch.arange(1, 1 + prefix_pages, device="cuda")
    table[:, prefix_pages] = torch.arange(1 + prefix_pages, num_pages, device="cuda")
    toks = torch.tensor([prompt[:4096]], dtype=torch.int64, device="cuda")
    step = torch.tensor([[t] for t in prompt[4096:4104]], dtype=torch.int64, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = torch.full((1,), 2048, dtype=torch.int32, device="cuda")
    ctx = torch.full((8,), 4096, dtype=torch.int32, device="cuda")
    one = torch.ones(8, dtype=torch.int32, device="cuda")

    model32, params32 = fp32_copy(torch, model, params)
    k, v = init_kv_cache(model32, num_pages, device="cuda")
    forward(params32, model32, toks[:, :2048], k, v, table[:1], zero, n, last_only=True,
            plain_attention=True)
    exact_prefill, _, _ = forward(params32, model32, toks[:, 2048:], k, v, table[:1], n, n,
                                  plain_attention=True)
    exact_decode, _, _ = forward(params32, model32, step, k, v, table, ctx, one,
                                 plain_attention=True)
    del params32, k, v

    def compare(what, got, ref, exact, shape):
        torch.cuda.synchronize()
        if got.shape != shape or not torch.isfinite(got).all():
            fail(f"MLA {what} logits: shape {tuple(got.shape)} or non-finite values")
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        to_fp32 = [float((x - exact).abs().max() / exact.abs().max()) for x in (got, ref)]
        print(f"MLA {what} logits, latent kernels vs plain attention: max_abs_err="
              f"{err:.4e}, max|logit|={scale:.4e} (tol {LOGITS_REL_TOL} relative); "
              f"against the fp32 forward: kernels {to_fp32[0]:.4f}, plain "
              f"{to_fp32[1]:.4f} of its max|logit|", flush=True)
        if err > LOGITS_REL_TOL * scale:
            fail(f"MLA {what} logits through the latent kernels disagree with the "
                 "plain path")
        return dict(max_abs_err=err, relative=err / scale, kernels_vs_fp32=to_fp32[0],
                    plain_vs_fp32=to_fp32[1])

    k, v = init_kv_cache(model, num_pages, device="cuda")
    forward_prefill(params, model, toks[:, :2048], k, v, table[:1], zero, n, last_only=True)
    k2 = k.clone()
    got, _, _ = forward_prefill(params, model, toks[:, 2048:], k, v, table[:1], n, n)
    ref, _, _ = forward(params, model, toks[:, 2048:], k2, v, table[:1], n, n,
                        plain_attention=True)
    prefill = compare("prefill chunk", got, ref, exact_prefill, (1, 2048, model.vocab_size))
    del got, ref, k2, exact_prefill
    k2 = k.clone()
    got, _, _ = forward_decode(params, model, step, k, v, table, ctx, one)
    ref, _, _ = forward(params, model, step, k2, v, table, ctx, one, plain_attention=True)
    decode = compare("decode step (b8, ctx 4096)", got, ref, exact_decode,
                     (8, 1, model.vocab_size))
    return dict(prefill_chunk=prefill, decode_step=decode)


# ---------------------------------------------------------------------------
# Phase 8: fused decode bursts
# ---------------------------------------------------------------------------

def tail_fields(tail, launches) -> dict:
    """A kernel's tail-arm numbers for its entry of the kernels line:
    launches on its counted run (the decode kernels' burst path; no engine
    path takes a ragged kernel's tail, so 0 there), parity, and times of 8
    decode rows over 4160 paged keys with an 8-token tail."""
    return dict(tail_launches=launches, tail_max_abs_err=tail["max_abs_err"],
                tail_ms=tail["ms"], tail_no_tail_ms=tail["no_tail_ms"],
                tail_plain_ms=tail["plain_ms"], tail_bound_ms=tail["bound_ms"],
                tail_bound_by=tail["bound_by"])


def burst_path(torch, ops, fleet, pod_name, model, params, model_name, prefix,
               batch_prompts, single_outputs, burst=TAIL_SLOTS, **pod_kw) -> dict:
    """A burst pod (``decode_burst=8``, the params of a single-step pod) on
    the same Indexer: a warm-up request, whose first burst captures the
    engine's burst graph; then, with every counter zeroed just before and
    read just after, a cold 4160-token prompt on its own prefix, a second
    prompt with that prefix scored and routed to the pod (256 blocks,
    ``cached_len`` 4096), a request that warms the single-step pod's
    4096-token prefix, and that pod's 8 batch prompts decoded to 16 tokens
    each. Decode launches must be layers x 8 x bursts, with no single-step
    decode dispatch. With ``burst=1`` the same traffic on a single-step pod
    (decode launches = layers x steps, no burst); ``pod_kw`` go to the
    pod's EngineConfig, and with ``kv_cache_dtype`` (an fp8 pod) every GQA
    launch must be an fp8 one and no plain attention may run."""
    from llmd_kv_cache_tpu_torch.events.model import BlockRemovedEvent, BlockStoredEvent

    pod = fleet["add_pod"](pod_name, pod_model=model, pod_params=params,
                           pod_model_name=model_name, decode_burst=burst, **pod_kw)
    prefill_chunks = record_calls(pod, "_prefill_chunk")
    bursts = record_calls(pod, "_decode_chunk_burst")
    single = record_calls(pod, "_decode_chunk")
    tokens = fleet["tokens"]
    t = time.perf_counter()
    pod.generate("BW", tokens(2048 + 64), max_new_tokens=2)  # first launches, the capture
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t
    own = tokens(4096)
    prompt_a, prompt_b = own + tokens(64), own + tokens(64)

    # --- the burst path: counters zeroed just before, read just after ---
    plain = PlainCalls()
    zero_launches(ops)
    prefill_chunks.clear()
    bursts.clear()
    single.clear()
    req_a = pod.add_request("BA", prompt_a, max_new_tokens=1)
    scores = fleet["indexer"].score_tokens(prompt_b, model_name)
    ranked = sorted(scores, key=lambda p: (-scores[p], p))
    print(f"score_tokens({pod_name} prompt B): {scores}", flush=True)
    if not ranked or ranked[0] != pod_name or scores[pod_name] != 256:
        fail(f"routing: expected {pod_name} first with 256 blocks, got {scores}")
    req_b = fleet["engines"][ranked[0]].add_request("BB", prompt_b, max_new_tokens=1)
    if req_b.cached_len != 4096:
        fail(f"routing: {pod_name} cached_len {req_b.cached_len}, expected 4096")
    warm = pod.add_request("BM", prefix + tokens(64), max_new_tokens=1)
    batch = [pod.enqueue(f"BD{i}", p, max_new_tokens=16) for i, p in enumerate(batch_prompts)]
    while any(not r.done for r in batch):
        pod.step()
    torch.cuda.synchronize()
    launches, launches_fp8 = read_launches(ops), read_launches_fp8(ops)
    n_prefill, n_burst, n_single = len(prefill_chunks), len(bursts), len(single)
    plain.stop()
    # --- end of the burst path ---

    layers = model.num_layers
    decode_fn = ("cuda_paged_latent_decode_attention" if model.is_mla
                 else "cuda_paged_decode_attention")
    prefill_fn = ("cuda_paged_latent_prefill_attention" if model.is_mla
                  else "cuda_paged_prefill_attention")
    print(f"{'burst' if burst > 1 else 'single-step'} path ({pod_name}): {n_prefill} "
          f"prefill chunks, {n_burst} bursts, {n_single} single-step decode dispatches, "
          f"kernel launches {launches}" + (f", of them fp8 {launches_fp8}"
                                           if "kv_cache_dtype" in pod_kw else ""), flush=True)
    if burst > 1:
        if launches[decode_fn] != layers * burst * n_burst or not n_burst:
            fail(f"{pod_name}: {decode_fn} launched {launches[decode_fn]} times for "
                 f"{n_burst} bursts x {burst} ticks x {layers} layers")
        if n_single:
            fail(f"{pod_name}: {n_single} single-step decode dispatches")
    elif launches[decode_fn] != layers * n_single or not n_single or n_burst:
        fail(f"{pod_name}: {decode_fn} launched {launches[decode_fn]} times for "
             f"{n_single} decode steps x {layers} layers ({n_burst} bursts)")
    if "kv_cache_dtype" in pod_kw:
        check_fp8_pod(pod_name, launches, launches_fp8, plain)
    if launches[prefill_fn] != layers * n_prefill or not n_prefill:
        fail(f"{pod_name}: {prefill_fn} launched {launches[prefill_fn]} times for "
             f"{n_prefill} chunks x {layers} layers")
    others = {k: n for k, n in launches.items() if k not in (decode_fn, prefill_fn)}
    if any(others.values()):
        fail(f"{pod_name} went through other kernels: {others}")
    if any(r.cached_len != 4096 for r in batch):
        fail(f"{pod_name}: cached_len {[r.cached_len for r in batch]}, expected 4096")
    for req in (req_a, req_b, warm, *batch):
        if len(req.output) != req.max_new_tokens or not all(
                0 <= x < model.vocab_size for x in req.output):
            fail(f"request {req.request_id}: bad output {req.output}")
    evs = fleet["events"][pod_name]
    stored = sum(len(e.block_hashes) for e in evs if isinstance(e, BlockStoredEvent))
    removed = sum(len(e.block_hashes) for e in evs if isinstance(e, BlockRemovedEvent))
    cached = pod.block_manager.num_cached_blocks()
    print(f"{pod_name}: {stored} blocks stored, {removed} removed, {cached} cached",
          flush=True)
    if stored - removed != cached:
        fail(f"{pod_name}: {stored} stored - {removed} removed != {cached} cached")
    # Information only: bf16 near-ties may flip a greedy token between the
    # burst (tail folded in its own round) and single-step decoding.
    pairs = [(a, b) for r, ref in zip(batch, single_outputs) for a, b in zip(r.output, ref)]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    print(f"greedy tokens on which {pod_name} and the single-step pod agree: "
          f"{agree:.4f} of {len(pairs)}", flush=True)
    same = (burst_graph_vs_eager(torch, pod, pod_name, [prefix + tokens(64) for _ in range(8)])
            if burst > 1 else None)
    return dict(pod=pod, launches=launches[decode_fn], prefill_chunks=n_prefill,
                bursts=n_burst, decode_steps=n_single, greedy_agreement=agree,
                outputs=[r.output for r in batch],
                warmup_with_capture_s=warmup_s, graph_vs_eager=same,
                launches_fp8=launches_fp8, plain_calls=plain.calls)


def burst_graph_vs_eager(torch, pod, pod_name, prompts) -> dict:
    """Hard check: one burst of 8 decoding rows replayed from the pod's
    graph and the same burst run eagerly through the kernels, from
    identical caches and inputs, give the same tokens (and caches). A
    hybrid pod's SWA pages for the burst are taken first, as the engine
    takes them, and both of its pools are compared."""
    from llmd_kv_cache_tpu_torch.models.llama import (
        forward_decode_steps,
        forward_decode_steps_hybrid,
    )

    reqs = [pod.enqueue(f"GE{i}", p, max_new_tokens=1 + 10 * TAIL_SLOTS)
            for i, p in enumerate(prompts)]
    while any(r.prefill_pos is not None for r in reqs):
        pod.step()
    last, ctx, tables = pod._decode_batch_arrays(reqs, pod.cfg.max_batch)
    budgets = torch.tensor([r.max_new_tokens - len(r.output) for r in reqs],
                           dtype=torch.int32, device="cuda")
    args = (torch.from_numpy(ctx).cuda(), budgets, pod._burst)
    if pod.hybrid:
        swa = tables.copy()
        for i, r in enumerate(reqs):
            pod._swa_ensure(r, (r.computed_len + pod._burst - 1) // pod.cfg.model.page_size)
            swa[i] = pod._swa_table_for(r)
        pools = [t.clone() for t in (pod.k_cache, pod.v_cache, pod.k_swa, pod.v_swa)]
        eager = forward_decode_steps_hybrid(
            pod.params, pod.cfg.model, torch.from_numpy(last).cuda(), *pools,
            torch.from_numpy(tables).cuda(), torch.from_numpy(swa).cuda(), *args)[0]
    else:
        pools = [pod.k_cache.clone(), pod.v_cache.clone()]
        eager = forward_decode_steps(
            pod.params, pod.cfg.model, torch.from_numpy(last).cuda(), *pools,
            torch.from_numpy(tables).cuda(), *args)[0]
    eager = eager.cpu().tolist()
    before = [len(r.output) for r in reqs]
    pod.step()
    graph = [r.output[n:] for r, n in zip(reqs, before)]
    live = (pod.k_cache, pod.v_cache) + ((pod.k_swa, pod.v_swa) if pod.hybrid else ())
    same_caches = all(torch.equal(a, b) for a, b in zip(live, pools))
    del pools
    for r in reqs:
        pod.abort_request(r.request_id)
    print(f"{pod_name}: burst from the graph vs eager through the kernels: tokens "
          f"{'identical' if graph == eager else 'DIFFER'}, caches "
          f"{'identical' if same_caches else 'differ'}", flush=True)
    if graph != eager:
        fail(f"{pod_name}: graph burst tokens {graph} != eager {eager}")
    return dict(tokens_identical=True, caches_identical=same_caches)


def decode_token_ms(torch, pod, prompts, timed_steps, profile=False,
                    max_new_tokens=128) -> dict:
    """Host ms per generated token with 8 rows decoding at ~4.2k context:
    ``timed_steps`` steps (a single-step pod's step emits 8 tokens, a burst
    pod's 64) after every row is prefilled, ending in a sync; optionally a
    profile of one more step. The rows (of ``max_new_tokens`` each, enough
    for every timed step) are aborted after."""
    reqs = [pod.enqueue(f"TT{i}", p, max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
    while any(r.prefill_pos is not None for r in reqs):
        pod.step()
    pod.step()  # the last row's first decode
    n0 = sum(len(r.output) for r in reqs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed_steps):
        pod.step()
    torch.cuda.synchronize()
    elapsed = (time.perf_counter() - t) * 1e3
    n = sum(len(r.output) for r in reqs) - n0
    out = dict(ms_per_token=elapsed / n, tokens=n, steps=timed_steps)
    if profile:
        out["profile_one_step"] = profile_window(torch, pod.step)
    for r in reqs:
        pod.abort_request(r.request_id)
    return out


def burst_tick_logits_parity(torch, model, params, kv_dtype=None) -> dict:
    """One burst tick's logits at tail length 8 (8 rows over a 4096-token
    shared prefix, the first 7 ticks run through the kernels) through the
    decode kernels' tail arm vs the same tick with the plain attention,
    over pools (and a tail) of ``kv_dtype``."""
    from llmd_kv_cache_tpu_torch.models.llama import (
        _decode_attention,
        _forward_impl,
        _plain_attention,
        forward_prefill,
        init_kv_cache,
    )

    rng = torch.Generator().manual_seed(3)
    prefix_pages = 4096 // model.page_size
    table = torch.zeros(8, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[:, :prefix_pages] = torch.arange(1, 1 + prefix_pages, device="cuda")
    k, v = init_kv_cache(model, 1 + prefix_pages, kv_dtype, device="cuda")
    prompt = torch.randint(1, model.vocab_size, (1, 4096), generator=rng).cuda()
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = torch.full((1,), 2048, dtype=torch.int32, device="cuda")
    forward_prefill(params, model, prompt[:, :2048], k, v, table[:1], zero, n, last_only=True)
    forward_prefill(params, model, prompt[:, 2048:], k, v, table[:1], n, n, last_only=True)
    base = torch.full((8,), 4096, dtype=torch.int32, device="cuda")
    live = torch.ones(8, dtype=torch.int32, device="cuda")
    tail_k = k.new_zeros((model.num_layers, 8, TAIL_SLOTS) + k.shape[2:3] + k.shape[4:])
    tail_v = v.new_zeros((model.num_layers, 8, TAIL_SLOTS) + v.shape[2:3] + v.shape[4:])
    step = torch.randint(1, model.vocab_size, (8,), generator=rng).cuda()
    for tick in range(TAIL_SLOTS - 1):
        logits, _, _ = _forward_impl(params, model, step[:, None], k, v, table, base + tick,
                                     live, _decode_attention, False,
                                     tails=(tail_k, tail_v, base))
        step = logits[:, 0].argmax(-1)
    tails2 = (tail_k.clone(), tail_v.clone(), base)
    ctx = base + TAIL_SLOTS - 1
    got, _, _ = _forward_impl(params, model, step[:, None], k, v, table, ctx, live,
                              _decode_attention, False, tails=(tail_k, tail_v, base))
    ref, _, _ = _forward_impl(params, model, step[:, None], k, v, table, ctx, live,
                              _plain_attention, False, tails=tails2)
    torch.cuda.synchronize()
    tag = kv_tag(kv_dtype is not None)
    if got.shape != (8, 1, model.vocab_size) or not torch.isfinite(got).all():
        fail(f"{tag}burst tick logits: shape {tuple(got.shape)} or non-finite values")
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"{tag}burst tick logits (tail length {TAIL_SLOTS}, {model.num_layers} layers), "
          f"kernels vs plain attention: max_abs_err={err:.4e}, max|logit|={scale:.4e} "
          f"(tol {LOGITS_REL_TOL} relative)", flush=True)
    if err > LOGITS_REL_TOL * scale:
        fail(f"{tag}burst tick logits through the kernels' tail arm disagree with the "
             "plain path")
    return dict(max_abs_err=err, relative=err / scale)


# ---------------------------------------------------------------------------
# Phase 9: the offload path
# ---------------------------------------------------------------------------

OFFLOAD_BLOCKS = 260  # the 4160-token prompt's full blocks
RESTORED_BLOCKS = 256  # its 4096-token prefix
LEG_REPEATS = 3


def fs_type(path: str) -> str:
    """The filesystem type and mount point that ``path`` lies on."""
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            mnt = fields[1]
            if ((path == mnt or path.startswith(mnt.rstrip("/") + "/"))
                    and len(mnt) >= len(best)):
                best, kind = mnt, fields[2]
    return f"{kind} on {best}"


def offload_spec_for(model, root: str, name: str, dtype="bfloat16"):
    """The pods' store: one block a file, crc32 footers, 4 I/O threads."""
    from llmd_kv_cache_tpu_torch.offload.spec import SharedStorageOffloadSpec

    return SharedStorageOffloadSpec(
        root=root, model_name=name, page_size=model.page_size,
        num_layers=model.num_layers, kv_heads=model.kv_cache_heads,
        head_dim=model.kv_cache_head_dim, kv_streams=1 if model.is_mla else 2,
        blocks_per_file=1, integrity="crc32", io_threads=4, dtype=dtype,
        sliding_window=model.sliding_window, swa_layers=model.swa_layers,
        attention_sinks=model.attention_sinks)


def pool_slab(torch, pod, pages):
    """The pod's pages as one slab ``[layers, streams, n, kvh, page, hd]`` on
    the card: the bytes a block file holds, page after page."""
    ids = torch.tensor(pages, device="cuda")
    pools = [pod.k_cache] + ([] if pod.cfg.model.is_mla else [pod.v_cache])
    return torch.stack([p.index_select(1, ids) for p in pools], dim=1)


def timed_calls(obj, name: str) -> list:
    """Accumulate the wall ms of one method's calls (a one-element list)."""
    cell = [0.0]
    inner = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            cell[0] += (time.perf_counter() - t) * 1e3

    setattr(obj, name, wrapper)
    return cell


def offload_round_trip(torch, ops, fleet, root, tag, model, params, name, pods,
                       ref_pod, dtype="bfloat16", **pod_kw) -> dict:
    """A writer pod serves a cold 4160-token prompt A with write-through and
    flushes. A fresh pod on the same store takes prompt B (A's 4096-token
    prefix + 64 new tokens) through ``add_request`` and restores the prefix
    (256 blocks) instead of recomputing it; its tokens must equal those of
    ``ref_pod`` (the same params, no store), which computes B cold, and so
    the prefix in the same two 2048-token chunks as the writer. With a third
    pod name, a fresh pod takes prompt E (the prefix + 64 others) through
    ``enqueue`` while 8 rows decode. Every kernel counter is zeroed just
    before each pod's run and read just after. ``dtype`` is the store's
    element type and ``pod_kw`` go to the pods' EngineConfig (an fp8 round
    trip: ``float8_e4m3fn`` and ``kv_cache_dtype``, every GQA launch an fp8
    one)."""
    from llmd_kv_cache_tpu_torch.events.model import BlockStoredEvent
    from llmd_kv_cache_tpu_torch.resilience.integrity import footer_size

    spec = offload_spec_for(model, root, name, dtype)
    layers = model.num_layers
    prefill_fn = ("cuda_paged_latent_prefill_attention" if model.is_mla
                  else "cuda_paged_prefill_attention")
    decode_fn = ("cuda_paged_latent_decode_attention" if model.is_mla
                 else "cuda_paged_decode_attention")
    tokens = fleet["tokens"]

    def sync_ms(t_start):
        torch.cuda.synchronize()
        return (time.perf_counter() - t_start) * 1e3

    def check_launches(pod, launches, chunks, steps):
        others = {k: n for k, n in launches.items() if k not in (prefill_fn, decode_fn)}
        if (launches[prefill_fn] != layers * chunks or launches[decode_fn] != layers * steps
                or any(others.values())):
            fail(f"{pod}: kernel launches {launches} for {chunks} prefill chunks and "
                 f"{steps} decode steps x {layers} layers")
        fp8 = read_launches_fp8(ops)
        if "kv_cache_dtype" in pod_kw and any(launches[fn] != n for fn, n in fp8.items()):
            fail(f"{pod}: kernel launches {launches}, of them fp8 {fp8}")

    # An fp8 round trip runs no plain attention on any pod.
    plain = PlainCalls() if "kv_cache_dtype" in pod_kw else None

    # --- the writer ---
    writer = fleet["add_pod"](pods[0], pod_model=model, pod_params=params,
                              pod_model_name=name, offload_spec=spec, **pod_kw)
    w_chunks, w_steps = record_calls(writer, "_prefill_chunk"), record_calls(writer, "_decode_chunk")
    store_ms = timed_calls(writer.offload_handlers, "async_store_blocks")
    # Warm-up: the first store's pinned buffers and the I/O threads' first
    # files, at the cold prompt's chunk shapes.
    writer.generate(f"{tag}W", tokens(2048 + 64), max_new_tokens=2)
    writer.flush_offload()
    prefix = tokens(4096)
    prompt = prefix + tokens(64)
    zero_launches(ops)
    w_chunks.clear()
    w_steps.clear()
    store_ms[0] = 0.0
    t = time.perf_counter()
    req_w = writer.add_request(f"{tag}A", prompt, max_new_tokens=16)
    ttft_cold_ms = sync_ms(t)
    store_in_ttft_ms = store_ms[0]
    while not req_w.done:
        writer.step()
    t = time.perf_counter()
    writer.flush_offload()
    flush_ms = sync_ms(t)
    launches_w = read_launches(ops)
    check_launches(pods[0], launches_w, len(w_chunks), len(w_steps))
    if len(w_chunks) != 3:
        fail(f"{pods[0]}: {len(w_chunks)} prefill chunks for the cold 4160-token prompt")

    mapper = writer.offload_handlers.mapper
    hashes = req_w.block_hashes
    base = os.path.join(root, "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
                        + "_" + mapper.fingerprint)
    paths = [mapper.block_path(h) for h in hashes]
    missing = [p for p in paths if not os.path.exists(p)]
    if (len(hashes) != OFFLOAD_BLOCKS or missing or not os.path.exists(mapper.config_path())
            or not all(p.startswith(base) for p in paths)):
        fail(f"{pods[0]}: {len(hashes)} blocks, {len(missing)} files missing under {base}")
    slot = writer.offload_handlers.slot_bytes
    w_pages = [writer.block_manager.blocks[h].page for h in hashes]
    for i in range(0, OFFLOAD_BLOCKS, OFFLOAD_BLOCKS // 16)[:16]:
        with open(paths[i], "rb") as f:
            data = f.read()
        want = pool_slab(torch, writer, [w_pages[i]]).cpu().view(torch.uint8).numpy()
        if len(data) != slot + footer_size(1) or data[:slot] != want.tobytes():
            fail(f"{pods[0]}: block file {i} differs from the pool's page")
    print(f"{pods[0]}: cold TTFT {ttft_cold_ms:.3f} ms ({store_in_ttft_ms:.3f} ms of it "
          f"in the write-through submit), flush {flush_ms:.3f} ms, {OFFLOAD_BLOCKS} files "
          f"of {slot + footer_size(1)} B under {base}, 16 sampled pages bit-equal",
          flush=True)

    # --- a fresh pod on the same store: add_request ---
    prompt_b = prefix + tokens(64)
    want_b = fleet["engines"][ref_pod].generate(f"{tag}RB", prompt_b, max_new_tokens=16)
    reader = fleet["add_pod"](pods[1], pod_model=model, pod_params=params,
                              pod_model_name=name, offload_spec=spec, **pod_kw)
    r_chunks, r_steps = record_calls(reader, "_prefill_chunk"), record_calls(reader, "_decode_chunk")
    restore_ms = timed_calls(reader, "_restore_from_storage")
    # The restore's parts on the engine thread; the rest of it is waiting
    # for kvio's reads (and the commit).
    parts = {name: timed_calls(obj, name) for obj, name in (
        (reader.offload_manager, "lookup"),
        (reader.offload_handlers, "async_load_blocks"),
        (reader.offload_handlers, "_verify_load"),
        (reader.offload_handlers.copier, "scatter_many_from_host"))}
    zero_launches(ops)
    t = time.perf_counter()
    req_r = reader.add_request(f"{tag}B", prompt_b, max_new_tokens=16)
    ttft_storage_ms = sync_ms(t)
    restore_in_ttft_ms = restore_ms[0]
    restore_parts_ms = {name: cell[0] for name, cell in parts.items()}
    n_chunks = len(r_chunks)
    while not req_r.done:
        reader.step()
    torch.cuda.synchronize()
    launches_r = read_launches(ops)
    check_launches(pods[1], launches_r, n_chunks, len(r_steps))
    print(f"{pods[1]}: restored {req_r.restored_blocks} blocks, cached_len "
          f"{req_r.cached_len}, {n_chunks} prefill chunk(s), launches {launches_r}",
          flush=True)
    if req_r.restored_blocks != RESTORED_BLOCKS or req_r.cached_len != 4096:
        fail(f"{pods[1]}: restored {req_r.restored_blocks} blocks, cached_len "
             f"{req_r.cached_len}")
    if n_chunks != 1 or launches_r[prefill_fn] != layers:
        fail(f"{pods[1]}: {n_chunks} prefill chunks, {launches_r[prefill_fn]} launches "
             "(one 64-token chunk expected)")
    r_pages = [reader.block_manager.blocks[h].page for h in hashes[:RESTORED_BLOCKS]]
    if not torch.equal(pool_slab(torch, reader, r_pages),
                       pool_slab(torch, writer, w_pages[:RESTORED_BLOCKS])):
        fail(f"{pods[1]}: restored pages differ from {pods[0]}'s")
    if req_r.output != want_b:
        fail(f"{pods[1]}: tokens {req_r.output} differ from {ref_pod}'s {want_b}")
    # HBM-warm on the same pod: the prefix is now resident.
    t = time.perf_counter()
    req_h = reader.add_request(f"{tag}H", prefix + tokens(64), max_new_tokens=1)
    ttft_hbm_ms = sync_ms(t)
    if req_h.cached_len != 4096 or req_h.restored_blocks:
        fail(f"{pods[1]}: HBM-warm request cached_len {req_h.cached_len}")
    # Storage-warm again on the same pod, its staging pool now allocated.
    reader.reset_cache()
    for cell in (restore_ms, *parts.values()):
        cell[0] = 0.0
    t = time.perf_counter()
    req_r2 = reader.add_request(f"{tag}B2", prefix + tokens(64), max_new_tokens=1)
    ttft_storage_again_ms = sync_ms(t)
    restore_again_parts_ms = {name: cell[0] for name, cell in parts.items()}
    if req_r2.restored_blocks != RESTORED_BLOCKS:
        fail(f"{pods[1]}: second restore took {req_r2.restored_blocks} blocks")
    for pod in pods[:2]:
        kinds = {e.kv_cache_spec_kind for e in fleet["events"][pod]
                 if isinstance(e, BlockStoredEvent)}
        want_kind = "mla_attention" if model.is_mla else "full_attention"
        if kinds != {want_kind}:
            fail(f"{pod}: BlockStored events tagged {kinds}, expected {want_kind}")
    print(f"{pods[1]}: TTFT restored {ttft_storage_ms:.3f} ms (restore "
          f"{restore_in_ttft_ms:.3f} ms), restored with a warm staging pool "
          f"{ttft_storage_again_ms:.3f} ms (restore {restore_ms[0]:.3f} ms), HBM-warm "
          f"{ttft_hbm_ms:.3f} ms; pages equal {pods[0]}'s, 16 tokens {ref_pod}'s; "
          f"restore parts (ms) {restore_parts_ms}, then {restore_again_parts_ms}",
          flush=True)

    out = dict(writer=writer, reader=reader, hashes=hashes,
               ttft_cold_ms=ttft_cold_ms, write_through_submit_in_ttft_ms=store_in_ttft_ms,
               flush_ms=flush_ms, ttft_storage_ms=ttft_storage_ms,
               restore_in_ttft_ms=restore_in_ttft_ms, restore_parts_ms=restore_parts_ms,
               ttft_storage_warm_staging_ms=ttft_storage_again_ms,
               restore_warm_staging_ms=restore_ms[0],
               restore_warm_staging_parts_ms=restore_again_parts_ms, ttft_hbm_ms=ttft_hbm_ms,
               launches={pods[0]: launches_w, pods[1]: launches_r})
    if plain is not None:
        plain.stop()
        if plain.calls:
            fail(f"{pods[0]}/{pods[1]}: {plain.calls} plain attention calls")
    if len(pods) > 2:
        out["deferred"] = deferred_restore(torch, ops, fleet, spec, model, params, name,
                                           pods[2], prefix, ref_pod)
    return out


def deferred_restore(torch, ops, fleet, spec, model, params, name, pod_name, prefix,
                     ref_name) -> dict:
    """A fresh pod decodes 8 rows (fresh 64-token prompts, 48 tokens each);
    once all 8 decode, prompt E (the stored prefix + 64 new tokens) is
    ``enqueue``d and its prefix restored while they go on. The rows' tokens
    must equal ``ref_name``'s for the same prompts without any restore (the
    same decode batches), and E's those of ``ref_name``, whose pool holds
    the prefix (the same 64-token chunk over it)."""
    tokens = fleet["tokens"]
    row_prompts = [tokens(64) for _ in range(8)]
    prompt = prefix + tokens(64)
    ref_pod = fleet["engines"][ref_name]
    ref = [ref_pod.enqueue(f"OR{i}", p, max_new_tokens=48) for i, p in enumerate(row_prompts)]
    while any(not r.done for r in ref):
        ref_pod.step()
    want = ref_pod.generate("ORE", prompt, max_new_tokens=16)
    pod = fleet["add_pod"](pod_name, pod_model=model, pod_params=params,
                           pod_model_name=name, offload_spec=spec)
    chunks, steps = record_calls(pod, "_prefill_chunk"), record_calls(pod, "_decode_chunk")
    zero_launches(ops)
    rows = [pod.enqueue(f"OD{i}", p, max_new_tokens=48) for i, p in enumerate(row_prompts)]
    while any(r.prefill_pos is not None for r in rows):
        pod.step()
    before_ms = []
    for _ in range(4):  # the 8 rows' decode steps alone
        t = time.perf_counter()
        pod.step()
        torch.cuda.synchronize()
        before_ms.append((time.perf_counter() - t) * 1e3)
    req = pod.enqueue("OD", prompt, max_new_tokens=16)
    in_flight, total, restore_steps_ms = 0, 0, []
    while not (req.done and all(r.done for r in rows)):
        waiting = req.prefill_pos is not None and req.cached_len == 0
        t = time.perf_counter()
        pod.step()
        torch.cuda.synchronize()
        if waiting:  # the steps that started, polled or landed the restore
            restore_steps_ms.append((time.perf_counter() - t) * 1e3)
        total += 1
        in_flight += req.restore_job is not None
    launches = read_launches(ops)
    layers = model.num_layers
    print(f"{pod_name}: deferred restore of {req.restored_blocks} blocks in flight "
          f"for {in_flight} of {total} steps while 8 rows decoded; {len(chunks)} prefill "
          f"chunks, {len(steps)} decode steps, launches {launches}; host ms of the rows' "
          f"steps alone {before_ms}, of the steps that started, polled or landed the "
          f"restore {restore_steps_ms}", flush=True)
    if (launches["cuda_paged_prefill_attention"] != layers * len(chunks)
            or launches["cuda_paged_decode_attention"] != layers * len(steps)):
        fail(f"{pod_name}: launches {launches} for {len(chunks)} chunks, {len(steps)} steps")
    if req.restored_blocks != RESTORED_BLOCKS or req.output != want:
        fail(f"{pod_name}: restored {req.restored_blocks} blocks, tokens {req.output}")
    if [r.output for r in rows] != [r.output for r in ref]:
        fail(f"{pod_name}: the decode rows' tokens differ from {ref_name}'s")
    return dict(restored_blocks=req.restored_blocks, steps_in_flight=in_flight,
                steps=total, launches=launches, decode_step_ms_alone=before_ms,
                restore_step_ms=restore_steps_ms)


def wait_io(io, job: int) -> int:
    """Poll a kvio engine until ``job`` completes; its status."""
    while True:
        for jid, status in io.poll_finished():
            if jid == job:
                return status
        time.sleep(0.0002)


def offload_legs(torch, root, tag, trip) -> dict:
    """The write-through and the restore of 256 blocks split into legs, each
    timed alone on the pods' own handlers and files, LEG_REPEATS times:
    gather + device-to-pinned copy; the CRC footer and concatenation; the
    kvio write to fresh files; the manager's lookup of the 256 files; the
    kvio read of the store's files (from the page cache, then after
    POSIX_FADV_DONTNEED on each); the CRC verification; pinned-to-device
    copy + scatter into the reader's pages (the same bytes). Beside them,
    one contiguous pinned copy of the same bytes each way."""
    import numpy as np

    from llmd_kv_cache_tpu_torch.offload.native import (
        STATUS_OK,
        NativeIOEngine,
        card_numa_node,
    )
    from llmd_kv_cache_tpu_torch.offload.staging import HostStagingPool, host_buffer
    from llmd_kv_cache_tpu_torch.resilience.integrity import footer_size, verify_slots

    writer, reader = trip["writer"], trip["reader"]
    handlers = writer.offload_handlers
    copier = handlers.copier
    hashes = trip["hashes"][:RESTORED_BLOCKS]
    w_pages = [writer.block_manager.blocks[h].page for h in hashes]
    r_pages = [reader.block_manager.blocks[h].page for h in hashes]
    slot = copier.slab_nbytes(1)
    nbytes = slot * RESTORED_BLOCKS
    io = NativeIOEngine(num_threads=4, read_preferring_workers=3,
                        numa_node=card_numa_node(torch.device("cuda")))
    legs = {k: [] for k in ("gather_d2h", "crc_footer", "kvio_write", "lookup",
                            "kvio_read_cached", "kvio_read_evicted", "crc_verify",
                            "h2d_scatter", "pinned_d2h", "pinned_h2d")}

    def clock(leg, t):
        legs[leg].append((time.perf_counter() - t) * 1e3)

    try:
        for rep in range(LEG_REPEATS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            slabs = copier.gather_many_to_host([[p] for p in w_pages])
            clock("gather_d2h", t)
            t = time.perf_counter()
            bufs = [handlers._with_footer(s, 1) for s in slabs]
            clock("crc_footer", t)
            out_dir = os.path.join(root, f"legs-{tag}-{rep}")
            os.makedirs(out_dir)
            t = time.perf_counter()
            job = io.begin_job()
            for i, buf in enumerate(bufs):
                path = os.path.join(out_dir, f"{i}.bin")
                if not io.submit_write(job, path, path + ".tmp", buf, skip_if_exists=False):
                    fail(f"{tag}: kvio shed a leg write")
            io.seal_job(job)
            if wait_io(io, job) != STATUS_OK:
                fail(f"{tag}: kvio write leg failed")
            clock("kvio_write", t)
            handlers._release_buffers(bufs)

        staging = HostStagingPool(slot_bytes=slot, slots=RESTORED_BLOCKS, pinned=True)
        dests = [staging.acquire(slot) for _ in hashes]
        footers = [np.empty(footer_size(1), np.uint8) for _ in hashes]
        paths = [handlers.mapper.block_path(h) for h in hashes]

        def read_all(leg):
            t = time.perf_counter()
            job = io.begin_job()
            for path, dest, footer in zip(paths, dests, footers):
                io.submit_read(job, path, dest, 0)
                io.submit_read(job, path, footer, slot)
            io.seal_job(job)
            if wait_io(io, job) != STATUS_OK:
                fail(f"{tag}: kvio read leg failed")
            clock(leg, t)

        for rep in range(LEG_REPEATS):
            t = time.perf_counter()
            found = reader.offload_manager.lookup(hashes)
            clock("lookup", t)
            if found != RESTORED_BLOCKS:
                fail(f"{tag}: lookup found {found} of {RESTORED_BLOCKS} blocks")
        for rep in range(LEG_REPEATS):
            read_all("kvio_read_cached")
        for rep in range(LEG_REPEATS):
            for path in paths:
                fd = os.open(path, os.O_RDONLY)
                try:
                    os.fsync(fd)
                    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                finally:
                    os.close(fd)
            read_all("kvio_read_evicted")
        for rep in range(LEG_REPEATS):
            t = time.perf_counter()
            for dest, footer in zip(dests, footers):
                verify_slots([dest], bytes(footer))
            clock("crc_verify", t)
        slabs_r = [(np.frombuffer(d, dtype=copier.dtype).reshape(copier.slab_shape(1)), [p])
                   for d, p in zip(dests, r_pages)]
        r_copier = reader.offload_handlers.copier
        for rep in range(LEG_REPEATS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r_copier.scatter_many_from_host(slabs_r)
            torch.cuda.synchronize()
            clock("h2d_scatter", t)
        if not torch.equal(pool_slab(torch, reader, r_pages), pool_slab(torch, writer, w_pages)):
            fail(f"{tag}: the scatter leg changed the restored pages")

        pinned, _ = host_buffer(nbytes, pinned=True)
        dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        for rep in range(LEG_REPEATS):
            for leg, dst, src in (("pinned_d2h", pinned, dev), ("pinned_h2d", dev, pinned)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                dst.copy_(src, non_blocking=True)
                torch.cuda.synchronize()
                clock(leg, t)
    finally:
        io.close()
    gbps = {leg: nbytes / min(ms) / 1e6 for leg, ms in legs.items()}
    print(f"{tag} offload legs over {RESTORED_BLOCKS} blocks ({nbytes} B), best GB/s: "
          f"{ {k: round(v, 3) for k, v in gbps.items()} }", flush=True)
    return dict(bytes=nbytes, ms=legs, best_gbps=gbps)


def offload_path(torch, ops, fleet, mpath) -> dict:
    """Phase 9: the shared-storage tier on the GQA model (pod-o writes,
    pod-o2 restores through add_request, pod-o3 through enqueue) and the MLA
    model (pod-mo writes, pod-mo2 restores), in a temporary store removed at
    the end, with the legs of both models' write-through and restore."""
    from llmd_kv_cache_tpu_torch.offload.native import card_numa_node, card_pci_bus_id

    root = tempfile.mkdtemp(prefix="chip-smoke-offload-")
    try:
        fs = fs_type(os.path.realpath(root))
        node = card_numa_node(torch.device("cuda"))
        print(f"offload store: {root} ({fs}); card {card_pci_bus_id(0)}, kvio NUMA node "
              f"argument {node} (-2: the card's sysfs entry names no node)", flush=True)
        gqa = offload_round_trip(torch, ops, fleet, root, "gqa", fleet["model"],
                                 fleet["params"], fleet["model_name"],
                                 ("pod-o", "pod-o2", "pod-o3"), "pod-0")
        mla = offload_round_trip(torch, ops, fleet, root, "mla", mpath["model"],
                                 mpath["params"], mpath["model_name"], ("pod-mo", "pod-mo2"),
                                 "pod-m")
        legs = {"gqa": offload_legs(torch, root, "gqa", gqa),
                "mla": offload_legs(torch, root, "mla", mla)}
        io = gqa["writer"].offload_handlers.io
        keep = ("ttft_cold_ms", "write_through_submit_in_ttft_ms", "flush_ms",
                "ttft_storage_ms", "restore_in_ttft_ms", "restore_parts_ms",
                "ttft_storage_warm_staging_ms", "restore_warm_staging_ms",
                "restore_warm_staging_parts_ms", "ttft_hbm_ms", "launches", "deferred")
        return dict(store=root, filesystem=fs, kvio_numa_node_arg=node,
                    kvio_numa_node=io.numa_node(), io_worker_cpus=io.worker_cpus(),
                    gqa={k: gqa[k] for k in keep if k in gqa},
                    mla={k: mla[k] for k in keep if k in mla}, legs=legs)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 10: fp8 (e4m3) KV pools
# ---------------------------------------------------------------------------

# bench.py's fp8 pods (KVTPU_BENCH_FP8): twice the bf16 pods' pages, at the
# same bytes (2048 pages of fp8 K and V are 1 GiB for the GQA model).
FP8_PAGES = 2048
FP8_POD = dict(kv_cache_dtype="f8_e4m3", num_pages=FP8_PAGES)


def fp8_cast_check(torch) -> None:
    """The engine's cast into an fp8 pool (``to_kv_dtype``) on the card,
    byte-equal to the same cast on the CPU (which the CPU tests hold against
    JAX's ``astype(jnp.float8_e4m3fn)``): all 65,536 bf16 patterns, and
    fp32 values at, and one ulp either side of, every e4m3 midpoint."""
    from llmd_kv_cache_tpu_torch.ops import kv_pages

    fp8 = torch.float8_e4m3fn
    finite = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(fp8).float()
    finite = finite[torch.isfinite(finite)].unique()
    mids = (finite[1:] + finite[:-1]) / 2
    cases = {"bf16 patterns": torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
             .view(torch.bfloat16),
             "fp32 midpoints": torch.cat([mids, torch.nextafter(mids, finite.new_tensor(1e9)),
                                          torch.nextafter(mids, finite.new_tensor(-1e9))])}
    for name, x in cases.items():
        cpu = kv_pages.to_kv_dtype(x, fp8)
        card = kv_pages.to_kv_dtype(x.cuda(), fp8).cpu()
        diff = int((cpu.view(torch.uint8) != card.view(torch.uint8)).sum())
        print(f"fp8 cast of {x.numel()} {name}: card vs CPU, {diff} bytes differ",
              flush=True)
        if diff:
            fail(f"the card's fp8 cast differs from the CPU's on {diff} {name}")


def fp8_vs_bf16_logits(torch, model, params, prompt) -> dict:
    """Information: one prefill chunk's logits (2048 tokens over a
    2048-token prefix, through the kernels) over fp8 pools against bf16
    pools, max |diff| / max |logit| and the cosine (JAX's own bound,
    tests/test_kv_fp8.py: below 0.25 and above 0.999)."""
    from llmd_kv_cache_tpu_torch.models.llama import forward_prefill, init_kv_cache

    num_pages = 4096 // model.page_size + 1
    table = torch.zeros(1, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[0, :num_pages - 1] = torch.arange(1, num_pages, device="cuda")
    toks = torch.tensor([prompt[:4096]], dtype=torch.int64, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = torch.full((1,), 2048, dtype=torch.int32, device="cuda")
    outs = {}
    for name, dtype in (("bf16", None), ("fp8", torch.float8_e4m3fn)):
        k, v = init_kv_cache(model, num_pages, dtype, device="cuda")
        forward_prefill(params, model, toks[:, :2048], k, v, table, zero, n, last_only=True)
        outs[name] = forward_prefill(params, model, toks[:, 2048:], k, v, table, n,
                                     n)[0].float().flatten()
        del k, v
    a, b = outs["fp8"], outs["bf16"]
    rel = float((a - b).abs().max() / b.abs().max())
    cos = float(a @ b / (a.norm() * b.norm()))
    print(f"fp8 vs bf16 pools, prefill chunk logits (information): max|diff| / max|logit| "
          f"{rel:.4f}, cosine {cos:.6f} (JAX's bound: < 0.25, > 0.999)", flush=True)
    return dict(max_diff_over_max_logit=rel, cosine=cos)


def fp8_arms(torch, ops, gen) -> dict:
    """Phase 10's kernels: the card's cast; each fp8 arm against its plain
    version (the parity cases of phase 3, SWA 1000 + sinks 20 among them)
    and timed; the decode at bench's fp8 probe shape, b 32 over ctx 2048,
    bf16 and fp8 in turns. Run beside phase 3: the profiler's device times
    are taken before any profile of the serving phases (a session after
    those has been seen to record only part of its launches)."""
    fp8_cast_check(torch)
    out = dict(decode=decode_parity(torch, ops, gen, fp8=True),
               tail=decode_tail_parity(torch, ops, gen, fp8=True),
               prefill=prefill_parity(torch, ops, gen, fp8=True),
               ragged=ragged_parity(torch, ops, gen, fp8=True))
    probe = {"bf16": [], "fp8": []}
    for kind in ("bf16", "fp8", "fp8", "bf16"):  # in turns
        run = decode_timing(torch, ops, gen, 0, batch=32, ctx_len=2048, fp8=kind == "fp8")
        probe[kind].append({k: run[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "splits", "sdpa_contiguous_ms")})
    return dict(out, decode_b32_ctx2048=probe)


def fp8_path(torch, ops, fleet, arms) -> dict:
    """Phase 10: the GQA model with fp8 e4m3 KV pools (bench.py's fp8 pods:
    ``kv_cache_dtype="f8_e4m3"``, 2048 pages) on the same Indexer under its
    own model name, with ``pod-0``'s params; ``arms`` are its kernels'
    results (``fp8_arms``). ``pod-f`` (padded),
    ``pod-fr`` (ragged) and ``pod-fb`` (bursts of 8) serve phase 8's traffic
    (phase 6's for ``pod-fr``) with every counter zeroed just before and
    read just after: every GQA launch an fp8 one, no plain attention call;
    ``pod-fo`` writes an fp8 store that a fresh ``pod-fo2`` restores (pages
    bit-equal, ``pod-f``'s tokens). One prefill chunk's, one mixed
    dispatch's and one burst tick's logits through the fp8 arms against the
    plain attention over the same fp8 pools; printed: fp8 against bf16
    logits, greedy agreement (``pod-f`` with ``pod-0``, ``pod-fb`` with
    ``pod-f``) and host ms per token beside ``pod-0`` and ``pod-b``, in
    turns, with a profile of one step each."""
    fp8 = torch.float8_e4m3fn
    model, params, tokens = fleet["model"], fleet["params"], fleet["tokens"]
    name = fleet["model_name"] + "-fp8"
    common = (model, params, name, fleet["prefix"], fleet["batch_prompts"])
    # pod-f's greedy tokens beside pod-0's (bf16 pools), pod-fb's beside
    # pod-f's (the same fp8 pools, single steps).
    padded = burst_path(torch, ops, fleet, "pod-f", *common, fleet["batch_outputs"], burst=1,
                        **FP8_POD)
    ragged = ragged_path(torch, ops, fleet, "pod-fr", name, **FP8_POD)
    burst = burst_path(torch, ops, fleet, "pod-fb", *common, padded["outputs"], **FP8_POD)
    root = tempfile.mkdtemp(prefix="chip-smoke-fp8-")
    try:
        trip = offload_round_trip(torch, ops, fleet, root, "fp8", model, params, name,
                                  ("pod-fo", "pod-fo2"), "pod-f", dtype="float8_e4m3fn",
                                  **FP8_POD)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    logits = {"prefill_chunk": logits_parity(torch, model, params, tokens(4096), fp8),
              "mixed_dispatch": ragged_logits_parity(torch, model, params, fp8),
              "burst_tick": burst_tick_logits_parity(torch, model, params, fp8)}
    vs_bf16 = fp8_vs_bf16_logits(torch, model, params, tokens(4096))
    engines = fleet["engines"]
    per_token = {p: [] for p in ("pod-0", "pod-f", "pod-b", "pod-fb")}
    profiles = {}
    for pod in ("pod-0", "pod-f", "pod-f", "pod-0", "pod-b", "pod-fb", "pod-fb", "pod-b"):
        run = decode_token_ms(torch, engines[pod], [fleet["prefix"] + tokens(64)
                                                    for _ in range(8)],
                              timed_steps=2 if engines[pod]._burst > 1 else 16,
                              profile=pod not in profiles)
        per_token[pod].append(run["ms_per_token"])
        profiles.setdefault(pod, run.get("profile_one_step"))
    print(f"host ms per generated token at batch 8 (fp8 pods beside bf16 pods, in turns): "
          f"{per_token}", flush=True)
    keep = ("ttft_cold_ms", "ttft_storage_ms", "ttft_storage_warm_staging_ms", "ttft_hbm_ms",
            "launches")
    return dict(arms, pods={"pod-f": padded, "pod-fr": ragged, "pod-fb": burst},
                offload={k: trip[k] for k in keep}, logits=logits, fp8_vs_bf16=vs_bf16,
                host_ms_per_token_b8=per_token, profile_one_step_b8=profiles)


# ---------------------------------------------------------------------------
# Phase 11: absorbed MLA on the ragged scheduler
# ---------------------------------------------------------------------------

def mla_ragged_path(torch, ops, fleet, mpath) -> dict:
    """``pod-mr``: a ragged pod (``ragged_attention=True``) of the MLA model
    with ``pod-m``'s params, EngineConfig and 1024 pages on the same
    Indexer, serving ``pod-r``'s traffic over ``pod-m``'s prefix and batch
    (``ragged_path``: every ragged launch on the shared_kv arm, no other
    attention launch and no plain call, routing 260 blocks); one mixed
    dispatch's logits against the plain attention (5%); then, printed and
    not held, the host ms of a mixed step (8 decode rows + a 2048-token
    chunk) and of a decode step at batch 8, ``pod-mr`` beside ``pod-m`` in
    turns, with a profile of one mixed step each, and the phase's wall
    time."""
    t0 = time.perf_counter()
    mfleet = dict(fleet, model=mpath["model"], model_name=mpath["model_name"],
                  prefix=mpath["prefix"], batch_prompts=mpath["batch_prompts"],
                  batch_outputs=mpath["batch_outputs"])
    path = ragged_path(torch, ops, mfleet, "pod-mr", padded="pod-m",
                       pod_model=mpath["model"], pod_params=mpath["params"])
    check_latent_splits_by_shape(path["launches_by_shape"])
    logits_err = ragged_logits_parity(torch, mpath["model"], mpath["params"])
    q72 = ragged_q72_logits(torch, ops, mpath["model"], mpath["params"])
    tokens, prefix = fleet["tokens"], mpath["prefix"]
    steps = {"pod-m": [], "pod-mr": []}
    for pod in ("pod-m", "pod-mr", "pod-mr", "pod-m"):  # in turns
        steps[pod].append(mixed_step_timing(
            torch, fleet["engines"][pod], [prefix + tokens(64) for _ in range(8)],
            tokens(4160)))
    wall_s = time.perf_counter() - t0
    out = {"mixed_step_ms": {p: [x for r in runs for x in r["mixed_step_ms"]]
                             for p, runs in steps.items()},
           "decode_step_ms_b8": {p: [x for r in runs for x in r["decode_step_ms_b8"]]
                                 for p, runs in steps.items()},
           "profile_mixed_step": {p: runs[0]["profile_mixed_step"] for p, runs in steps.items()}}
    print(f"pod-mr beside pod-m (host ms, in turns): mixed {out['mixed_step_ms']}, decode "
          f"b8 {out['decode_step_ms_b8']}; phase 11 wall time {wall_s:.1f} s", flush=True)
    return dict(path, **out, mixed_dispatch_logits_max_abs_err=logits_err, q72_logits=q72,
                wall_s=wall_s)


def check_latent_splits_by_shape(by_shape) -> None:
    """``pod-mr``'s counted launches by shape class ("latent q<flat
    tokens>/rows<rows>/splits<decode>x<prefill>"): the dispatches whose
    chunk row is 64 tokens (chunk-only, and q65-q72 beside 1-8 decode rows)
    ran their prefill tiles split, the 2048-token chunks unsplit, as
    planned from shapes only."""
    for key in by_shape:
        found = re.fullmatch(r"latent q(\d+)/rows(\d+)/splits(\d+)x(\d+)", key)
        if not found:
            fail(f"pod-mr: ragged launch shape {key!r} is not a latent one")
        total_q, rows, _, prefill_splits = map(int, found.groups())
        chunk = total_q - rows + 1  # the chunk row's tokens, when the dispatch has one
        if (chunk == 64 and prefill_splits < 2) or (chunk == 2048 and prefill_splits != 1):
            fail(f"pod-mr: {key}: the {chunk}-token chunk's tiles ran {prefill_splits} "
                 "splits")
    print(f"pod-mr prefill splits by shape: the 64-token chunks split, the 2048-token "
          f"chunks unsplit ({len(by_shape)} shape classes)", flush=True)


def brief(shapes) -> dict:
    """Timed ragged shapes for the kernels line: their numbers and plans,
    without the by-kernel lists printed with each timing."""
    return {name: {k: v for k, v in t.items() if k != "by_kernel"}
            for name, t in shapes.items()}


# ---------------------------------------------------------------------------
# Phase 12: disaggregated prefill/decode serving
# ---------------------------------------------------------------------------

HANDOFF_BLOCKS = 260  # the 4160-token prompt's full blocks
FIRST_CHUNK_BLOCKS = 128  # a 2048-token chunk's


class PodLaunches:
    """Kernel launches by pod: the counters' advance over each of a pod's
    ``step()`` calls, summed (the pods step in turns on one thread)."""

    def __init__(self, ops, pods):
        self.ops = ops
        self.pods = pods
        self.reset()

    def reset(self) -> None:
        self.by_pod = {pod: dict.fromkeys(LAUNCH_COUNTED, 0) for pod in self.pods}

    def read(self) -> dict:
        """{pod: {wrapper: launches}}, the wrappers that launched."""
        return {pod: {fn: k for fn, k in n.items() if k} for pod, n in self.by_pod.items()}

    def step(self, pod, engine):
        before = read_launches(self.ops)
        out = engine.step()
        for fn, n in read_launches(self.ops).items():
            self.by_pod[pod][fn] += n - before[fn]
        return out


def shed_decisions() -> dict:
    """The engines' admission decisions so far by outcome (the
    ``kvtpu_shed_decisions_total`` family, site ``engine.admission``)."""
    from llmd_kv_cache_tpu_torch.metrics.collector import sample_values

    return {dict(labels)["outcome"]: v for (_, labels), v in
            sample_values(["kvtpu_shed_decisions_total"]).items()
            if dict(labels).get("site") == "engine.admission"}


def chunk_of(engine):
    """(request id, tokens) of the prefill chunk ``engine`` computes next,
    from ``_prefill_chunk``'s argument."""
    return lambda req: (req.request_id, len(
        req.prompt[req.prefill_pos:req.prefill_pos + engine._chunk_cap()]))


def disagg_path(torch, ops, fleet) -> dict:
    """Phase 12: disaggregated prefill/decode serving. ``pod-p``
    (``role="prefill"``), ``pod-d`` (``role="decode"``, a CoDel shedder)
    and ``pod-d2`` (``role="both"``, the reference) share a posix store in
    a temporary directory (removed at the end); one ``HandoffCoordinator``
    with a ``ResidencyTracker``, also attached to the ``Indexer``, joins
    ``pod-p`` and ``pod-d``. Every kernel counter is zeroed just before each
    of the three runs and read just after: the complete handoff of a fresh
    4160-token prompt H beside 7 decoding rows, the prefill pod dying after
    F's first chunk, and F through ``pod-d2``'s deadline gate."""
    from llmd_kv_cache_tpu_torch.offload.handoff import HandoffCoordinator
    from llmd_kv_cache_tpu_torch.scoring.residency import ResidencyTracker

    t_phase = time.perf_counter()
    model, params, name = fleet["model"], fleet["params"], fleet["model_name"]
    tokens, indexer, layers = fleet["tokens"], fleet["indexer"], model.num_layers
    prefill_fn, decode_fn = "cuda_paged_prefill_attention", "cuda_paged_decode_attention"
    root = tempfile.mkdtemp(prefix="chip-smoke-disagg-")
    plain = PlainCalls()
    try:
        spec = offload_spec_for(model, root, name)
        pod_p = fleet["add_pod"]("pod-p", offload_spec=spec, role="prefill")
        pod_d = fleet["add_pod"]("pod-d", offload_spec=spec, role="decode",
                                 shed_target_delay_s=0.5, shed_interval_s=0.1)
        pod_d2 = fleet["add_pod"]("pod-d2", offload_spec=spec)
        print(f"disagg pods: pod-p, pod-d, pod-d2 on a store in {root} "
              f"({fs_type(os.path.realpath(root))}); card memory allocated "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
        tracker = ResidencyTracker()
        coord = HandoffCoordinator(residency=tracker)
        indexer.attach_residency(tracker)
        for pod in (pod_p, pod_d):
            pod.attach_handoff(coord)
        counted = PodLaunches(ops, ("pod-p", "pod-d", "pod-d2"))
        chunks = {p: record_calls(e, "_prefill_chunk", chunk_of(e))
                  for p, e in (("pod-p", pod_p), ("pod-d", pod_d), ("pod-d2", pod_d2))}
        pulls, d2_pulls = (record_calls(e.offload_handlers, "async_load_blocks",
                                        lambda blocks, *args, **kwargs: len(blocks))
                           for e in (pod_d, pod_d2))
        decode_calls = record_calls(pod_d, "_decode_chunk")

        def sync_ms(t_start):
            torch.cuda.synchronize()
            return (time.perf_counter() - t_start) * 1e3

        # Warm-up: pod-p's first stores (pinned buffers, the I/O threads'
        # first files) at the cold prompt's chunk shapes.
        warm = pod_p.enqueue("PW", tokens(2048 + 64), max_new_tokens=1)
        while not warm.done:
            pod_p.step()
        pod_p.flush_offload()
        # pod-d: a cold 4096-token prefix, then 7 of the main path's 8 warm
        # prompts over it, decoding (176 tokens fill max_pages_per_seq).
        pod_d.add_request("DP", fleet["prefix"], max_new_tokens=1)
        rows = [pod_d.enqueue(f"DL{i}", p, max_new_tokens=176)
                for i, p in enumerate(fleet["batch_prompts"][:7])]
        while any(r.prefill_pos is not None for r in rows):
            pod_d.step()
        pod_d.step()  # the last row's first decode step
        rows_alone_ms = []
        for _ in range(4):
            t = time.perf_counter()
            pod_d.step()
            rows_alone_ms.append(sync_ms(t))
        pod_d.flush_offload()

        # --- 1. the complete handoff of H: counters zeroed just before ---
        prompt_h = tokens(4160)
        coord.begin("H", "pod-p", "pod-d", total_blocks=HANDOFF_BLOCKS)
        zero_launches(ops)
        counted.reset()
        decode_calls.clear()
        del pulls[:], chunks["pod-p"][:], chunks["pod-d"][:]
        pref = pod_p.enqueue("H", prompt_h, max_new_tokens=1)
        t_enqueue = time.perf_counter()
        req_h = pod_d.enqueue("H", prompt_h, max_new_tokens=16, handoff=True)
        ttft_h_ms = None
        chunk_ms, pull_steps_ms, idle_steps_ms = [], [], []
        residency = None
        rows_at_first_token = None
        steps = 0
        deadline = time.monotonic() + 300.0
        while not req_h.done:
            if time.monotonic() > deadline:
                fail(f"pod-d: H not done after 300 s ({coord.debug()})")
            if not pref.done:
                t = time.perf_counter()
                counted.step("pod-p", pod_p)
                chunk_ms.append(sync_ms(t))
                if residency is None:
                    # Right after pod-p's first chunk landed, before pod-d
                    # steps again: pod-d ranks by the transfer alone.
                    pod_p.flush_offload()
                    detail: dict = {}
                    decode_scores = indexer.score_tokens(prompt_h, name, role="decode",
                                                         detail=detail)
                    plain_scores = indexer.score_tokens(prompt_h, name)
                    residency = dict(decode=decode_scores, detail=detail.get("residency"),
                                     role_agnostic=plain_scores)
                    print(f"score_tokens(H) after pod-p's first chunk landed: role=decode "
                          f"{decode_scores} (residency {detail.get('residency')}), no role "
                          f"{plain_scores}", flush=True)
                    if (decode_scores.get("pod-d") != float(FIRST_CHUNK_BLOCKS)
                            or detail.get("residency") != {"pod-d": float(FIRST_CHUNK_BLOCKS)}
                            or "pod-d" in plain_scores):
                        fail(f"residency routing: role=decode {decode_scores}, detail "
                             f"{detail}, no role {plain_scores}")
            pod_p.poll_offload()
            waiting = req_h.prefill_pos is not None
            in_flight = req_h.restore_job is not None
            t = time.perf_counter()
            emitted = counted.step("pod-d", pod_d)
            elapsed = sync_ms(t)
            steps += 1
            in_flight = in_flight or req_h.restore_job is not None
            if waiting:
                starved = [r.request_id for r in rows if not r.done
                           and r.request_id not in emitted]
                if starved:
                    fail(f"pod-d: rows {starved} emitted no token at step {steps} while "
                         "H waited")
                (pull_steps_ms if in_flight else idle_steps_ms).append(elapsed)
            if ttft_h_ms is None and req_h.output:
                ttft_h_ms = (time.perf_counter() - t_enqueue) * 1e3
                rows_at_first_token = sum(not r.done for r in rows)
        torch.cuda.synchronize()
        launches_h = counted.read()
        decode_steps_h = len(decode_calls)
        # --- end of run 1 ---
        outcomes = coord.starvation()["outcomes"]
        print(f"H: pod-p chunks {chunks['pod-p']} ({chunk_ms} host ms), pod-d pulls "
              f"{pulls} blocks, cached_len {req_h.cached_len}, restored "
              f"{req_h.restored_blocks}, pod-d chunks {chunks['pod-d']}, {steps} pod-d "
              f"steps ({decode_steps_h} decode), {rows_at_first_token} local rows decoding "
              f"at H's first token, TTFT {ttft_h_ms:.3f} ms, outcomes {outcomes}, "
              f"launches {launches_h}", flush=True)
        if (coord.completed != 1 or coord.failed or outcomes != {"complete": 1}
                or coord.state("H") is not None):
            fail(f"H: the handoff did not settle complete: {coord.debug()}")
        if req_h.cached_len != 4160 or req_h.restored_blocks != HANDOFF_BLOCKS:
            fail(f"pod-d: H cached_len {req_h.cached_len}, restored {req_h.restored_blocks}")
        want_p = {prefill_fn: layers * 3}
        if launches_h["pod-p"] != want_p or chunks["pod-p"] != [("H", 2048), ("H", 2048),
                                                                ("H", 64)]:
            fail(f"pod-p: launches {launches_h['pod-p']}, chunks {chunks['pod-p']}")
        want_d = {prefill_fn: layers, decode_fn: layers * decode_steps_h}
        if (launches_h["pod-d"] != want_d or chunks["pod-d"] != [("H", 1)]
                or decode_steps_h == 0):
            fail(f"pod-d: launches {launches_h['pod-d']}, chunks {chunks['pod-d']}, "
                 f"{decode_steps_h} decode steps")
        hashes = req_h.block_hashes
        sample = [hashes[i] for i in range(0, HANDOFF_BLOCKS, HANDOFF_BLOCKS // 16)[:16]]
        p_pages = [pod_p.block_manager.blocks[h].page for h in sample]
        d_pages = [pod_d.block_manager.blocks[h].page for h in sample]
        if not torch.equal(pool_slab(torch, pod_d, d_pages), pool_slab(torch, pod_p, p_pages)):
            fail("pod-d: restored pages differ from pod-p's")
        ref_h = pod_d2.add_request("H", prompt_h, max_new_tokens=16)
        while not ref_h.done:
            pod_d2.step()
        if (ref_h.restored_blocks != HANDOFF_BLOCKS or chunks["pod-d2"][-1] != ("H", 1)
                or req_h.output != ref_h.output):
            fail(f"H: pod-d's tokens {req_h.output}, pod-d2's {ref_h.output} (restored "
                 f"{ref_h.restored_blocks}, chunks {chunks['pod-d2']})")
        pulls_h = list(pulls)
        cold_h = fleet["engines"]["pod-0"].generate("HC", prompt_h, max_new_tokens=16)
        agree_h = sum(a == b for a, b in zip(req_h.output, cold_h))
        for r in rows:
            pod_d.abort_request(r.request_id)

        # --- 2. the prefill pod dies after F's first chunk ---
        prompt_f = tokens(4160)
        want_f = fleet["engines"]["pod-0"].generate("FC", prompt_f, max_new_tokens=16)
        coord.begin("F", "pod-p", "pod-d", total_blocks=HANDOFF_BLOCKS)
        zero_launches(ops)
        counted.reset()
        del pulls[:], chunks["pod-d"][:]
        pod_p.enqueue("F", prompt_f, max_new_tokens=1)
        deadline = time.monotonic() + 120.0
        t_enqueue = time.perf_counter()
        req_f = pod_d.enqueue("F", prompt_f, max_new_tokens=16, handoff=True)
        counted.step("pod-p", pod_p)  # chunk 1 computed, its store queued
        pod_p.flush_offload()  # ...and landed
        st = coord.state("F")
        if st is None or st.landed_blocks != FIRST_CHUNK_BLOCKS or st.done:
            fail(f"F: after chunk 1 the transfer is {st}")
        while req_f.cached_len < 2048:
            if time.monotonic() > deadline:
                fail("pod-d: F's first chunk never arrived")
            counted.step("pod-d", pod_d)
        pod_p.abort_request("F")  # the prefill pod dies mid-handoff
        if not coord.state("F").failed:
            fail("F: the transfer is not failed after pod-p's abort")
        ttft_f_ms = None
        while not req_f.done:
            counted.step("pod-d", pod_d)
            if ttft_f_ms is None and req_f.output:
                ttft_f_ms = sync_ms(t_enqueue)
        torch.cuda.synchronize()
        launches_f = counted.read()
        pulls_f = list(pulls)
        # --- end of run 2 ---
        outcomes = coord.starvation()["outcomes"]
        print(f"F (pod-p died after chunk 1): pod-d pulls {pulls_f}, cached_len "
              f"{req_f.cached_len}, restored {req_f.restored_blocks}, chunks "
              f"{chunks['pod-d']}, outcomes {outcomes}, TTFT {ttft_f_ms:.3f} ms, launches "
              f"{launches_f}", flush=True)
        if (coord.state("F") is not None or coord.failed < 1
                or outcomes != {"complete": 1, "fallback": 1}):
            fail(f"F: the handoff did not settle as a fallback: {coord.debug()}")
        if (req_f.cached_len != 2048 or req_f.restored_blocks != FIRST_CHUNK_BLOCKS
                or chunks["pod-d"] != [("F", 2048), ("F", 64)]):
            fail(f"pod-d: F cached_len {req_f.cached_len}, restored {req_f.restored_blocks}, "
                 f"chunks {chunks['pod-d']}")
        if req_f.output != want_f:
            fail(f"pod-d: F's tokens {req_f.output} differ from pod-0's {want_f}")
        pod_d.flush_offload()  # F's recomputed blocks written through too

        # --- 3. F through pod-d2's deadline gate ---
        zero_launches(ops)
        counted.reset()
        del d2_pulls[:], chunks["pod-d2"][:]
        stored = pod_d2.offload_manager.lookup(req_f.block_hashes)
        sheds0 = shed_decisions()
        t = time.perf_counter()
        req_s = pod_d2.enqueue("F", prompt_f, max_new_tokens=16, deadline_s=0)
        ttft_skip_ms = None
        while not req_s.done:
            counted.step("pod-d2", pod_d2)
            if ttft_skip_ms is None and req_s.output:
                ttft_skip_ms = sync_ms(t)
        torch.cuda.synchronize()
        launches_s = counted.read()
        skips = {k: v - sheds0.get(k, 0.0) for k, v in shed_decisions().items()
                 if v != sheds0.get(k, 0.0)}
        # --- end of run 3 ---
        print(f"F on pod-d2 with deadline_s=0: {stored} blocks on the store, pulls "
              f"{d2_pulls}, skips {skips}, cached_len {req_s.cached_len}, "
              f"chunks {chunks['pod-d2']}, TTFT {ttft_skip_ms:.3f} ms, launches "
              f"{launches_s['pod-d2']}", flush=True)
        if (stored != HANDOFF_BLOCKS or d2_pulls or req_s.cached_len
                or skips != {"restore_skip": 1} or req_s.output != want_f):
            fail(f"pod-d2: deadline gate: {stored} stored, pulls {d2_pulls}, skips "
                 f"{skips}, cached_len {req_s.cached_len}, tokens "
                 f"{req_s.output} (pod-0's {want_f})")
        if plain.calls:
            fail(f"disagg pods: {plain.calls} plain attention calls")
        wall_s = time.perf_counter() - t_phase
        shedder = pod_d.shedder.stats()
        print(f"pod-d shedder over the phase: {shedder}; H greedy agreement with pod-0 "
              f"cold {agree_h}/16; phase 12 wall time {wall_s:.1f} s", flush=True)
        return dict(
            ttft_handoff_ms=ttft_h_ms, prefill_chunk_host_ms=chunk_ms,
            pulls_h_blocks=pulls_h, residency=residency,
            decode_step_ms_rows_alone=rows_alone_ms, decode_step_ms_pull_in_flight=pull_steps_ms,
            decode_step_ms_no_pull=idle_steps_ms, rows_decoding_at_first_token=rows_at_first_token,
            pod_d_steps_h=steps, launches={"H": launches_h, "F": launches_f, "skip": launches_s},
            ttft_fallback_ms=ttft_f_ms, pulls_f_blocks=pulls_f, ttft_deadline_skip_ms=ttft_skip_ms,
            greedy_agreement_h_vs_pod0_cold=agree_h, shedder_pod_d=shedder,
            coordinator=coord.debug(), wall_s=wall_s)
    finally:
        plain.stop()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 13: the model families' attention layouts at public widths
# ---------------------------------------------------------------------------

FAMILY_Q_HEADS = 32  # Mistral-7B's and Qwen3-8B's query heads: GQA group 4 over 8 kv heads
MISTRAL_WINDOW, HYBRID_WINDOW, SINKS = 4096, 1024, 4


def mistral_model(**layout):
    """Mistral-7B-v0.1, by hand from its public config.json: vocab 32000,
    hidden 4096, 32 layers, 32 heads over 8 kv heads of 128, intermediate
    14336, rope_theta 1e4, rms eps 1e-5, ``sliding_window`` 4096 on every
    layer; page 16, bf16 (~7.24B params). ``layout`` replaces the window
    fields (the sink and hybrid variants)."""
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig

    layout = layout or dict(sliding_window=MISTRAL_WINDOW, swa_layers=tuple(range(32)))
    return LlamaConfig(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, intermediate_size=14336,
                       rope_theta=1e4, norm_eps=1e-5, page_size=16, **layout)


def qwen3_model():
    """Qwen3-8B, by hand from its public config.json: vocab 151936, hidden
    4096, 36 layers, 32 heads over 8 kv heads of 128, intermediate 12288,
    rope_theta 1e6, rms eps 1e-6, QK-norm, no window (``use_sliding_window``
    false), untied lm_head; page 16, bf16 (~8.19B params)."""
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=151936, hidden_size=4096, num_layers=36, num_heads=32,
                       num_kv_heads=8, head_dim=128, intermediate_size=12288,
                       rope_theta=1e6, norm_eps=1e-6, page_size=16, qk_norm=True)


def hybrid_model():
    """The hybrid stand-in: Mistral-7B-v0.1's widths (and weights) with
    Gemma 3's layout, every sixth layer global (5, 11, 17, 23, 29) and the
    other 27 sliding at window 1024."""
    return mistral_model(sliding_window=HYBRID_WINDOW,
                         swa_layers=tuple(i for i in range(32) if i % 6 != 5))


def hybrid_swa_pages(model, max_batch=8, chunk=2048, burst=TAIL_SLOTS) -> int:
    """``num_swa_pages`` by the JAX engine's rule: a row's peak SWA demand is
    its window + max(prefill chunk, burst) + the decode page, for every row
    of a batch (+ the garbage page)."""
    page = model.page_size
    per_row = -(-model.sliding_window // page) + -(-max(chunk, burst) // page) + 1
    return max_batch * per_row + 1


def param_count(params) -> int:
    return sum(t.numel() for t in (params["embed"], params["lm_head"])) + sum(
        t.numel() for layer in params["layers"] for t in layer.values())


def release_memory(torch, *trees) -> None:
    """Drop the engines, weights and tensors the earlier phases' results
    still hold (dicts and lists, a few levels deep, and the fleet's
    ``add_pod``, whose defaults hold the GQA weights), then return the
    freed blocks to the card."""
    import gc

    from llmd_kv_cache_tpu_torch.models.engine import MiniEngine

    def heavy(x):
        return (isinstance(x, (MiniEngine, torch.Tensor)) or callable(x)
                or (isinstance(x, dict) and "layers" in x and "embed" in x))

    def walk(node, depth):
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, list) else ())
        for key, value in list(items):
            if heavy(value):
                node[key] = None
            elif depth < 4:
                walk(value, depth + 1)

    for tree in trees:
        walk(tree, 0)
    gc.collect()
    torch.cuda.empty_cache()


def family_fleet(torch) -> dict:
    """Phase 13's fleet: one Indexer with window-aware scoring (the
    ``HybridAware`` strategy, the Pool's GroupCatalog attached) that every
    phase-13 pod feeds through ``Pool.process_event_batch``."""
    from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
    from llmd_kv_cache_tpu_torch.events.model import EventBatch
    from llmd_kv_cache_tpu_torch.events.pool import Pool
    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig
    from llmd_kv_cache_tpu_torch.scoring.scorer import HYBRID_AWARE, KVBlockScorerConfig

    indexer = Indexer(IndexerConfig(
        token_processor_config=TokenProcessorConfig(block_size_tokens=16),
        scorer_config=KVBlockScorerConfig(scoring_strategy=HYBRID_AWARE)))
    pool = Pool(indexer.kv_block_index, indexer.token_processor)
    indexer.attach_group_catalog(pool.group_catalog)
    events: dict[str, list] = {}
    engines: dict = {}

    def add_pod(pod, pod_model=None, pod_params=None, pod_model_name=None,
                offload_spec=None, num_pages=1024, **cfg_kw):
        events[pod] = []

        def sink(evs):
            events[pod].extend(evs)
            pool.process_event_batch(EventBatch(timestamp=time.time(), events=evs),
                                     pod, pod_model_name)

        if pod_model.is_hybrid:
            cfg_kw.setdefault("num_swa_pages", hybrid_swa_pages(pod_model))
        engines[pod] = MiniEngine(
            EngineConfig(model=pod_model, num_pages=num_pages, max_pages_per_seq=272,
                         max_prefill_tokens=2048, model_name=pod_model_name,
                         pod_identifier=pod, **cfg_kw),
            event_sink=sink, params=pod_params, device="cuda", offload_spec=offload_spec)
        return engines[pod]

    rng = torch.Generator().manual_seed(13)

    def tokens(n):
        return torch.randint(1, 32000, (n,), generator=rng).tolist()

    return dict(indexer=indexer, pool=pool, events=events, engines=engines,
                add_pod=add_pod, tokens=tokens)


def expected_specs(model) -> set:
    """(group, spec kind, window) of the blocks a pod of ``model`` stores."""
    if model.is_mla:
        return {(0, "mla_attention", None)}
    if model.is_hybrid:
        return {(0, "full_attention", None), (1, "sliding_window", model.sliding_window)}
    if model.sliding_window is not None:
        kind = "sink_full_attention" if model.attention_sinks else "sliding_window"
        return {(0, kind, model.sliding_window)}
    return {(0, "full_attention", None)}


def serve_traffic(pod, warmup, cold, warm, batch_prompts, between=None):
    """A phase-13 pod's traffic, on the card and on a CPU twin alike: a
    warm-up, the cold prompt and the routed one through ``add_request``,
    then the 8 batch prompts enqueued and decoded to 16 tokens.
    ``between(stage, value)`` is called at each stage (the card run times
    and scores there). Returns the requests."""
    between = between or (lambda stage, value=None: None)
    pod.generate("warm-up", warmup, max_new_tokens=2)
    between("counted")
    req_a = pod.add_request("A", cold, max_new_tokens=1)
    between("cold", req_a)
    req_b = pod.add_request("B", warm, max_new_tokens=1)
    between("warm", req_b)
    batch = [pod.enqueue(f"D{i}", p, max_new_tokens=16) for i, p in enumerate(batch_prompts)]
    while any(not r.done for r in batch):
        between("step", batch)
        pod.step()
        between("stepped", batch)
    return req_a, req_b, batch


def family_pod(torch, ops, ff, pod_name, model, params, model_name, **cfg_kw) -> dict:
    """A phase-13 pod serving the bench traffic: a warm-up (first launches;
    a burst pod's graph capture), then, every counter zeroed just before
    and read just after, a cold 4160-token prompt (2048 + 2048 + 64), a
    prompt scored and routed to the pod, and 8 prompts decoded to 16
    tokens at batch 8. A pod without a hybrid layout resumes the routed and
    batch prompts at the cold prompt's 4096-token prefix; a hybrid pod
    resumes only where a committed SWA window ends, so its routed and
    batch prompts continue the cold prompt (a chat's next turn, 4160
    cached + 64). Held: the pod ranks first with the window-aware score
    (``routed``: the blocks it can resume, capped at a sliding window),
    ``cached_len``, launches = layers x dispatches of the decode (or burst
    ticks) and prefill kernels and no other, no plain call, each group's
    stored - removed blocks = its manager's cached ones, and the spec of
    every stored block, and the engine's layout: fused (``w_qkv``, a
    dense MLP's ``w_gate_up``) under the default gate iff
    ``fuse_profitable`` holds (hidden 4096: Mistral, Qwen3, Mixtral), its
    leaves and the tree's marker printed."""
    from llmd_kv_cache_tpu_torch.events.model import BlockRemovedEvent, BlockStoredEvent
    from llmd_kv_cache_tpu_torch.models.llama import fuse_profitable

    pod = ff["add_pod"](pod_name, pod_model=model, pod_params=params,
                        pod_model_name=model_name, **cfg_kw)
    leaves = sorted(pod.params["layers"][-1])
    fused = "w_qkv" in leaves or "w_mla_in" in leaves
    print(f"{pod_name}: {'fused' if fused else 'unfused'} tree, the last layer's leaves "
          f"{leaves}, fused_interleave marker {pod.params.get('fused_interleave')}",
          flush=True)
    if "fuse_projections" not in cfg_kw and fused != fuse_profitable(model):
        fail(f"{pod_name}: the default gate left the tree {'fused' if fused else 'unfused'} "
             f"at hidden {model.hidden_size}")
    chunks = record_calls(pod, "_prefill_chunk")
    steps = record_calls(pod, "_decode_chunk")
    bursts = record_calls(pod, "_decode_chunk_burst")
    tokens, indexer = ff["tokens"], ff["indexer"]
    prefix = tokens(4096)
    cold = prefix + tokens(64)
    if model.is_hybrid:
        warm, cached = cold + tokens(64), 4160
        batch_prompts = [cold + tokens(64) for _ in range(8)]
        routed = float(-(-model.sliding_window // model.page_size))
    else:
        warm, cached = prefix + tokens(64), 4096
        batch_prompts = [prefix + tokens(64) for _ in range(8)]
        routed = 256.0  # the prefix; a 4096-token window caps nothing more
    t_ms, step_ms, plain, seen = {}, [], [None], {}

    def between(stage, value=None):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if stage == "counted":
            plain[0] = PlainCalls()
            zero_launches(ops)
            for cell in (chunks, steps, bursts):
                cell.clear()
        elif stage in ("cold", "warm"):
            t_ms[stage] = (now - seen["t"]) * 1e3
            if stage == "cold":
                scores = indexer.score_tokens(warm, model_name)
                ranked = sorted(scores, key=lambda p: (-scores[p], p))
                print(f"score_tokens({pod_name} routed prompt): {scores}", flush=True)
                if not ranked or ranked[0] != pod_name or scores[pod_name] != routed:
                    fail(f"routing: expected {pod_name} first with {routed}, got {scores}")
                seen["scores"] = scores
        elif stage == "step":
            seen["b8"] = (sum(1 for r in value if r.prefill_pos is None and r.output
                              and not r.done) == 8
                          and not any(r.prefill_pos is not None for r in value))
        elif stage == "stepped" and seen["b8"]:
            step_ms.append((now - seen["t"]) * 1e3)
        seen["t"] = time.perf_counter()

    traffic = (tokens(2048 + 64), cold, warm, batch_prompts)
    req_a, req_b, batch = serve_traffic(pod, *traffic, between)
    torch.cuda.synchronize()
    launches = read_launches(ops)
    plain[0].stop()
    n_chunks, n_steps, n_bursts = len(chunks), len(steps), len(bursts)
    free_after = [pod.block_manager.num_free()] + (
        [pod.swa_manager.num_free()] if pod.hybrid else [])

    layers, burst = model.num_layers, pod._burst
    print(f"{pod_name}: {n_chunks} prefill chunks, {n_steps} decode steps, {n_bursts} "
          f"bursts of {burst}, kernel launches {launches}", flush=True)
    want_decode = layers * (n_steps if burst == 1 else burst * n_bursts)
    dec, pre = (("cuda_paged_latent_decode_attention", "cuda_paged_latent_prefill_attention")
                if model.is_mla else
                ("cuda_paged_decode_attention", "cuda_paged_prefill_attention"))
    others = {k: n for k, n in launches.items() if k not in (dec, pre)}
    if (launches[dec] != want_decode or not want_decode or launches[pre] != layers * n_chunks
            or not n_chunks or any(others.values()) or (burst > 1 and n_steps)):
        fail(f"{pod_name}: launches {launches} for {n_chunks} chunks, {n_steps} steps and "
             f"{n_bursts} bursts x {layers} layers")
    if plain[0].calls:
        fail(f"{pod_name} ran the plain attention {plain[0].calls} times")
    if req_b.cached_len != cached or any(r.cached_len != cached for r in batch):
        fail(f"{pod_name}: cached_len {req_b.cached_len}, "
             f"{[r.cached_len for r in batch]}, expected {cached}")
    for req in (req_a, req_b, *batch):
        if len(req.output) != req.max_new_tokens or not all(
                0 <= x < model.vocab_size for x in req.output):
            fail(f"{pod_name} request {req.request_id}: bad output {req.output}")
    if not step_ms and burst == 1:
        fail(f"{pod_name}: no decode step ran at batch 8")
    evs = ff["events"][pod_name]
    specs = {(e.group_idx, e.kv_cache_spec_kind, e.kv_cache_spec_sliding_window)
             for e in evs if isinstance(e, BlockStoredEvent)}
    managers = [pod.block_manager] + ([pod.swa_manager] if pod.hybrid else [])
    for g, mgr in enumerate(managers):
        stored = sum(len(e.block_hashes) for e in evs
                     if isinstance(e, BlockStoredEvent) and e.group_idx == g)
        removed = sum(len(e.block_hashes) for e in evs
                      if isinstance(e, BlockRemovedEvent) and e.group_idx == g)
        print(f"{pod_name} group {g}: {stored} blocks stored, {removed} removed, "
              f"{mgr.num_cached_blocks()} cached, {mgr.num_free()} of {mgr.num_pages} "
              f"pages free", flush=True)
        if stored - removed != mgr.num_cached_blocks():
            fail(f"{pod_name} group {g}: stored - removed != cached")
    catalog = {(g, m.kind, m.sliding_window_size)
               for g, m in ff["pool"].group_catalog.groups(pod_name).items()}
    print(f"{pod_name}: stored block specs {sorted(specs, key=str)}, catalog "
          f"{sorted(catalog, key=str)}", flush=True)
    if specs != expected_specs(model) or catalog != specs:
        fail(f"{pod_name}: specs {specs}, catalog {catalog}, expected {expected_specs(model)}")
    if burst > 1:
        # A burst pod's rows finish before the last one is prefilled: its
        # decode is timed as phase 8 times it, 2 bursts of 8 rows after the
        # counted run, per generated token, every row live through them
        # (phase 8's budget of 128 tokens a row, less what a longer prompt
        # leaves of the page table: a hybrid pod's 4224-token prompts).
        timed = [p[:-64] + tokens(64) for p in batch_prompts]
        room = PAGES_PER_SEQ * model.page_size - max(map(len, timed)) - model.page_size
        run = decode_token_ms(torch, pod, timed, timed_steps=2,
                              max_new_tokens=min(128, room))
        if run["tokens"] != 2 * burst * len(timed):
            fail(f"{pod_name}: {run['tokens']} tokens in 2 timed bursts of {burst}: a row "
                 "finished before them")
        per_token = run["ms_per_token"]
    else:
        per_token = sum(step_ms) / len(step_ms) / 8
    out = dict(pod=pod, fused=fused, leaves=leaves, ttft_cold_ms=t_ms["cold"],
               ttft_warm_ms=t_ms["warm"],
               decode_ms_per_step_b8=sum(step_ms) / len(step_ms) if step_ms else None,
               decode_step_ms_b8=step_ms, host_ms_per_token_b8=per_token,
               routed=seen["scores"], launches={dec: launches[dec], pre: launches[pre]},
               prefill_chunks=n_chunks, decode_steps=n_steps, bursts=n_bursts,
               free_pages_after=free_after, prefix=prefix, cold=cold,
               batch_prompts=batch_prompts, batch_outputs=[r.output for r in batch],
               traffic=traffic)
    print(f"{pod_name}: TTFT cold {out['ttft_cold_ms']:.3f} ms, warm (routed, cached "
          f"{cached}) {out['ttft_warm_ms']:.3f} ms, "
          + (f"decode step at batch 8 {out['decode_ms_per_step_b8']:.3f} ms ({len(step_ms)} "
             "steps), " if step_ms else "")
          + f"host ms per generated token at batch 8 {per_token:.4f}", flush=True)
    return out


def hybrid_twin(torch, model, pod, traffic) -> list:
    """The free pages of both managers after the CPU twin of a hybrid pod
    serves the same traffic: a narrow model with the same layout, window
    and page (paging depends on neither widths nor weights, and prompt
    blocks only), the pod's EngineConfig, on the CPU."""
    import dataclasses

    from llmd_kv_cache_tpu_torch.models.engine import MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import init_params

    narrow = dataclasses.replace(model, hidden_size=64, num_heads=4, num_kv_heads=2,
                                 head_dim=16, intermediate_size=128, dtype=torch.float32,
                                 num_layers=6, swa_layers=tuple(
                                     i for i in range(6) if i in model.swa_layers))
    twin = MiniEngine(dataclasses.replace(pod.cfg, model=narrow), device="cpu",
                      params=init_params(narrow, seed=0, device="cpu"))
    serve_traffic(twin, *traffic)
    return [twin.block_manager.num_free(), twin.swa_manager.num_free()]


# The held logits criterion of phase 13: at 32-36 random layers both bf16
# paths (the kernels and the plain attention) sit ~5% of max|logit| from
# the fp32 forward and as far from each other (ROADMAP C.5), so a fixed
# tolerance between them holds bf16 noise. A wrong kernel moves its own
# distance from fp32: its rms distance over a chunk's logits may not exceed
# the plain attention's by more than this factor. (The max distances of a
# 2048-token chunk read 1.009 and 0.976 of the plain attention's; the rms
# over every logit is held because a max over a 64-token chunk's positions
# varies more.)
FP32_DISTANCE_RATIO = 1.1


class Fp32Layers:
    """A tree's layers upcast to fp32 one at a time, as a forward iterates
    them: a model whose fp32 copy would not fit beside its bf16 tree (each
    forward upcasts every layer again)."""

    def __init__(self, layers):
        self.layers = layers

    def __iter__(self):
        for layer in self.layers:
            yield {k: t.float() for k, t in layer.items()}


def family_logits(torch, model, params, tokens, layerwise_fp32=False,
                  held=("chunk2048_over2048", "chunk64_over4096")) -> dict:
    """The cold prompt's second 2048-token chunk (over 2048 cached keys)
    and its 64-token tail (over 4096: 4160 keys, past a 4096 or 1024
    window), every position's logits, through the kernels and through the
    plain attention (bf16, each over its own cache), each against the same
    forward in fp32 (weights upcast, plain attention, its own cache): rms
    |diff| / rms logit, and max |diff| / max|logit|. Held on each chunk:
    the kernels' rms distance from fp32 is at most FP32_DISTANCE_RATIO x
    the plain attention's (on the chunks named in ``held``; the others'
    distances are printed).
    For a model with a window, also the 64-token chunk through the kernels
    against the same weights with no window over their own cache: they must
    differ by more than LOGITS_REL_TOL of max|logit| (the window is
    engaged). A hybrid model runs over its two pools. ``layerwise_fp32``:
    the fp32 forward upcasts one layer at a time (``Fp32Layers``), for a
    model whose whole fp32 copy does not fit beside its tree."""
    import dataclasses

    from llmd_kv_cache_tpu_torch.models.llama import (
        forward,
        forward_hybrid,
        init_kv_cache,
        init_kv_cache_hybrid,
    )

    n_pages = 4160 // model.page_size + 1
    table = torch.arange(1, n_pages, dtype=torch.int32, device="cuda")[None]
    table = torch.cat([table, table.new_zeros((1, PAGES_PER_SEQ - n_pages + 1))], 1)
    toks = torch.tensor([tokens[:4160]], dtype=torch.int64, device="cuda")
    chunks = {"chunk2048_over2048": (2048, 4096), "chunk64_over4096": (4096, 4160)}

    def run(cfg, prm, plain):
        """Every chunk's logits of the cold prompt after its first chunk."""
        pools = (init_kv_cache_hybrid(cfg, n_pages, n_pages, device="cuda") if cfg.is_hybrid
                 else init_kv_cache(cfg, n_pages, device="cuda"))
        out = {}
        for name, (lo, hi) in {"first": (0, 2048), **chunks}.items():
            ctx = torch.tensor([lo], dtype=torch.int32, device="cuda")
            new = torch.tensor([hi - lo], dtype=torch.int32, device="cuda")
            if cfg.is_hybrid:
                logits = forward_hybrid(prm, cfg, toks[:, lo:hi], *pools, table, table, ctx,
                                        new, last_only=not lo, plain_attention=plain)[0]
            else:
                logits = forward(prm, cfg, toks[:, lo:hi], *pools, table, ctx, new,
                                 last_only=not lo, plain_attention=plain)[0]
            if lo:
                if logits.shape != (1, hi - lo, cfg.vocab_size) or not torch.isfinite(
                        logits).all():
                    fail(f"family logits: shape {tuple(logits.shape)} or non-finite values")
                out[name] = logits[0].float()
        return out

    model32, params32 = fp32_copy(torch, model, dict(params, layers=[]) if layerwise_fp32
                                  else params)
    if layerwise_fp32:
        params32["layers"] = Fp32Layers(params["layers"])
    exact = run(model32, params32, True)
    del params32
    torch.cuda.empty_cache()
    got, plain = run(model, params, False), run(model, params, True)
    out, wrong = {}, []
    def rms(x):
        return float(x.pow(2).mean().sqrt())

    for name, x in exact.items():
        scale, rms_scale = float(x.abs().max()), rms(x)
        res = out[name] = {
            "kernels_vs_fp32_rms": rms(got[name] - x) / rms_scale,
            "plain_vs_fp32_rms": rms(plain[name] - x) / rms_scale,
            "kernels_vs_fp32": float((got[name] - x).abs().max()) / scale,
            "plain_vs_fp32": float((plain[name] - x).abs().max()) / scale,
            "kernels_vs_plain": float((got[name] - plain[name]).abs().max())
            / float(plain[name].abs().max())}
        print(f"{name} logits ({model.num_layers} layers, every position) against the fp32 "
              f"forward, rms |diff| / rms logit: kernels {res['kernels_vs_fp32_rms']:.4f}, "
              f"plain attention {res['plain_vs_fp32_rms']:.4f} ("
              + (f"held: kernels <= {FP32_DISTANCE_RATIO} x plain" if name in held
                 else "printed, not held") + "); max |diff| / max|logit|: kernels "
              f"{res['kernels_vs_fp32']:.4f}, plain attention {res['plain_vs_fp32']:.4f}; "
              f"kernels against plain attention {res['kernels_vs_plain']:.4f}", flush=True)
        if name in held and not (res["kernels_vs_fp32_rms"]
                                 <= FP32_DISTANCE_RATIO * res["plain_vs_fp32_rms"]):
            wrong.append(f"{name}: the kernels' logits sit further from the fp32 forward "
                         f"than {FP32_DISTANCE_RATIO} x the plain attention's")
    del exact
    if model.sliding_window is not None:
        free = dataclasses.replace(model, sliding_window=None, swa_layers=(),
                                   attention_sinks=0)
        last = got["chunk64_over4096"]
        unwindowed = run(free, params, False)["chunk64_over4096"]
        out["vs_no_window"] = float((last - unwindowed).abs().max()) / float(last.abs().max())
        print(f"chunk64_over4096 logits through the kernels against the same weights with no "
              f"window: {out['vs_no_window']:.4f} of max|logit| (held: above "
              f"{LOGITS_REL_TOL})", flush=True)
        if not out["vs_no_window"] > LOGITS_REL_TOL:
            wrong.append("the window is not engaged: the logits are those of no window")
    if wrong:
        fail("; ".join(wrong))
    return out


def hybrid_offload(torch, ops, ff, model, params, model_name) -> dict:
    """``pod-ho`` writes a cold 4160-token prompt C through both groups of a
    hybrid store (a temporary posix directory, removed at the end): 260
    group-0 files and the 64 group-1 files of the window at commit. A fresh
    ``pod-ho2`` takes C + 64 tokens through ``add_request`` and restores
    all or nothing: 260 blocks, ``cached_len`` 4160, group 1 only the
    window; counters zeroed just before and read just after (one prefill
    chunk, no plain call); its pages bit-equal ``pod-ho``'s in both groups,
    its 16 tokens those ``pod-ho`` computes for the same prompt from its
    own cache (4160 cached, the 64 new tokens in one chunk: pod-ho2's
    write-through of them removed from the store first)."""
    root = tempfile.mkdtemp(prefix="chip-smoke-hybrid-")
    pods = []
    try:
        spec = offload_spec_for(model, root, model_name)
        tokens = ff["tokens"]
        writer = ff["add_pod"]("pod-ho", pod_model=model, pod_params=params,
                               pod_model_name=model_name, offload_spec=spec)
        pods.append(writer)
        writer.generate("HW", tokens(2048 + 64), max_new_tokens=2)
        cold = tokens(4096) + tokens(64)
        t = time.perf_counter()
        req_w = writer.add_request("HA", cold, max_new_tokens=1)
        torch.cuda.synchronize()
        ttft_cold_ms = (time.perf_counter() - t) * 1e3
        writer.flush_offload()
        mapper = writer.offload_handlers.mapper
        wb = -(-model.sliding_window // model.page_size)
        window = req_w.block_hashes[OFFLOAD_BLOCKS - wb:OFFLOAD_BLOCKS]
        deadline = time.monotonic() + 60.0  # group 1's jobs are not flushed
        while not all(os.path.exists(mapper.block_path(h, 1)) for h in window):
            writer.poll_offload()
            if time.monotonic() > deadline:
                fail("pod-ho: the group-1 window files did not land")
            time.sleep(0.01)
        files = {g: sum(os.path.exists(mapper.block_path(h, g)) for h in req_w.block_hashes)
                 for g in (0, 1)}
        print(f"pod-ho: cold TTFT {ttft_cold_ms:.3f} ms, block files by group {files}",
              flush=True)
        if files != {0: OFFLOAD_BLOCKS, 1: wb}:
            fail(f"pod-ho: block files by group {files}, expected 260 and {wb}")

        reader = ff["add_pod"]("pod-ho2", pod_model=model, pod_params=params,
                               pod_model_name=model_name, offload_spec=spec)
        pods.append(reader)
        cont = cold + tokens(64)
        chunks = record_calls(reader, "_prefill_chunk")
        steps = record_calls(reader, "_decode_chunk")
        plain = PlainCalls()
        zero_launches(ops)
        t = time.perf_counter()
        req_r = reader.add_request("HB", cont, max_new_tokens=16)
        torch.cuda.synchronize()
        ttft_restored_ms = (time.perf_counter() - t) * 1e3
        while not req_r.done:
            reader.step()
        torch.cuda.synchronize()
        launches = read_launches(ops)
        plain.stop()
        layers = model.num_layers
        print(f"pod-ho2: restored {req_r.restored_blocks} blocks, cached_len "
              f"{req_r.cached_len}, TTFT {ttft_restored_ms:.3f} ms, {len(chunks)} prefill "
              f"chunk(s), launches {launches}", flush=True)
        if (req_r.restored_blocks, req_r.cached_len) != (OFFLOAD_BLOCKS, 4160):
            fail("pod-ho2: the hybrid restore was not all of the chain and its window")
        if (len(chunks) != 1 or launches["cuda_paged_prefill_attention"] != layers
                or launches["cuda_paged_decode_attention"] != layers * len(steps)
                or plain.calls):
            fail(f"pod-ho2: launches {launches}, {plain.calls} plain calls")
        held = reader.swa_manager.blocks
        if (not all(h in held for h in window)
                or any(h in held for h in req_w.block_hashes[:OFFLOAD_BLOCKS - wb])):
            fail("pod-ho2: group 1 holds other blocks of the chain than the window")
        for g, (pw, pr), hashes in (
                (0, (writer.block_manager, reader.block_manager), req_w.block_hashes),
                (1, (writer.swa_manager, reader.swa_manager), window)):
            pools_w = (writer.k_cache, writer.v_cache) if g == 0 else (writer.k_swa, writer.v_swa)
            pools_r = (reader.k_cache, reader.v_cache) if g == 0 else (reader.k_swa, reader.v_swa)
            ids_w = torch.tensor([pw.blocks[h].page for h in hashes], device="cuda")
            ids_r = torch.tensor([pr.blocks[h].page for h in hashes], device="cuda")
            for a, b in zip(pools_w, pools_r):
                if not torch.equal(a.index_select(1, ids_w), b.index_select(1, ids_r)):
                    fail(f"pod-ho2: restored group-{g} pages differ from pod-ho's")
        # pod-ho computes the same continuation from its own cache. pod-ho2
        # wrote its 4 new blocks through to the store: they are removed
        # first, or pod-ho would restore them and compute the last token
        # alone (another chunking, other bf16 roundings, near-ties flipped).
        new_blocks = req_r.block_hashes[OFFLOAD_BLOCKS:]
        reader.flush_offload()
        deadline = time.monotonic() + 60.0
        while not all(os.path.exists(mapper.block_path(h, g)) for h in new_blocks
                      for g in (0, 1)):
            reader.poll_offload()
            if time.monotonic() > deadline:
                fail("pod-ho2: its new blocks' files did not land")
            time.sleep(0.01)
        for h in new_blocks:
            for g in (0, 1):
                os.remove(mapper.block_path(h, g))
        req_c = writer.add_request("HC", cont, max_new_tokens=16)
        while not req_c.done:
            writer.step()
        want = req_c.output
        if (req_c.cached_len, req_c.restored_blocks) != (4160, 0):
            fail(f"pod-ho: the reference continuation cached {req_c.cached_len} and restored "
                 f"{req_c.restored_blocks} blocks, not 4160 from its own pool")
        if req_r.output != want:
            fail(f"pod-ho2: tokens {req_r.output} differ from pod-ho's {want}")
        print(f"pod-ho2: pages bit-equal pod-ho's in both groups ({OFFLOAD_BLOCKS} + {wb}), "
              f"16 tokens pod-ho's", flush=True)
        return dict(store=fs_type(os.path.realpath(root)), files=files,
                    ttft_cold_ms=ttft_cold_ms, ttft_restored_ms=ttft_restored_ms,
                    restored_blocks=req_r.restored_blocks, launches=launches)
    finally:
        for pod in pods:
            pod.offload_handlers.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def sdpa_masked_yardstick(torch, name, q, k, v, want, mask) -> float:
    """Device ms of one scaled_dot_product_attention call with a boolean
    mask (the memory-efficient backend; the kv heads repeated to the query
    heads): an informational yardstick over contiguous keys, as
    ``sdpa_yardstick``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    got = call().transpose(1, 2)
    torch.cuda.synchronize()
    ms = device_ms(call)
    diff = float((got.reshape(want.shape).float() - want.float()).abs().max())
    print(f"{name}: scaled_dot_product_attention (memory-efficient, boolean mask, "
          f"contiguous, not paged) {ms:.4f} ms on the device; max |sdpa - kernel| "
          f"{diff:.3e}", flush=True)
    return ms


def g4_times(torch, ops, gen) -> dict:
    """The GQA decode (8 rows over 4160 keys) and prefill (S 2048 over ctx
    2048) at group 4, 32 query heads over the 8 kv heads of 128 (Mistral-7B's
    and Qwen3-8B's), unwindowed and at windows 4096 and 1024."""
    out = {}
    for window in (None, MISTRAL_WINDOW, HYBRID_WINDOW):
        tag = f"swa{window}" if window else "full"
        out[f"decode g4 b8 ctx4160 {tag}"] = {
            k: v for k, v in decode_timing(torch, ops, gen, 0, q_heads=FAMILY_Q_HEADS,
                                           window=window).items() if k != "by_kernel"}
        out[f"prefill g4 s2048 ctx2048 {tag}"] = prefill_timing(
            torch, ops, gen, q_heads=FAMILY_Q_HEADS, window=window)
    return out


def g4_parity(torch, ops, gen) -> dict:
    """The kernel instantiations phase 13 puts on the engine path at group
    4 (32 query heads over 8 kv heads of 128), each against its plain
    version at the pods' windows (none; 4096 with 4 sinks, ``pod-ws``'s,
    which also covers ``pod-w``'s 4096; 1024, the hybrid pods'): the decode
    over decode_parity's contexts with a padded row; its tail arm over
    TAIL_CASES and over 8 rows of 4160 keys with an 8-token tail (the burst
    pods' ticks); the prefill at the cold prompt's chunks (2048 at ctx 0
    and 2048, 64 at ctx 4096, and 50 valid of 64); the ragged kernel at
    ``pod-wr``'s window 4096 over ragged_parity's serving and straddling
    mixes and RAGGED_TIMED's dispatches. Returns each kernel's largest
    error."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_ragged_attention,
    )

    def windowed(name, window, sinks):
        return name + (f" swa{window}" if window else "") + (f"+sinks{sinks}" if sinks else "")

    pod_windows = ((None, None), (MISTRAL_WINDOW, SINKS), (HYBRID_WINDOW, None))
    err = dict(decode=0.0, decode_tail=0.0, prefill=0.0, ragged=0.0)
    decode = ops.cuda_paged_decode_attention
    cases = [(windowed("", w, s), [1, 17, 300, 1024, 2049, 4100, 4160, 0], None, w, s)
             for w, s in pod_windows]
    cases += TAIL_CASES  # their names carry their windows
    cases += [(windowed("b8 ctx4160 t8", w, s), [4160] * 8, [TAIL_SLOTS] * 8, w, s)
              for w, s in pod_windows]
    for name, lens, tails, window, sinks in cases:
        k, v, table, ctx, tk, tv, tl = tail_case(torch, gen, lens, tails or [0] * len(lens),
                                                 KV_HEADS, HEAD_DIM)
        q = torch.randn(len(lens), FAMILY_Q_HEADS, HEAD_DIM, generator=gen,
                        device="cuda").to(torch.bfloat16)
        tail = (tk, tv, tl) if tails else (None, None, None)
        out = decode(q, k, v, table, ctx, sliding_window=window, sinks=sinks,
                     **(dict(tail_k=tk, tail_v=tv, tail_lens=tl) if tails else {}))
        torch.cuda.synchronize()
        live = (ctx + (tl if tails else 0)) > 0
        label = " ".join(f"decode g4 {name}".split())
        if not bool((out[~live] == 0).all()):
            fail(f"{label}: a padded row did not return zeros")
        arm = "decode_tail" if tails else "decode"
        err[arm] = max(err[arm], check_close(label, out[live], plain_tail(
            q, k, v, table, ctx, *tail, window, sinks)[live]))

    k, v = random_pool(torch, gen, 273)
    table = page_table_for(torch, gen, [4160], 273)
    for ctx_len, seq, new in ((0, 2048, 2048), (2048, 2048, 2048), (4096, 64, 64),
                              (4096, 64, 50)):
        q = torch.randn(1, seq, FAMILY_Q_HEADS, HEAD_DIM, generator=gen,
                        device="cuda").to(torch.bfloat16)
        ctx = torch.tensor([ctx_len], dtype=torch.int32, device="cuda")
        positions = ctx[:, None] + torch.arange(seq, device="cuda")[None]
        for window, sinks in pod_windows:
            out = ops.cuda_paged_prefill_attention(q, k, v, table, ctx, ctx + new,
                                                   sliding_window=window, sinks=sinks)
            ref = paged_attention(q, k, v, table, positions, ctx + new, sliding_window=window,
                                  attention_sinks=sinks)
            err["prefill"] = max(err["prefill"], check_close(
                windowed(f"prefill g4 ctx{ctx_len} s{seq} new{new}", window, sinks),
                out[0], ref[0]))

    mixes = {"serving": ([1] * 8 + [2048, 64],
                         [16, 300, 1023, 2048, 3001, 3500, 4100, 4159, 2048, 4096], 0),
             "straddle": ([1, 7, 0, 33, 100, 1], [500, 0, 10, 1000, 77, 4000], 3),
             **{name: (*lens, 0) for name, lens in RAGGED_TIMED.items()}}
    for name, (q_lens, ctx_l, pad) in mixes.items():
        q, k, v, table, starts, ctx = ragged_inputs(torch, gen, q_lens, ctx_l, pad,
                                                    q_heads=FAMILY_Q_HEADS)
        args = (q, k, v, table, starts, ctx)
        err["ragged"] = max(err["ragged"], check_ragged(
            torch, f"ragged g4 {name} swa{MISTRAL_WINDOW}",
            ops.cuda_paged_ragged_attention(*args, sliding_window=MISTRAL_WINDOW),
            paged_ragged_attention(*args, sliding_window=MISTRAL_WINDOW), q_lens))
    return err


def families_path(torch, ops, gen) -> dict:
    """Phase 13: the GQA kernels at group 4 against their plain versions
    at the pods' windows (``g4_parity``) and timed (``g4_times``), then
    Mistral-7B-v0.1 (``pod-w`` padded, ``pod-wr`` ragged, ``pod-ws`` with 4
    sinks and bursts of 8), the hybrid stand-in (``pod-h``, ``pod-hb`` with
    bursts, ``pod-ho`` -> ``pod-ho2`` through a store) and Qwen3-8B
    (``pod-q``), at full width with random weights from a seed, on one
    window-aware Indexer; each pod freed after its checks, each model
    after its pods and its logits checks."""
    import gc

    from llmd_kv_cache_tpu_torch.models.llama import init_params, maybe_fuse_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, pods = {"g4_parity": g4_parity(torch, ops, gen), "g4": g4_times(torch, ops, gen),
                 "models": {}}, {}
    ff = family_fleet(torch)

    def weights(model, seed, label):
        """The model's tree from the seed, fused once where the default gate
        fuses (hidden 4096): the pods adopt it, no copy each."""
        t = time.perf_counter()
        params = maybe_fuse_params(init_params(model, seed=seed, device="cuda"), model)
        torch.cuda.synchronize()
        n = param_count(params)
        out["models"][label] = dict(params=n, init_s=time.perf_counter() - t)
        print(f"{label}: {n / 1e9:.3f}B params (bf16, seed {seed}), init "
              f"{out['models'][label]['init_s']:.1f} s, fused_interleave marker "
              f"{params.get('fused_interleave')}", flush=True)
        return params

    def done(*names):
        for name in names:
            pods[name].pop("pod", None)
            ff["engines"][name] = None
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()

    # The logits checks run after each model's pods, and a failed one fails
    # the phase at its end: every check of the phase runs and prints first.
    failed = []

    def held(label, fn, *args):
        try:
            return fn(*args)
        except SystemExit as exc:
            failed.append(f"{label}: {exc}")
            return None

    # --- Mistral-7B-v0.1: uniform window 4096 ---
    mistral = mistral_model()
    params = weights(mistral, 7, "Mistral-7B-v0.1")
    pods["pod-w"] = family_pod(torch, ops, ff, "pod-w", mistral, params, "mistral-7b-v0.1")
    w = pods["pod-w"]
    wfleet = dict(ff, model=mistral, model_name="mistral-7b-v0.1", prefix=w["prefix"],
                  batch_prompts=w["batch_prompts"], batch_outputs=w["batch_outputs"])
    done("pod-w")
    pods["pod-wr"] = ragged_path(torch, ops, wfleet, "pod-wr", padded="pod-w", routed=256,
                                 pod_model=mistral, pod_params=params)
    done("pod-wr")
    sinks = mistral_model(sliding_window=MISTRAL_WINDOW, swa_layers=tuple(range(32)),
                          attention_sinks=SINKS)
    pods["pod-ws"] = family_pod(torch, ops, ff, "pod-ws", sinks, params,
                                "mistral-7b-v0.1-sinks4", decode_burst=TAIL_SLOTS)
    ws = pods["pod-ws"]
    pods["pod-ws"]["graph_vs_eager"] = burst_graph_vs_eager(
        torch, ws["pod"], "pod-ws", [ws["prefix"] + ff["tokens"](64) for _ in range(8)])
    done("pod-ws")

    # --- the hybrid stand-in: Mistral's weights, Gemma 3's layout ---
    hybrid = hybrid_model()
    name = "mistral-7b-v0.1-gemma3-layout"
    pods["pod-h"] = family_pod(torch, ops, ff, "pod-h", hybrid, params, name)
    h = pods["pod-h"]
    others = ff["indexer"].score_tokens(h["prefix"] + ff["tokens"](64), name)
    if "pod-h" in others:
        fail(f"pod-h scores {others} for a prompt sharing only its 4096-token prefix "
             "(out of its committed window: no resume)")
    twin = hybrid_twin(torch, hybrid, h["pod"], h["traffic"])
    print(f"pod-h free pages after its traffic (full, SWA): {h['free_pages_after']}; "
          f"its CPU twin's: {twin}", flush=True)
    if twin != h["free_pages_after"]:
        fail(f"pod-h: free pages {h['free_pages_after']}, the CPU twin predicts {twin}")
    pods["pod-h"]["twin_free_pages"] = twin
    done("pod-h")
    pods["pod-hb"] = family_pod(torch, ops, ff, "pod-hb", hybrid, params, name,
                                decode_burst=TAIL_SLOTS)
    hb = pods["pod-hb"]
    if hb["pod"]._burst_degraded:
        fail("pod-hb latched single-token decoding: its SWA pool is too small")
    pods["pod-hb"]["graph_vs_eager"] = burst_graph_vs_eager(
        torch, hb["pod"], "pod-hb", [hb["cold"] + ff["tokens"](64) for _ in range(8)])
    done("pod-hb")
    out["offload"] = hybrid_offload(torch, ops, ff, hybrid, params, name)
    ff["engines"]["pod-ho"] = ff["engines"]["pod-ho2"] = None
    gc.collect()
    torch.cuda.empty_cache()
    out["pod-w logits"] = held("pod-w", family_logits, torch, mistral, params, w["cold"])
    out["pod-wr logits"] = held("pod-wr", ragged_logits_parity, torch, mistral, params)
    out["pod-ws logits"] = held("pod-ws", family_logits, torch, sinks, params, ws["cold"])
    out["pod-h logits"] = held("pod-h", family_logits, torch, hybrid, params, h["cold"])
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # --- Qwen3-8B: QK-norm ---
    qwen = qwen3_model()
    params = weights(qwen, 8, "Qwen3-8B")
    pods["pod-q"] = family_pod(torch, ops, ff, "pod-q", qwen, params, "qwen3-8b")
    done("pod-q")
    cold_q = pods["pod-q"]["cold"]
    out["pod-q logits"] = held("pod-q", family_logits, torch, qwen, params, cold_q)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    keep = ("ttft_cold_ms", "ttft_warm_ms", "decode_ms_per_step_b8", "host_ms_per_token_b8",
            "routed", "launches", "fused", "leaves",
            "prefill_chunks", "decode_steps", "bursts", "free_pages_after", "twin_free_pages",
            "graph_vs_eager", "dispatches", "mixed_step_ms_in_window", "launches_by_shape",
            "greedy_agreement")
    out["pods"] = {p: {k: v for k, v in r.items() if k in keep} for p, r in pods.items()}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 13: peak device memory {out['peak_memory_gib']:.2f} GiB "
          f"(torch.cuda.max_memory_allocated), wall time {out['wall_s']:.1f} s", flush=True)
    if failed:
        fail("; ".join(failed))
    return out


# ---------------------------------------------------------------------------
# Phase 14: tensor-parallel serving at tp 2
# ---------------------------------------------------------------------------

TP = 2  # phase 14's ranks
TP_HEADS = MLA_HEADS // TP  # a rank's query heads over the replicated latent


def wrapper_group(torch):
    """A rank's group for the sharded wrappers' checks in this process: no
    collective runs in attention, so none is joined."""
    from llmd_kv_cache_tpu_torch.parallel.mesh import TPGroup

    return TPGroup(rank=0, size=TP, process_group=None, device=torch.device("cuda"),
                   backend="none")


def tp_latent_decode_parity(torch, ops, gen) -> dict:
    """The latent decode's 8-head instantiations (a tp 2 rank's heads over
    the replicated latent) vs the plain version: D 576 and 640 over
    contexts 1..4160 with a padded row, unwindowed and at SWA 1000 + 20
    sinks, and the tail arm (TAIL_CASES' first case at both widths); timed
    at b 8 over 4160 latents, D 576, with and without an 8-token tail."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import paged_attention

    decode = ops.cuda_paged_latent_decode_attention
    lens = [1, 17, 300, 1024, 2049, 3001, 4160, 0]
    err = tail_err = 0.0
    for width in (576, 640):
        for window, sinks in ((None, None), (1000, 20)):
            num_pages = sum((n + PAGE - 1) // PAGE for n in lens) + 64
            k = latent_pool(torch, gen, num_pages, width)
            table = page_table_for(torch, gen, lens, num_pages)
            ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q = torch.randn(len(lens), TP_HEADS, width, generator=gen,
                            device="cuda").to(torch.bfloat16)
            out = decode(q, k, None, table, ctx, sliding_window=window, sinks=sinks,
                         shared_kv=True)
            torch.cuda.synchronize()
            live = ctx > 0
            name = f"latent decode h{TP_HEADS} d{width}" + (
                f" swa{window}+sinks{sinks}" if window else "")
            if not bool((out[~live] == 0).all()):
                fail(f"{name}: a padded row (total_len 0) did not return zeros")
            ref = paged_attention(q[:, None], k, k, table, (ctx - 1)[:, None], ctx,
                                  sliding_window=window, attention_sinks=sinks)[:, 0]
            err = max(err, check_close(name, out[live], ref[live]))
        name, t_lens, tails, _, _ = TAIL_CASES[0]
        k, _, table, ctx, tk, _, tl = tail_case(torch, gen, t_lens, tails, 1, width)
        q = torch.randn(len(t_lens), TP_HEADS, width, generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = decode(q, k, None, table, ctx, shared_kv=True, tail_k=tk, tail_lens=tl)
        torch.cuda.synchronize()
        live = (ctx + tl) > 0
        tail_err = max(tail_err, check_close(
            f"latent decode h{TP_HEADS} d{width} {name}", out[live],
            plain_tail(q, k, k, table, ctx, tk, tk, tl)[live]))
    timing = latent_decode_b8_timing(torch, ops, gen, 0, heads=TP_HEADS)
    tail = latent_decode_b8_timing(torch, ops, gen, TAIL_SLOTS, heads=TP_HEADS)
    return dict(timing, max_abs_err=max(err, timing["max_abs_err"]),
                tail=dict(tail, max_abs_err=max(tail_err, tail["max_abs_err"])))


def checked_times(torch, name, kernel, plain, nbytes, flops, rows=None) -> dict:
    """``kernel()`` against ``plain()`` (their first ``rows`` entries of the
    first axis, all by default), then both timed (device ms) beside the
    bound of ``nbytes`` and ``flops``."""
    out = kernel()
    torch.cuda.synchronize()
    err = check_close(name, out[rows] if rows is not None else out,
                      plain()[rows] if rows is not None else plain())
    ms, plain_ms = device_ms(kernel), device_ms(plain, iters=3)
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"{name}: {ms:.4f} ms/launch on the device, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


# A tp 2 rank's attention shapes: (label, pool heads, width, query heads).
TP_RANK_SHAPES = (("gqa", KV_HEADS // TP, HEAD_DIM, Q_HEADS // TP), ("mla", 1, 576, TP_HEADS))


def tp_wrapper_parity(torch, ops, gen, shapes=TP_RANK_SHAPES) -> dict:
    """Both sharded wrappers at a tp 2 rank's ``shapes``, against their
    plain versions (``sharded_decode_attention``,
    ``sharded_prefill_attention``) and timed beside their bounds: phase
    14's, the bench model's 8 query heads over 4 kv heads of 128 and
    DeepSeek-V2-Lite's (and Moonlight's) 8 heads over the whole 576-wide
    latent; phase 16 adds Mixtral's 16 over 4; the decode at b 8 over 4160
    keys (and over contexts 1..4160 with a padded row), the prefill at S
    2048 over ctx 2048. Each dispatch must count one launch of the wrapper
    and one of the kernel wrapper it calls."""
    from llmd_kv_cache_tpu_torch.ops.paged_attention import (
        sharded_decode_attention,
        sharded_prefill_attention,
    )

    grp = wrapper_group(torch)
    dec, pre = ops.sharded_paged_decode_attention, ops.sharded_paged_prefill_attention
    out = {"decode": {}, "prefill": {}}
    for kind, pool_heads, width, q_heads in shapes:
        shared = kind == "mla"
        heads = dict(q_heads=q_heads * TP, kv_heads=pool_heads if shared else pool_heads * TP)
        inner = (ops.cuda_paged_latent_decode_attention if shared
                 else ops.cuda_paged_decode_attention)
        lens = [4160] * 8
        num_pages = sum((n + PAGE - 1) // PAGE for n in lens) + 64
        shape = (num_pages, pool_heads, PAGE, width)
        k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        v = k if shared else torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        for label, ctx_l in (("b8 ctx4160", lens), ("ragged", [1, 17, 300, 1024, 2049, 3001,
                                                              4160, 0])):
            table = page_table_for(torch, gen, ctx_l, num_pages)
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
            q = torch.randn(8, q_heads, width, generator=gen, device="cuda").to(torch.bfloat16)

            def kernel(q=q, table=table, ctx=ctx):
                return dec(grp, q, k, v, table, ctx, shared_kv=shared, **heads)

            def plain(q=q, table=table, ctx=ctx):
                return sharded_decode_attention(TP, q, k, v, table, ctx, shared_kv=shared,
                                                **heads)

            name = f"sharded decode {kind} {label} ({q_heads} heads over {pool_heads})"
            if label == "ragged":
                before = (dec.launches, inner.launches)
                got = kernel()
                torch.cuda.synchronize()
                if (dec.launches - before[0], inner.launches - before[1]) != (1, 1):
                    fail(f"{name}: one call counted {dec.launches - before[0]} wrapper and "
                         f"{inner.launches - before[1]} kernel launches, not 1 and 1")
                live = ctx > 0
                check_close(name, got[live], plain()[live])
                continue
            keys = sum(ctx_l)
            kv_bytes = keys * pool_heads * width * 2 * (1 if shared else 2)
            out["decode"][kind] = checked_times(
                torch, name, kernel, plain,
                kv_bytes + 2 * q.numel() * 2 + table.numel() * 4 + ctx.numel() * 4,
                4 * q_heads * width * keys)
        # The prefill: S 2048 over a 2048-token prefix.
        table = page_table_for(torch, gen, [4096], num_pages)
        ctx = torch.tensor([2048], dtype=torch.int32, device="cuda")
        total = ctx + 2048
        q = torch.randn(1, 2048, q_heads, width, generator=gen,
                        device="cuda").to(torch.bfloat16)
        pairs = float((torch.arange(2048, 4096, dtype=torch.float64) + 1).sum())
        kv_bytes = 4096 * pool_heads * width * 2 * (1 if shared else 2)
        out["prefill"][kind] = checked_times(
            torch, f"sharded prefill {kind} s2048 ctx2048 ({q_heads} heads over {pool_heads})",
            lambda: pre(grp, q, k, v, table, ctx, total, shared_kv=shared, **heads),
            lambda: sharded_prefill_attention(TP, q, k, v, table, ctx, total,
                                              shared_kv=shared, **heads),
            kv_bytes + 2 * q.numel() * 2 + table.numel() * 4 + 8,
            4 * q_heads * width * pairs, rows=0)
    out["max_abs_err"] = {w: max(r["max_abs_err"] for r in out[w].values())
                          for w in ("decode", "prefill")}
    return out


def allreduce_ms(torch, group, shape, iters=20) -> float:
    """Host ms of one all-reduce of a bf16 tensor of ``shape`` over the
    group (each ended by a synchronize)."""
    x = torch.zeros(shape, dtype=torch.bfloat16, device=group.device)
    for _ in range(3):
        group.all_reduce_(x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        group.all_reduce_(x)
        torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def tp_prompts(torch, vocab, reference) -> dict:
    """A tp pod's traffic: pod-0's (or pod-m's) own prompts, from
    ``reference``, and a 2112-token warm-up that shares no block with
    them."""
    rng = torch.Generator().manual_seed(15)
    return dict(reference["prompts"],
                warmup=torch.randint(1, vocab, (2048 + 64,), generator=rng).tolist())


# A tp pod's weights: its model's maker and seed, as phases 4 and 15 make them.
TP_SEEDS = {"gqa": 0, "mixtral": 16, "moonlight": 15}


def tp_model(which):
    return {"gqa": gqa_model, "mixtral": mixtral_model, "moonlight": moonlight_model}[which]()


def tp_weights(torch, which):
    """A tp pod's model and its full tree, made on the card from the seed:
    the bench model, DeepSeek-V2-Lite's attention (``mla_model_and_params``),
    Mixtral-8x7B's widths at MIXTRAL_LAYERS layers or Moonlight-16B-A3B."""
    from llmd_kv_cache_tpu_torch.models.llama import init_params

    if which == "mla":
        return mla_model_and_params(torch)
    model = tp_model(which)
    return model, init_params(model, seed=TP_SEEDS[which], device="cuda")


class RoutingLog:
    """While active, keeps what each expert layer call routed, on the
    device with no host read: DeepSeek-V3's chosen experts
    (``llama._deepseek_route``), or the softmax router's capacity slots
    (``llama._capacity_slots``) with the capacity of the call
    (``llama.moe_capacity``). ``digests()`` gives one hash a call of the
    chosen experts, or of the kept assignments: the ranks of a tp pod must
    give the same list."""

    def __init__(self):
        from llmd_kv_cache_tpu_torch.models import llama

        self.records, self.capacity = [], [None]
        self.saved = [(llama, n, getattr(llama, n))
                      for n in ("_deepseek_route", "_capacity_slots", "moe_capacity")]
        route, slots, capacity = (fn for _, _, fn in self.saved)

        def logged_route(*args, **kwargs):
            idx, w = route(*args, **kwargs)
            self.records.append(("experts", idx))
            return idx, w

        def logged_capacity(cfg, tokens):
            self.capacity[0] = capacity(cfg, tokens)
            return self.capacity[0]

        def logged_slots(*args, **kwargs):
            oh, pos = slots(*args, **kwargs)
            self.records.append(("kept", (oh, pos, self.capacity[0])))
            return oh, pos

        llama._deepseek_route, llama._capacity_slots = logged_route, logged_slots
        llama.moe_capacity = logged_capacity

    def stop(self) -> None:
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def digests(self) -> list:
        import hashlib

        out = []
        for kind, rec in self.records:
            if kind == "kept":  # capacity is computed before the slots in _moe_capacity
                oh, pos, c = rec
                rec = ((oh.sum(1) > 0) & (pos < c)).to("cpu").numpy()
            else:
                rec = rec.to("cpu").numpy()
            out.append(f"{kind}:{hashlib.sha256(rec.tobytes()).hexdigest()[:16]}")
        return out


def tp_pod(torch, ops, group, spec, indexer, index_pool) -> dict:
    """One tp pod on this rank. Phase 14: the weights made on the card from
    the seed and moved to the host; the cold prompt's second 2048-token
    chunk through tp 1 on rank 0 (the kernels in bf16, and the plain
    attention with the weights in fp32); then the engine
    (``MiniEngine(tp=group)``) over the host tree, which places the rank's
    shard on its card. Phase 16 (``spec["turns"]``): each rank in turn
    makes the full tree on the card and its engine takes its shard from it
    before the tree is dropped, so one full tree at most is on the card;
    the tp 1 chunk logits come from the parent's files
    (``spec["chunk_files"]``). Then the chunk through tp 2 (held: its rms
    distance from fp32 at most FP32_DISTANCE_RATIO x tp 1's), a warm-up
    and, counters zeroed just before and read just after, the traffic of
    ``spec``: held checks as phase 14 says; rank 0 alone feeds the
    Indexer. ``spec["fuse"]`` is the engine's ``fuse_projections``; an
    expert model's routing is logged on the counted run (``RoutingLog``)
    and its MoE layer timed on rank 0 alone, the other ranks waiting."""
    import torch.distributed as dist

    from llmd_kv_cache_tpu_torch.events.model import BlockStoredEvent, EventBatch
    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import (
        forward,
        forward_prefill,
        init_kv_cache,
    )

    rank, name = group.rank, spec["pod"]
    turns = spec.get("turns", False)

    def say(msg):
        print(f"[tp rank {rank}] {name}: {msg}", flush=True)

    def barrier():
        group.all_reduce_(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()

    # In turns the weights come later, one rank at a time.
    model, full = ((tp_model(spec["model"]), None) if turns
                   else tp_weights(torch, spec.get("model", spec["kind"])))
    layers, pages = model.num_layers, 4096 // model.page_size
    toks = torch.tensor([spec["a"][:4096]], dtype=torch.int64, device="cuda")
    table = torch.zeros(1, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[0, :pages] = torch.arange(1, 1 + pages, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = torch.full((1,), 2048, dtype=torch.int32, device="cuda")

    def second_chunk(cfg, params, tp, plain=False):
        """Every position's logits of the cold prompt's second chunk."""
        k, v = init_kv_cache(cfg, 1 + pages, device="cuda", tp_size=group.size if tp else 1)
        if plain:
            forward(params, cfg, toks[:, :2048], k, v, table, zero, n, last_only=True,
                    plain_attention=True)
            return forward(params, cfg, toks[:, 2048:], k, v, table, n, n,
                           plain_attention=True)[0]
        forward_prefill(params, cfg, toks[:, :2048], k, v, table, zero, n, last_only=True,
                        tp=tp)
        return forward_prefill(params, cfg, toks[:, 2048:], k, v, table, n, n, tp=tp)[0]

    ref = exact = None
    if rank == 0 and not turns:
        ref = second_chunk(model, full, None)
        model32, params32 = fp32_copy(torch, model, full)
        exact = second_chunk(model32, params32, None, plain=True)
        del params32
    host = None
    if not turns:
        host = {k: ([{n_: t.cpu() for n_, t in layer.items()} for layer in leaf]
                    if k == "layers" else leaf.cpu()) for k, leaf in full.items()}
        del full
        torch.cuda.empty_cache()
    events = []

    def sink(evs):
        events.extend(evs)
        if index_pool is not None:
            index_pool.process_event_batch(EventBatch(timestamp=time.time(), events=evs), name,
                                           spec["model_name"])

    def make_engine(params):
        return MiniEngine(
            EngineConfig(model=model, num_pages=1024, max_pages_per_seq=PAGES_PER_SEQ,
                         max_prefill_tokens=2048, model_name=spec["model_name"],
                         pod_identifier=name, fuse_projections=spec.get("fuse")),
            event_sink=sink, params=params, device="cuda", tp=group)

    res = {}
    if turns:
        for r in range(group.size):  # one rank at a time holds a full tree
            if r == rank:
                t_build = time.perf_counter()
                _, full = tp_weights(torch, spec["model"])
                engine = make_engine(full)
                del full
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                res["build_s"] = time.perf_counter() - t_build
                res["build_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
                say(f"made the full tree on the card and took the shard in "
                    f"{res['build_s']:.1f} s; peak {res['build_peak_memory_gib']:.2f} GiB, "
                    f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held after "
                    f"(torch.cuda.max_memory_allocated of this process)")
            barrier()
    else:
        engine = make_engine(host)
        del host
    served = engine.cfg.model  # the engine's copy: its fused_interleave
    leaves = sorted(engine.params["layers"][-1])
    res.update(leaves=leaves, fused_interleave=engine.params.get("fused_interleave"))
    say(f"the shard's last layer: {leaves}; fused_interleave {served.fused_interleave}, "
        f"the tree's marker {res['fused_interleave']}")
    if spec.get("fuse") and not ("w_qkv" in leaves and served.fused_interleave == group.size
                                 and res["fused_interleave"] == group.size):
        fail(f"{name}: fuse_projections=True did not give a tree fused at interleave "
             f"{group.size}: {leaves}, {served.fused_interleave}")
    placed = {t.device for k, leaf in engine.params.items() if k != "fused_interleave"
              for t in ([t for layer in leaf for t in layer.values()] if k == "layers"
                        else [leaf])}
    if placed != {torch.device("cuda", torch.cuda.current_device())}:
        fail(f"{name}: the engine's shard lies on {placed}, not on the rank's card")
    got = second_chunk(served, engine.params, group)
    if rank == 0 and turns:
        ref, exact = (torch.load(f, map_location="cuda") for f in spec["chunk_files"])
    if rank == 0:
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{name}: tp chunk logits of shape {tuple(got.shape)} or not finite")

        def rms(x):
            return float(x.float().pow(2).mean().sqrt())

        scale, rms_scale = float(exact.abs().max()), rms(exact)
        res["chunk_logits"] = d = dict(
            tp2_vs_fp32_rms=rms(got - exact) / rms_scale,
            tp1_vs_fp32_rms=rms(ref - exact) / rms_scale,
            tp2_vs_fp32=float((got - exact).abs().max()) / scale,
            tp1_vs_fp32=float((ref - exact).abs().max()) / scale,
            tp2_vs_tp1=float((got - ref).abs().max()) / float(ref.abs().max()),
            argmax_agreement_vs_tp1=float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
        d["rms_ratio"] = d["tp2_vs_fp32_rms"] / d["tp1_vs_fp32_rms"]
        say(f"the cold prompt's chunk 2 (2048 over 2048, every position) against the tp 1 "
            f"forward in fp32, rms |diff| / rms logit: tp {group.size} "
            f"{d['tp2_vs_fp32_rms']:.4f}, tp 1 {d['tp1_vs_fp32_rms']:.4f}, ratio "
            f"{d['rms_ratio']:.4f} (held: <= {FP32_DISTANCE_RATIO}); max |diff| / max|logit|: "
            f"tp {group.size} {d['tp2_vs_fp32']:.4f}, tp 1 {d['tp1_vs_fp32']:.4f}; tp "
            f"{group.size} against tp 1 {d['tp2_vs_tp1']:.4f} (5% printed, not held), argmax "
            f"agreement {d['argmax_agreement_vs_tp1']:.4f}")
        if not d["rms_ratio"] <= FP32_DISTANCE_RATIO:
            fail(f"{name}: the tp {group.size} chunk logits sit further from the fp32 forward "
                 f"than {FP32_DISTANCE_RATIO} x tp 1's ({d['rms_ratio']:.4f})")
    del got, ref, exact
    torch.cuda.empty_cache()

    engine.generate("TW", spec["warmup"], max_new_tokens=2)  # first launches
    prefill_chunks = record_calls(engine, "_prefill_chunk")
    decode_calls = record_calls(engine, "_decode_chunk")
    routing = RoutingLog() if model.num_experts else None

    def sync_ms(t_start):
        torch.cuda.synchronize()
        return (time.perf_counter() - t_start) * 1e3

    # --- the counted run: counters zeroed just before, read just after ---
    zero_launches(ops)
    ops.sharded_paged_decode_attention.launches = 0
    ops.sharded_paged_prefill_attention.launches = 0
    n_events = len(events)
    plain = PlainCalls()
    t = time.perf_counter()
    engine.add_request("A", spec["a"], max_new_tokens=1)
    res["ttft_cold_ms"] = sync_ms(t)
    scores = indexer.score_tokens(spec["b"], spec["model_name"]) if rank == 0 else None
    t = time.perf_counter()
    req_b = engine.add_request("B", spec["b"], max_new_tokens=1)
    res["ttft_warm_ms"] = sync_ms(t)
    batch = [engine.enqueue(f"D{i}", p, max_new_tokens=16) for i, p in enumerate(spec["batch"])]
    step_ms = []
    while any(not r.done for r in batch):
        decoding = sum(1 for r in batch if r.prefill_pos is None and r.output and not r.done)
        prefilling = any(r.prefill_pos is not None for r in batch)
        t = time.perf_counter()
        engine.step()
        elapsed = sync_ms(t)
        if decoding == 8 and not prefilling:
            step_ms.append(elapsed)
    torch.cuda.synchronize()
    plain.stop()
    if routing is not None:
        routing.stop()
    launches = read_launches(ops)
    sharded = {"decode": ops.sharded_paged_decode_attention.launches,
               "prefill": ops.sharded_paged_prefill_attention.launches}
    n_prefill, n_decode = len(prefill_chunks), len(decode_calls)
    # --- end of the counted run ---
    if routing is not None:
        res["routing_digests"] = routing.digests()
        kinds = sorted({d.split(":")[0] for d in res["routing_digests"]})
        say(f"{len(res['routing_digests'])} expert layer calls routed on the counted run "
            f"({kinds}); the parent holds them equal across the ranks")
        n_moe = sum(model.moe_layer(i) for i in range(layers))
        if len(res["routing_digests"]) != n_moe * (n_prefill + n_decode):
            fail(f"{name}: {len(res['routing_digests'])} routed calls for {n_moe} expert "
                 f"layers x {n_prefill + n_decode} dispatches")

    say(f"{n_prefill} prefill chunks, {n_decode} decode steps; sharded wrapper launches "
        f"{sharded}, kernel launches {launches}, {plain.calls} plain attention calls")
    want = {"decode": layers * n_decode, "prefill": layers * n_prefill}
    if sharded != want or not n_prefill or not n_decode or plain.calls:
        fail(f"{name}: sharded launches {sharded}, expected {want}; {plain.calls} plain calls")
    kernels = ({"cuda_paged_latent_decode_attention": want["decode"],
                "cuda_paged_latent_prefill_attention": want["prefill"]} if spec["kind"] == "mla"
               else {"cuda_paged_decode_attention": want["decode"],
                     "cuda_paged_prefill_attention": want["prefill"]})
    if launches != {fn: kernels.get(fn, 0) for fn in launches}:
        fail(f"{name}: kernel launches {launches}, expected {kernels} and no other")
    if req_b.cached_len != 4096:
        fail(f"{name}: routed prompt's cached_len {req_b.cached_len}, expected 4096")
    outputs = [r.output for r in batch]
    if any(len(o) != 16 or not all(0 <= x < model.vocab_size for x in o) for o in outputs):
        fail(f"{name}: bad outputs {outputs}")
    if not step_ms:
        fail(f"{name}: no decode step ran at batch 8")
    stored = [h for e in events[n_events:] if isinstance(e, BlockStoredEvent)
              for h in e.block_hashes]
    if rank == 0:
        ranked = sorted(scores, key=lambda p: (-scores[p], p))
        say(f"score_tokens(prompt B): {scores}; routed cached_len {req_b.cached_len}")
        if not ranked or ranked[0] != name or scores[name] != 256:
            fail(f"{name}: routing expected {name} first with 256 blocks, got {scores}")
        if stored != spec["stored"]:
            fail(f"{name}: rank 0 stored {len(stored)} blocks on the counted run, "
                 f"{spec['reference_pod']} {len(spec['stored'])}, not the same hashes")
        res["stored_blocks"] = len(stored)
        res["scores"] = scores
    elif events:
        fail(f"{name}: rank {rank} handed {len(events)} events to its sink")
    if spec["kind"] == "mla":
        # Every rank computes the whole latent: the pools must be bit-equal.
        mismatched = 0
        for li in range(layers):
            mine = engine.k_cache[li]
            theirs = mine.clone() if rank else mine
            dist.broadcast(theirs, src=0, group=group.process_group)
            mismatched += int(rank != 0 and not torch.equal(theirs, mine))
        flag = torch.tensor([mismatched], dtype=torch.float32, device="cuda")
        group.all_reduce_(flag)
        if flag.item():
            fail(f"{name}: {int(flag.item())} latent pool layers differ across the ranks")
        say(f"latent pools bit-equal across the {group.size} ranks ({layers} layers)")
        res["latent_pools_bit_equal"] = True
    if model.num_experts:
        # The MoE layer alone on this rank's shard (its half of every
        # expert's inner width), timed on rank 0 while the others wait.
        import dataclasses

        half = dataclasses.replace(
            served, intermediate_size=served.intermediate_size // group.size,
            moe_intermediate_size=served.moe_intermediate_size // group.size)
        if rank == 0:
            res["moe_layer_rank"] = moe_layer_times(torch, half, engine.params, spec["smi"])
        barrier()
    pairs = [(x, y) for o, r in zip(outputs, spec["tp1_outputs"]) for x, y in zip(o, r)]
    res["greedy_agreement_vs_tp1"] = sum(x == y for x, y in pairs) / len(pairs)
    res.update(launches=launches, sharded_launches=sharded, prefill_chunks=n_prefill,
               decode_steps=n_decode, decode_ms_per_step_b8=sum(step_ms) / len(step_ms),
               decode_steps_timed=len(step_ms), outputs=outputs)
    say(f"TTFT cold {res['ttft_cold_ms']:.1f} ms, warm {res['ttft_warm_ms']:.1f} ms, decode "
        f"step at batch 8 {res['decode_ms_per_step_b8']:.1f} ms; greedy agreement with the "
        f"tp 1 pod {res['greedy_agreement_vs_tp1']}")
    return res


def tp_rank(group, job) -> dict:
    """One rank of phase 14 (or 16), run by ``parallel.mesh.spawn_tp`` in a
    process of its own: the library built by the parent loaded, then each
    of the job's pods (``tp_pod``), freed after its checks, rank 0 feeding
    one Indexer; then the all-reduce's host ms at a decode step's and a
    prefill chunk's shapes."""
    import gc

    import torch

    from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
    from llmd_kv_cache_tpu_torch.events.pool import Pool
    from llmd_kv_cache_tpu_torch.ops import cuda_build
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops
    from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.load_library()
    indexer = index_pool = None
    if group.rank == 0:
        indexer = Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
            block_size_tokens=PAGE)))
        index_pool = Pool(indexer.kv_block_index, indexer.token_processor)
    out = {}
    for spec in job["pods"]:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out[spec["pod"]] = tp_pod(torch, ops, group, spec, indexer, index_pool)
        out[spec["pod"]].update(wall_s=time.perf_counter() - t,
                                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        gc.collect()
        torch.cuda.empty_cache()
    out["allreduce_ms"] = {"decode step b8 [8, 1, 2048]": allreduce_ms(torch, group,
                                                                       (8, 1, 2048)),
                           "prefill chunk [1, 2048, 2048]": allreduce_ms(torch, group,
                                                                         (1, 2048, 2048))}
    return out


def tp_path(torch, ops, gen, reference) -> dict:
    """Phase 14: the latent kernels' 8-head arms and both sharded wrappers
    at a rank's shapes, in this process; then two ranks at tp 2 (gloo when
    they share one card, NCCL when each has its own) serve ``pod-t`` (the
    GQA bench model) and ``pod-mt`` (DeepSeek-V2-Lite attention) with
    pod-0's and pod-m's traffic (``reference``: their prompts, counted-run
    BlockStored hashes and batch outputs)."""
    import gc

    from llmd_kv_cache_tpu_torch.parallel.mesh import spawn_tp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"latent_decode_h8": tp_latent_decode_parity(torch, ops, gen),
           "latent_prefill_h8": latent_prefill_parity(torch, ops, gen, heads=TP_HEADS),
           "wrappers": tp_wrapper_parity(torch, ops, gen)}
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= TP else "gloo"
    devices = [f"cuda:{r}" for r in range(TP)] if backend == "nccl" else ["cuda:0"] * TP
    note = ("" if backend == "nccl" else "; gloo's all-reduce is staged through the host, so "
            "its times say nothing of NVLink")
    print(f"phase 14: tp {TP} over {backend} ({cards} card(s); ranks on {devices}){note}",
          flush=True)
    pods = []
    for pod, kind, model_name, vocab, base in (
            ("pod-t", "gqa", "llama-0.9b", 32000, "pod-0"),
            ("pod-mt", "mla", "deepseek-v2-lite-dense", 102400, "pod-m")):
        r = reference[kind]
        pods.append(dict(pod=pod, kind=kind, model_name=model_name, reference_pod=base,
                         stored=r["stored"], tp1_outputs=r["outputs"],
                         **tp_prompts(torch, vocab, r)))
    ranks = spawn_tp(tp_rank, TP, backend=backend, devices=devices, args=(dict(pods=pods),),
                     timeout_s=600, collective_timeout_s=300)
    for spec in pods:
        outs = [r[spec["pod"]]["outputs"] for r in ranks]
        if any(o != outs[0] for o in outs):
            fail(f"{spec['pod']}: the ranks decoded different tokens")
    out.update(backend=backend, devices=devices, ranks=[
        {p: {k: v for k, v in r[p].items() if k != "outputs"} for p in ("pod-t", "pod-mt")}
        | {"allreduce_ms": r["allreduce_ms"]} for r in ranks])
    out["allreduce_note"] = ("host-staged gloo: says nothing of NVLink" if backend == "gloo"
                             else "NCCL")
    out["parent_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 14: wall time {out['wall_s']:.1f} s; peak device memory: this process "
          f"{out['parent_peak_memory_gib']:.2f} GiB, the ranks "
          f"{[{p: round(r[p]['peak_memory_gib'], 2) for p in ('pod-t', 'pod-mt')} for r in ranks]}"
          f" GiB (torch.cuda.max_memory_allocated)", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 15: mixture-of-experts serving at public widths
# ---------------------------------------------------------------------------

MOE_CHECK_TOKENS = 16  # the card-against-CPU layer check's tokens
MOE_OUT_REL_TOL = 1e-4  # of the CPU's largest |output|, fp32 on both
MIXTRAL_LAYERS = 8  # of Mixtral-8x7B's 32: the whole model (93 GB) fits no card


def moonlight_model():
    """Moonlight-16B-A3B, by hand from huggingface.co/moonshotai/Moonlight-16B-A3B
    config.json (model_type deepseek_v3), converted as the JAX
    ``hf_loader._config_from_deepseek`` does: vocab 163840, hidden 2048, 27
    layers, 16 heads, ``kv_lora_rank`` 512 and ``qk_rope_head_dim`` 64 (a
    576-wide latent row), head_dim = qk_nope_head_dim = v_head_dim 128, no
    q-LoRA, rope_theta 50000, no rope_scaling, rms eps 1e-5; layer 0 dense
    at intermediate 11264 (``first_k_dense_replace`` 1), layers 1-26 of 64
    routed experts of 1408, 6 a token, and 2 shared experts (2816); the
    ``("deepseek_v3", n_group 1, topk_group 1, norm_topk_prob, 2.446)``
    router on the exact dense dispatch; page 16, bf16 (~15.96B params). Not
    cut."""
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=163840, hidden_size=2048, num_layers=27, num_heads=16,
                       num_kv_heads=16, head_dim=128, intermediate_size=11264,
                       rope_theta=50000.0, norm_eps=1e-5, page_size=16, kv_lora_rank=512,
                       qk_rope_head_dim=64, num_experts=64, num_experts_per_token=6,
                       moe_dispatch="dense", moe_layers=tuple(range(1, 27)),
                       n_shared_experts=2, moe_intermediate_size=1408,
                       moe_router=("deepseek_v3", 1, 1, 1, 2.446))


def mixtral_model():
    """Mixtral-8x7B-v0.1's widths, by hand from
    huggingface.co/mistralai/Mixtral-8x7B-v0.1 config.json: vocab 32000,
    hidden 4096, 32 heads over 8 kv heads of 128, 8 experts of 14336, top 2
    on the softmax router, rope_theta 1e6, rms eps 1e-5, no window; page 16,
    bf16. Cut: ``MIXTRAL_LAYERS`` of its 32 layers (~11.87B params: the
    whole model's 93 GB fits no card), and the capacity dispatch at the
    default factor 2.0 (``hf_loader`` converts to the exact dense one and
    names capacity the opt-in performance mode; Moonlight covers dense)."""
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=4096, num_layers=MIXTRAL_LAYERS,
                       num_heads=32, num_kv_heads=8, head_dim=128, intermediate_size=14336,
                       rope_theta=1e6, norm_eps=1e-5, page_size=16, num_experts=8,
                       num_experts_per_token=2, moe_dispatch="capacity",
                       moe_capacity_factor=2.0)


def wide_moe_layer(torch, model, seed):
    """One expert layer of ``model``'s widths in fp32 on the card, 0.02-scaled
    normals from ``seed`` (a DeepSeek router's bias at 0.5, so that the
    biased choice engages)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    e, h = model.num_experts, model.hidden_size
    inter = model.moe_intermediate_size or model.intermediate_size

    def normal(*shape, scale=0.02):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    layer = {"router": normal(h, e), "w_gate": normal(e, h, inter), "w_up": normal(e, h, inter),
             "w_down": normal(e, inter, h)}
    if model.deepseek_router:
        sh = inter * max(model.n_shared_experts, 1)
        layer.update(router_bias=normal(e, scale=0.5), w_gate_sh=normal(h, sh),
                     w_up_sh=normal(h, sh), w_down_sh=normal(sh, h))
    return layer


def moe_layer_card_vs_cpu(torch) -> dict:
    """The MoE layer of each router on the card and on the CPU, fp32, at
    Moonlight's widths (its ``router_bias`` non-zero) and Mixtral's (at
    capacity factor 0.5, so that assignments drop), on MOE_CHECK_TOKENS
    tokens from a seed: the chosen experts and the kept assignments equal,
    the outputs within MOE_OUT_REL_TOL of the CPU's largest |output|."""
    import dataclasses

    from llmd_kv_cache_tpu_torch.models import llama

    out = {}
    for label, model in (("moonlight", moonlight_model()),
                         ("mixtral_cf0.5", dataclasses.replace(mixtral_model(),
                                                               moe_capacity_factor=0.5))):
        model = dataclasses.replace(model, dtype=torch.float32)
        layer = wide_moe_layer(torch, model, seed=15)
        cpu_layer = {k: v.cpu() for k, v in layer.items()}
        x = torch.randn((1, MOE_CHECK_TOKENS, model.hidden_size),
                        generator=torch.Generator(device="cuda").manual_seed(16), device="cuda")

        def route(lay, xs):
            if model.deepseek_router:
                return llama._deepseek_route(xs[0], lay, model)[0].cpu(), None
            idx = llama._moe_router(xs, lay, model)[0]
            oh, pos = llama._capacity_slots(idx, model.num_experts)
            kept = (oh.sum(1) > 0) & (pos < llama.moe_capacity(model, MOE_CHECK_TOKENS))
            return idx.cpu(), kept.cpu()

        got, want = llama._mlp(x, layer, model).cpu(), llama._mlp(x.cpu(), cpu_layer, model)
        (g_idx, g_kept), (w_idx, w_kept) = route(layer, x), route(cpu_layer, x.cpu())
        err = float((got - want).abs().max()) / float(want.abs().max())
        res = out[label] = dict(experts_equal=bool(torch.equal(g_idx, w_idx)),
                                max_abs_err_rel=err)
        if w_kept is not None:
            res.update(kept_equal=bool(torch.equal(g_kept, w_kept)),
                       kept=int(w_kept.sum()), assignments=int(w_kept.numel()))
        print(f"MoE layer ({label}, fp32, {MOE_CHECK_TOKENS} tokens) card vs CPU: {res}",
              flush=True)
        if not res["experts_equal"] or not res.get("kept_equal", True) or not (
                err <= MOE_OUT_REL_TOL) or res.get("kept") == res.get("assignments", -1):
            fail(f"MoE layer {label}: the card's routing or output is not the CPU's ({res})")
        del layer, cpu_layer
        torch.cuda.empty_cache()
    return out


def moe_work(model, idx, tokens) -> dict:
    """The MoE layer's bytes and operations at ``tokens`` tokens whose chosen
    experts are ``idx``: every expert's weights (what the dense form reads)
    and the routed work alone (the experts chosen, each token's k of them,
    and the shared experts)."""
    h, e, k = model.hidden_size, model.num_experts, model.num_experts_per_token
    inter = model.moe_intermediate_size or model.intermediate_size
    sh = inter * max(model.n_shared_experts, 1) if model.deepseek_router else 0
    expert_bytes, shared_bytes = 3 * h * inter * 2, 3 * h * sh * 2
    io_bytes = 2 * tokens * h * 2 + h * e * 2  # tokens in and out, the router
    routed = int(idx.unique().numel())
    routed_flops, shared_flops = 2 * tokens * k * 3 * h * inter, 2 * tokens * 3 * h * sh
    every = e * expert_bytes + shared_bytes + io_bytes
    used = routed * expert_bytes + shared_bytes + io_bytes
    return dict(experts_routed=routed, every_expert_gb=every / 1e9,
                every_expert_bytes_ms=every / HBM_BYTES_PER_S * 1e3, routed_gb=used / 1e9,
                routed_gflop=routed_flops / 1e9, shared_gflop=shared_flops / 1e9,
                routed_bound=bound_ms(used, routed_flops + shared_flops))


def moe_layer_times(torch, model, params, smi) -> dict:
    """The first expert layer of the served tree alone (``_mlp``), device ms
    at a decode step's 8 tokens and a 2048-token chunk (bf16 inputs from a
    seed), beside the bound of every expert's bytes (what the dense form
    reads) and of the routed work alone; and the share of those tokens
    whose chosen experts change when the same inputs are routed in fp32
    (before their bf16 rounding, the router upcast): one layer's routing
    flips between the bf16 serving path and the fp32 reference."""
    import dataclasses

    from llmd_kv_cache_tpu_torch.models import llama

    li = next(i for i in range(model.num_layers) if model.moe_layer(i))
    layer, h = params["layers"][li], model.hidden_size
    router32 = {k: layer[k].float() for k in ("router", "router_bias") if k in layer}
    model32 = dataclasses.replace(model, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(17)

    def chosen(cfg, lay, xs):
        idx = (llama._deepseek_route(xs.reshape(-1, h), lay, cfg)[0] if cfg.deepseek_router
               else llama._moe_router(xs, lay, cfg)[0].reshape(-1, cfg.num_experts_per_token))
        return idx.sort(dim=-1).values

    out = {}
    for label, shape in (("decode_b8", (8, 1, h)), ("chunk2048", (1, 2048, h))):
        x32 = torch.randn(shape, generator=gen, device="cuda")
        x = x32.to(model.dtype)
        ms = device_ms(lambda: llama._mlp(x, layer, model), iters=10)
        idx = chosen(model, layer, x)
        flips = float((idx != chosen(model32, router32, x32)).any(-1).float().mean())
        work = moe_work(model, idx, shape[0] * shape[1])
        out[label] = dict(ms=ms, routing_flips_vs_fp32=flips, **work)
        print(f"MoE layer {li} ({model.moe_dispatch} dispatch, {label}): {ms:.4f} ms on the "
              f"device; every expert's bytes {work['every_expert_gb']:.3f} GB = "
              f"{work['every_expert_bytes_ms']:.4f} ms; the routed work alone "
              f"({work['experts_routed']} of {model.num_experts} experts, "
              f"{work['routed_gb']:.3f} GB, {work['routed_gflop']:.1f} + "
              f"{work['shared_gflop']:.1f} shared GFLOP) {work['routed_bound'][0]:.4f} ms "
              f"({work['routed_bound'][1]}); tokens whose experts change when routed in "
              f"fp32: {flips:.4f}; {smi}", flush=True)
    return out


def moe_profile_window(torch, run, smi) -> dict:
    """Device time by kind over one call of ``run`` (torch.profiler): the
    attention kernels (by name), the expert layers' GEMMs and their other
    work (routing, activation, mix: elementwise, sorts, gathers), and the
    rest, out of every kernel's time (``all_kernels_ms``, which sets the
    busy share). The expert layers (``llama._mlp`` on a layer with a
    router) run under a ``record_function`` range for the window: a kernel
    is theirs when the operator that launched it ran inside one. A CUDA
    graph's replayed kernels link to no operator: a burst's window splits
    only into attention and the rest."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from llmd_kv_cache_tpu_torch.models import llama

    inner = llama._mlp

    def traced(mlp_in, layer, *args, **kwargs):
        if "router" not in layer:
            return inner(mlp_in, layer, *args, **kwargs)
        with record_function("moe_layer"):
            return inner(mlp_in, layer, *args, **kwargs)

    llama._mlp = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        llama._mlp = inner

    def kernels(ev):
        yield from ev.kernels
        for child in ev.cpu_children:
            yield from kernels(child)

    def is_gemm(name):
        return any(g in name.lower() for g in ("gemm", "nvjet", "xmma", "cutlass", "cublas"))

    expert = {"expert_gemms": 0.0, "expert_other": 0.0}
    for ev in prof.events():
        if ev.name == "moe_layer" and ev.device_type == torch.autograd.DeviceType.CPU:
            for k in kernels(ev):
                if k.name != "moe_layer":  # the range's own span on the device
                    expert["expert_gemms" if is_gemm(k.name) else "expert_other"] += (
                        k.duration / 1e3)
    attention = every = 0.0
    for ev in prof.key_averages():
        # The range shows on the device too, as an annotation over its kernels.
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key == "moe_layer":
            continue
        every += ev.self_device_time_total / 1e3
        if any(a in ev.key.lower() for a in ("decode_kernel", "prefill_kernel",
                                              "ragged_kernel", "combine_kernel")):
            attention += ev.self_device_time_total / 1e3
    if not every:
        out = {"wall_ms": wall_ms, "device_ms": "not measured"}
    else:
        out = {"wall_ms": wall_ms, "all_kernels_ms": every, "device_busy_share": every / wall_ms,
               "device_ms": {"attention_kernels": attention, **expert,
                             "other": every - attention - sum(expert.values())}}
    print(f"profile by kind ({smi}): {out}", flush=True)
    return out


class CapacityLog:
    """While active, records every capacity the MoE layers compute
    (``llama.moe_capacity``) with the flat length of the ragged dispatch
    (``engine.forward_ragged``) it ran under: (flat tokens, the T the
    capacity was computed from, C)."""

    def __init__(self):
        from llmd_kv_cache_tpu_torch.models import engine, llama

        self.records, flat = [], [None]
        self.saved = [(engine, "forward_ragged", engine.forward_ragged),
                      (llama, "moe_capacity", llama.moe_capacity)]
        ragged, capacity = engine.forward_ragged, llama.moe_capacity

        def logged_ragged(params, cfg, tokens, *args, **kwargs):
            flat[0] = tokens.shape[1]
            return ragged(params, cfg, tokens, *args, **kwargs)

        def logged_capacity(cfg, tokens):
            c = capacity(cfg, tokens)
            self.records.append((flat[0], tokens, c))
            return c

        engine.forward_ragged, llama.moe_capacity = logged_ragged, logged_capacity

    def stop(self) -> None:
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def check_ragged_capacity(model, records) -> dict:
    """Every capacity of a ragged pod's dispatches: C = ceil(t_pad · k ·
    factor / E), with t_pad the JAX ragged engine's flat length for the
    dispatch's tokens (a power of two, at least 8), computed here from its
    rule. Returns the shape classes {flat tokens: [t_pad, C, layer calls]}."""
    classes = {}
    for flat, tokens, c in records:
        t_pad = 8
        while flat is not None and t_pad < flat:
            t_pad *= 2
        want = math.ceil(t_pad * model.num_experts_per_token * model.moe_capacity_factor
                         / model.num_experts)
        if flat is None or tokens != t_pad or c != want:
            fail(f"ragged capacity: a dispatch of {flat} flat tokens computed C {c} from "
                 f"{tokens} tokens; JAX's t_pad {t_pad} gives {want}")
        classes.setdefault(flat, [t_pad, c, 0])[2] += 1
    if not classes or all(flat == cls[0] for flat, cls in classes.items()):
        fail(f"ragged capacity: no dispatch whose flat length JAX would pad ({classes})")
    for flat, (t_pad, c, n) in sorted(classes.items()):
        print(f"ragged capacity: {flat} flat tokens -> t_pad {t_pad}, C {c} "
              f"({n} layer calls)", flush=True)
    return classes


def ragged_ttft(torch, pod, tokens) -> dict:
    """TTFT on an idle ragged pod, host clock ending in a sync: a cold
    4160-token prompt and one sharing its 4096-token prefix, each enqueued
    and stepped to its first token (its chunks as ragged dispatches)."""
    out = {}
    cold = tokens(4160)
    for stage, prompt in (("cold", cold), ("warm", cold[:4096] + tokens(64))):
        t = time.perf_counter()
        req = pod.enqueue(f"TT{stage}", prompt, max_new_tokens=1)
        while not req.output:
            pod.step()
        torch.cuda.synchronize()
        out[f"ttft_{stage}_ms"] = (time.perf_counter() - t) * 1e3
        while not req.done:
            pod.step()
        if stage == "warm" and req.cached_len != 4096:
            fail(f"ragged TTFT: the warm prompt's cached_len {req.cached_len}, expected 4096")
    return out


def moe_path(torch, ops, smi) -> dict:
    """Phase 15: the MoE layer of each router on the card against the CPU
    at full width, then Moonlight-16B-A3B (``pod-e`` padded, ``pod-eb``
    bursts of 8, ``pod-er`` ragged) and Mixtral-8x7B's widths at
    ``MIXTRAL_LAYERS`` layers (``pod-x`` padded, ``pod-xr`` ragged), random
    weights from a seed, on one Indexer, each pod under its own model name;
    each pod freed after its checks, each model after its pods, its layer
    times and its logits check (which fails the phase at its end)."""
    import gc

    from llmd_kv_cache_tpu_torch.models.llama import init_params, maybe_fuse_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, pods = {"layer_card_vs_cpu": moe_layer_card_vs_cpu(torch), "models": {},
                 "profiles": {}}, {}
    ff = family_fleet(torch)
    tokens = ff["tokens"]
    failed = []

    def weights(model, seed, label):
        """As phase 13's: fused once where the default gate fuses."""
        t = time.perf_counter()
        params = maybe_fuse_params(init_params(model, seed=seed, device="cuda"), model)
        torch.cuda.synchronize()
        n = param_count(params)
        out["models"][label] = dict(params=n, init_s=time.perf_counter() - t)
        print(f"{label}: {n / 1e9:.3f}B params (bf16, seed {seed}), init "
              f"{out['models'][label]['init_s']:.1f} s", flush=True)
        return params

    def done(*names):
        for name in names:
            pods[name].pop("pod", None)
            ff["engines"][name] = None
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()

    def profiles(name):
        """4 decode steps at batch 8 and a cold prefill; for a burst pod one
        burst of 8 ticks at batch 8, replayed from its graph."""
        pod, r = pods[name]["pod"], pods[name]
        prompts = [r["prefix"] + tokens(64) for _ in range(8)]
        if pod._burst == 1:
            out["profiles"][name] = {
                "decode_4_steps_b8": moe_profile_window(torch, decode_steps(pod, prompts, 4),
                                                        smi),
                "cold_prefill_4160": moe_profile_window(
                    torch, lambda: pod.add_request(f"{name}-P", tokens(4160),
                                                   max_new_tokens=1), smi)}
            return
        reqs = [pod.enqueue(f"{name}-B{i}", p, max_new_tokens=1 + 3 * pod._burst)
                for i, p in enumerate(prompts)]
        while any(r.prefill_pos is not None for r in reqs) or any(
                len(r.output) < 2 for r in reqs):
            pod.step()
        out["profiles"][name] = {"burst_of_8_ticks_b8": moe_profile_window(torch, pod.step, smi)}
        for req in reqs:
            pod.abort_request(req.request_id)

    def ragged(name, model, params, padded, capacity_log=False):
        r = pods[padded]
        rfleet = dict(ff, model=model, model_name=f"{r['model_name']}-ragged",
                      prefix=r["prefix"], batch_prompts=r["batch_prompts"],
                      batch_outputs=r["batch_outputs"])
        log = CapacityLog() if capacity_log else None
        try:
            pods[name] = ragged_path(torch, ops, rfleet, name, padded=padded,
                                     pod_model=model, pod_params=params)
        finally:
            if log is not None:
                log.stop()
        if log is not None:
            pods[name]["capacity_by_flat_tokens"] = check_ragged_capacity(model, log.records)
        pod = ff["engines"][name]
        pods[name].update(ragged_ttft(torch, pod, tokens))
        timing = mixed_step_timing(torch, pod, [r["prefix"] + tokens(64) for _ in range(8)],
                                   tokens(4160))
        pods[name].update(mixed_step_ms=timing["mixed_step_ms"],
                          decode_step_ms_b8=timing["decode_step_ms_b8"])
        print(f"{name}: TTFT cold {pods[name]['ttft_cold_ms']:.3f} ms, warm "
              f"{pods[name]['ttft_warm_ms']:.3f} ms, mixed step {timing['mixed_step_ms']} ms, "
              f"decode step at batch 8 {timing['decode_step_ms_b8']} ms", flush=True)
        done(name)

    def held(label, fn, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except SystemExit as exc:
            failed.append(f"{label}: {exc}")
            return None

    # --- Moonlight-16B-A3B: DeepSeek-V3's router, the dense dispatch ---
    moon = moonlight_model()
    params = weights(moon, 15, "Moonlight-16B-A3B")
    pods["pod-e"] = family_pod(torch, ops, ff, "pod-e", moon, params, "moonlight-16b-a3b")
    pods["pod-e"]["model_name"] = "moonlight-16b-a3b"
    profiles("pod-e")
    done("pod-e")
    pods["pod-eb"] = family_pod(torch, ops, ff, "pod-eb", moon, params,
                                "moonlight-16b-a3b-bursts", decode_burst=TAIL_SLOTS)
    eb = pods["pod-eb"]
    eb["graph_vs_eager"] = burst_graph_vs_eager(
        torch, eb["pod"], "pod-eb", [eb["prefix"] + tokens(64) for _ in range(8)])
    profiles("pod-eb")
    done("pod-eb")
    ragged("pod-er", moon, params, "pod-e")
    out["moonlight_layer"] = moe_layer_times(torch, moon, params, smi)
    out["pod-e logits"] = held("pod-e", family_logits, torch, moon, params,
                               pods["pod-e"]["cold"], layerwise_fp32=True,
                               held=("chunk2048_over2048",))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # --- Mixtral-8x7B widths: the softmax router, the capacity dispatch ---
    mix = mixtral_model()
    params = weights(mix, 16, f"Mixtral-8x7B-v0.1 ({MIXTRAL_LAYERS} of 32 layers)")
    pods["pod-x"] = family_pod(torch, ops, ff, "pod-x", mix, params, "mixtral-8x7b-8l")
    pods["pod-x"]["model_name"] = "mixtral-8x7b-8l"
    profiles("pod-x")
    done("pod-x")
    ragged("pod-xr", mix, params, "pod-x", capacity_log=True)
    out["mixtral_layer"] = moe_layer_times(torch, mix, params, smi)
    out["pod-x logits"] = held("pod-x", family_logits, torch, mix, params,
                               pods["pod-x"]["cold"], layerwise_fp32=True,
                               held=("chunk2048_over2048",))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    keep = ("ttft_cold_ms", "ttft_warm_ms", "decode_ms_per_step_b8", "host_ms_per_token_b8",
            "routed", "launches", "fused", "leaves", "prefill_chunks", "decode_steps", "bursts",
            "graph_vs_eager", "dispatches", "mixed_step_ms", "decode_step_ms_b8",
            "mixed_step_ms_in_window", "launches_by_shape", "greedy_agreement",
            "capacity_by_flat_tokens")
    out["pods"] = {p: {k: v for k, v in r.items() if k in keep} for p, r in pods.items()}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 15: peak device memory {out['peak_memory_gib']:.2f} GiB "
          f"(torch.cuda.max_memory_allocated), wall time {out['wall_s']:.1f} s", flush=True)
    if failed:
        fail("; ".join(failed))
    return out


# ---------------------------------------------------------------------------
# Phase 16: fused projections, and tp over fused and expert layers
# ---------------------------------------------------------------------------

FUSED_TOKENS = (8, 2048)  # a decode step's batch, a prefill chunk
# (label, hidden, query heads, kv heads, head_dim, intermediate)
FUSED_WIDTHS = (("hidden 2048 (the bench model)", 2048, 16, 8, 128, 5632),
                ("hidden 4096 (Mistral-7B)", 4096, 32, 8, 128, 14336))
FUSED_POD_LAYERS = 8  # of Mistral-7B's 32: the fused-vs-unfused pods' depth


def fused_product_times(torch, smi) -> dict:
    """One layer's fused products against their parts, device ms
    (``device_ms``), at hidden 2048 and 4096, whole (tp 1) and at a tp 2
    rank's columns (half of each part), over 8 and 2048 tokens: ``x @
    w_qkv`` against ``x @ wq``, ``x @ wk``, ``x @ wv``, and ``x @
    w_gate_up`` against ``x @ w_gate``, ``x @ w_up`` (bf16, random). The
    bound is the function's: the weights, x and the outputs moved once,
    and 2·T·h·N operations. Printed and kept, not held: the gate stays
    JAX's (``fuse_profitable``: a rank's hidden >= 4096)."""
    gen = torch.Generator(device="cuda").manual_seed(161)
    out = {}
    for label, h, nq, nkv, hd, inter in FUSED_WIDTHS:
        for tp in (1, TP):
            for tokens in FUSED_TOKENS:
                x = torch.randn(tokens, h, generator=gen, device="cuda").to(torch.bfloat16)
                for kind, widths in (("qkv", (nq * hd, nkv * hd, nkv * hd)),
                                     ("gate_up", (inter, inter))):
                    parts = [(torch.randn(h, n // tp, generator=gen, device="cuda")
                              * 0.02).to(torch.bfloat16) for n in widths]
                    fused = torch.cat(parts, dim=1)
                    n = fused.shape[1]
                    unfused_ms = device_ms(lambda: [x @ w for w in parts])
                    fused_ms = device_ms(lambda: x @ fused)
                    b_ms, b_by = bound_ms((h * n + tokens * h + tokens * n) * 2,
                                          2 * tokens * h * n)
                    key = f"{kind} {label} tp{tp} T{tokens}"
                    out[key] = dict(unfused_ms=unfused_ms, fused_ms=fused_ms,
                                    fused_over_unfused=fused_ms / unfused_ms, bound_ms=b_ms,
                                    bound_by=b_by, columns=n)
                    print(f"fused products, {key} ({n} columns): fused {fused_ms:.4f} ms, "
                          f"unfused {unfused_ms:.4f} ms ({fused_ms / unfused_ms:.3f}x), bound "
                          f"{b_ms:.4f} ms ({b_by}); {smi}", flush=True)
                    del parts, fused
    # What the card says about JAX's crossover (fuse iff a rank's hidden >=
    # 4096, measured on a TPU v5e): which shapes fusing speeds up here.
    faster = sorted(k for k, r in out.items() if r["fused_ms"] < r["unfused_ms"])
    out["card_says"] = dict(
        fused_faster=faster,
        jax_gate="fuse iff hidden / tp >= 4096 (JAX's TPU v5e crossover, kept as it is)",
        hidden4096_tp1_all_faster=all(out[k]["fused_ms"] < out[k]["unfused_ms"]
                                      for k in out if "4096" in k and "tp1" in k),
        hidden2048_tp1_all_slower=all(out[k]["fused_ms"] >= out[k]["unfused_ms"]
                                      for k in out if "2048 (" in k and "tp1" in k))
    print(f"fused: the card's products against JAX's crossover: {out['card_says']}; {smi}",
          flush=True)
    return out


def fused_pod_turns(torch, ops, smi) -> dict:
    """A hidden-4096 pod fused (the default gate) against
    ``fuse_projections=False`` on one tree (Mistral-7B's widths at
    FUSED_POD_LAYERS layers, seed 7), in turns (unfused, fused, fused,
    unfused): each turn profiles 4 decode steps at batch 8 over ~4.2k
    context and one cold 2048-token chunk (``profile_window``: wall ms,
    device ms by kind). Printed, not held."""
    import dataclasses
    import gc

    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import init_params

    model = dataclasses.replace(mistral_model(), num_layers=FUSED_POD_LAYERS,
                                swa_layers=tuple(range(FUSED_POD_LAYERS)))
    params = init_params(model, seed=7, device="cuda")
    pods = {}
    for label, fuse in (("unfused", False), ("fused", None)):
        pods[label] = MiniEngine(
            EngineConfig(model=model, num_pages=1024, max_pages_per_seq=PAGES_PER_SEQ,
                         max_prefill_tokens=2048, model_name=f"mistral-fused-{label}",
                         pod_identifier=f"pod-f{label[0]}", fuse_projections=fuse),
            params=params, device="cuda")
    if "w_qkv" not in pods["fused"].params["layers"][0] or "w_qkv" in pods[
            "unfused"].params["layers"][0]:
        fail("fused pod turns: the default gate did not fuse the hidden-4096 tree, or "
             "fuse_projections=False did")
    rng = torch.Generator().manual_seed(162)

    def tokens(n):
        return torch.randint(1, model.vocab_size, (n,), generator=rng).tolist()

    prefix = tokens(4096)
    for pod in pods.values():
        pod.generate("warm-up", prefix + tokens(64), max_new_tokens=2)
    out = {label: [] for label in pods}
    for i, label in enumerate(("unfused", "fused", "fused", "unfused")):
        pod = pods[label]
        run = decode_steps(pod, [prefix + tokens(64) for _ in range(8)], 4)
        decode = profile_window(torch, run)
        for rid in list(pod.requests):  # the decode rows' leftover budget
            pod.abort_request(rid)
        chunk = profile_window(torch, lambda: pod.add_request(f"C{i}", tokens(2048),
                                                              max_new_tokens=1))
        out[label].append(dict(decode_4_steps_b8=decode, chunk_2048=chunk))
    summary = {label: dict(
        decode_4_steps_wall_ms=[r["decode_4_steps_b8"]["wall_ms"] for r in runs],
        decode_4_steps_matmul_ms=[r["decode_4_steps_b8"]["device_ms"].get("matmul")
                                  for r in runs if isinstance(
                                      r["decode_4_steps_b8"]["device_ms"], dict)],
        chunk_wall_ms=[r["chunk_2048"]["wall_ms"] for r in runs],
        chunk_matmul_ms=[r["chunk_2048"]["device_ms"].get("matmul") for r in runs
                         if isinstance(r["chunk_2048"]["device_ms"], dict)])
        for label, runs in out.items()}
    print(f"fused pods (Mistral-7B widths, {FUSED_POD_LAYERS} layers) in turns: {summary}; "
          f"{smi}", flush=True)
    del pods, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(summary=summary, runs=out, layers=FUSED_POD_LAYERS)


def tp_moe_prompts(vocab) -> dict:
    """A phase-16 pod's traffic, as pod-0's: a cold 4160-token prompt (a
    4096-token prefix + 64), a routed one over the same prefix, 8 more
    over it, and a 2112-token warm-up that shares no block with them."""
    import torch

    rng = torch.Generator().manual_seed(16)

    def tokens(n):
        return torch.randint(1, min(vocab, 32000), (n,), generator=rng).tolist()

    prefix = tokens(4096)
    return dict(a=prefix + tokens(64), b=prefix + tokens(64),
                batch=[prefix + tokens(64) for _ in range(8)], warmup=tokens(2048 + 64))


def tp1_reference(torch, ops, model, params, prompts, name, model_name) -> dict:
    """The tp 1 pod of a phase-16 model in this process (the default gate,
    one card): a warm-up, then the counted traffic (cold, routed, 8
    decoded to 16 tokens), its TTFTs and decode step at batch 8 (host
    clock, ending in a sync), the hashes it stored and its tokens; then
    the cold prompt's second 2048-token chunk's logits through the kernels
    (bf16) and through the plain attention in fp32 (upcast one layer at a
    time), every position."""
    import gc

    from llmd_kv_cache_tpu_torch.events.model import BlockStoredEvent
    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import forward, init_kv_cache

    events = []
    pod = MiniEngine(EngineConfig(model=model, num_pages=1024, max_pages_per_seq=PAGES_PER_SEQ,
                                  max_prefill_tokens=2048, model_name=model_name,
                                  pod_identifier=name),
                     event_sink=events.extend, params=params, device="cuda")
    pod.generate("TW", prompts["warmup"], max_new_tokens=2)
    n_events = len(events)

    def sync_ms(t):
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    out = {}
    t = time.perf_counter()
    pod.add_request("A", prompts["a"], max_new_tokens=1)
    out["ttft_cold_ms"] = sync_ms(t)
    t = time.perf_counter()
    req_b = pod.add_request("B", prompts["b"], max_new_tokens=1)
    out["ttft_warm_ms"] = sync_ms(t)
    batch = [pod.enqueue(f"D{i}", p, max_new_tokens=16) for i, p in enumerate(prompts["batch"])]
    step_ms = []
    while any(not r.done for r in batch):
        decoding = sum(1 for r in batch if r.prefill_pos is None and r.output and not r.done)
        prefilling = any(r.prefill_pos is not None for r in batch)
        t = time.perf_counter()
        pod.step()
        elapsed = sync_ms(t)
        if decoding == 8 and not prefilling:
            step_ms.append(elapsed)
    if req_b.cached_len != 4096 or not step_ms:
        fail(f"{name}: the tp 1 reference's routed prompt cached {req_b.cached_len}")
    out.update(decode_ms_per_step_b8=sum(step_ms) / len(step_ms),
               fused=pod.params.get("fused_interleave"),
               stored=[h for e in events[n_events:] if isinstance(e, BlockStoredEvent)
                       for h in e.block_hashes],
               outputs=[list(r.output) for r in batch])
    served = pod.params
    del pod
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{name} (tp 1, {'fused' if out['fused'] else 'unfused'}): TTFT cold "
          f"{out['ttft_cold_ms']:.1f} ms, warm {out['ttft_warm_ms']:.1f} ms, decode step at "
          f"batch 8 {out['decode_ms_per_step_b8']:.1f} ms, {len(out['stored'])} blocks stored",
          flush=True)

    pages = 4096 // model.page_size
    toks = torch.tensor([prompts["a"][:4096]], dtype=torch.int64, device="cuda")
    table = torch.zeros(1, PAGES_PER_SEQ, dtype=torch.int32, device="cuda")
    table[0, :pages] = torch.arange(1, 1 + pages, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    n = torch.full((1,), 2048, dtype=torch.int32, device="cuda")

    def second_chunk(cfg, prm, plain):
        k, v = init_kv_cache(cfg, 1 + pages, device="cuda")
        forward(prm, cfg, toks[:, :2048], k, v, table, zero, n, last_only=True,
                plain_attention=plain)
        return forward(prm, cfg, toks[:, 2048:], k, v, table, n, n,
                       plain_attention=plain)[0]

    ref = second_chunk(model, served, False)
    model32, params32 = fp32_copy(torch, model, dict(served, layers=[]))
    params32["layers"] = Fp32Layers(served["layers"])
    exact = second_chunk(model32, params32, True)
    del params32, served
    return out, ref, exact


def tp_moe_path(torch, ops, gen, smi) -> dict:
    """Phase 16: fused against unfused products and pods timed on the card
    (printed, not held); the sharded GQA wrappers at a Mixtral rank's 16
    query heads over 4 kv heads, and Moonlight's latent arms at a rank's 8
    heads (the sharded wrappers and the latent prefill at its chunks)
    against their plain versions; then three models at tp 2, two ranks
    (spawned) on one Indexer, each against its tp 1 pod served here first
    (stored hashes, tokens, the chunk logits written to files for rank 0):
    ``pod-tf`` (the bench model, ``fuse_projections=True``: ``w_qkv`` and
    ``w_gate_up`` interleaved 2), ``pod-xt`` (Mixtral-8x7B's widths at
    MIXTRAL_LAYERS layers, fused: ``w_qkv`` interleaved, half of every
    expert's inner width a rank) and ``pod-et`` (Moonlight-16B-A3B, 27
    layers, MLA: unfused, the 8-head latent arms). The larger two are made
    on the card by each rank in turn. Held here: the ranks' tokens equal,
    and their routing (chosen experts, kept assignments) equal call for
    call."""
    import gc

    from llmd_kv_cache_tpu_torch.parallel.mesh import spawn_tp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"fused_products": fused_product_times(torch, smi),
           "fused_pods": fused_pod_turns(torch, ops, smi),
           "wrappers": tp_wrapper_parity(torch, ops, gen, shapes=(
               ("gqa_g4", KV_HEADS // TP, HEAD_DIM, FAMILY_Q_HEADS // TP),
               ("mla", 1, 576, TP_HEADS))),
           "latent_prefill_h8": latent_prefill_parity(torch, ops, gen, heads=TP_HEADS)}
    gc.collect()
    torch.cuda.empty_cache()
    refdir = tempfile.mkdtemp(prefix="chip-smoke-tp-moe-")
    try:
        specs, tp1 = [], {}
        for pod, kind, which, model_name, fuse in (
                ("pod-tf", "gqa", "gqa", "llama-0.9b-fused", True),
                ("pod-xt", "gqa", "mixtral", "mixtral-8x7b-8l-tp2", True),
                ("pod-et", "mla", "moonlight", "moonlight-16b-a3b-tp2", None)):
            t = time.perf_counter()
            model, params = tp_weights(torch, which)
            prompts = tp_moe_prompts(model.vocab_size)
            # The same model name: a block's hash chain starts from it.
            ref1, ref, exact = tp1_reference(torch, ops, model, params, prompts, f"{pod}-tp1",
                                             model_name)
            files = [os.path.join(refdir, f"{pod}-{k}.pt") for k in ("ref", "exact")]
            for f, x in zip(files, (ref, exact)):
                torch.save(x.cpu(), f)
            del model, params, ref, exact
            gc.collect()
            torch.cuda.empty_cache()
            tp1[pod] = {k: v for k, v in ref1.items() if k not in ("stored", "outputs")}
            tp1[pod]["wall_s"] = time.perf_counter() - t
            specs.append(dict(pod=pod, kind=kind, model=which, fuse=fuse, turns=which != "gqa",
                              chunk_files=files, model_name=model_name, smi=smi,
                              reference_pod=f"{pod}-tp1", stored=ref1["stored"],
                              tp1_outputs=ref1["outputs"], **prompts))
        out["tp1"] = tp1
        out["parent_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= TP else "gloo"
        devices = [f"cuda:{r}" for r in range(TP)] if backend == "nccl" else ["cuda:0"] * TP
        print(f"phase 16: tp {TP} over {backend} ({cards} card(s); ranks on {devices})",
              flush=True)
        ranks = spawn_tp(tp_rank, TP, backend=backend, devices=devices,
                         args=(dict(pods=specs),), timeout_s=900, collective_timeout_s=300)
    finally:
        shutil.rmtree(refdir, ignore_errors=True)
    pods = [spec["pod"] for spec in specs]
    for pod in pods:
        outs = [r[pod]["outputs"] for r in ranks]
        if any(o != outs[0] for o in outs):
            fail(f"{pod}: the ranks decoded different tokens")
        if "routing_digests" in ranks[0][pod]:
            digests = [r[pod]["routing_digests"] for r in ranks]
            if any(d != digests[0] for d in digests):
                bad = sum(a != b for a, b in zip(*digests))
                fail(f"{pod}: the ranks routed {bad} of {len(digests[0])} expert layer calls "
                     "differently")
            print(f"{pod}: the ranks' routing equal in all {len(digests[0])} expert layer calls "
                  f"({digests[0][0].split(':')[0]})", flush=True)
    out.update(backend=backend, devices=devices, ranks=[
        {p: {k: v for k, v in r[p].items() if k not in ("outputs", "routing_digests")}
         for p in pods} | {"allreduce_ms": r["allreduce_ms"]} for r in ranks])
    out["peak_memory_gib"] = {"parent": out["parent_peak_memory_gib"], "ranks": [
        {p: r[p]["peak_memory_gib"] for p in pods} for r in ranks]}
    out["wall_s"] = time.perf_counter() - t_phase
    rank0 = out["ranks"][0]
    line = {p: dict(
        ttft_cold_ms=rank0[p]["ttft_cold_ms"], ttft_warm_ms=rank0[p]["ttft_warm_ms"],
        decode_ms_per_step_b8=rank0[p]["decode_ms_per_step_b8"],
        tp1=dict(ttft_cold_ms=tp1[p]["ttft_cold_ms"], ttft_warm_ms=tp1[p]["ttft_warm_ms"],
                 decode_ms_per_step_b8=tp1[p]["decode_ms_per_step_b8"]),
        greedy_agreement_vs_tp1=rank0[p]["greedy_agreement_vs_tp1"],
        chunk_logits=rank0[p].get("chunk_logits"),
        moe_layer_rank=rank0[p].get("moe_layer_rank")) for p in pods}
    out["line"] = dict(pods=line, peak_memory_gib=out["peak_memory_gib"],
                       wall_s=out["wall_s"],
                       fused_products_card_says=out["fused_products"]["card_says"])
    print(f"phase 16: wall time {out['wall_s']:.1f} s; peak device memory "
          f"{out['peak_memory_gib']} GiB (torch.cuda.max_memory_allocated, each process)",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 17: observability on the card
# ---------------------------------------------------------------------------

# Phase 17's pods: the bench model on each scheduler, telemetry on.
TEL_PODS = (("pod-tel", {}), ("pod-telb", {"decode_burst": TAIL_SLOTS}),
            ("pod-telr", {"ragged_attention": True}))
TEL_REQUESTS = 10  # the cold prompt, the routed one, 8 warm ones
TEL_NEW_TOKENS = 16  # the routed and the warm prompts' tokens


class ScoreFeedback:
    """The prediction a request was routed on, duck-typed as the JAX
    package's ``services.indexer_service.ScoreFeedback`` (its fields)."""

    def __init__(self, predicted_blocks: float, scores: dict):
        self.predicted_blocks = predicted_blocks
        self.scores = dict(scores)
        self.residency = {}
        self.staleness_s = 0.0


def tel_histograms() -> dict:
    """Observation counts of the engine-telemetry histograms (process-wide:
    the pods share them, as JAX's do)."""
    from llmd_kv_cache_tpu_torch.metrics.collector import _BUCKET_HISTOGRAMS

    return {name.split("_")[2]: h.count for name, h in _BUCKET_HISTOGRAMS.items()
            if name.startswith("kvtpu_engine_")}


def tel_samples() -> dict:
    """Every sample of the engine's counter families, by (name, labels)."""
    from llmd_kv_cache_tpu_torch.metrics.collector import sample_values

    return sample_values(("kvtpu_engine_requests_total", "kvtpu_engine_decode_steps_total",
                          "kvtpu_engine_prefix_hit_blocks_total",
                          "kvtpu_engine_ragged_real_tokens_total",
                          "kvtpu_engine_ragged_padded_tokens_total"))


def tel_traffic(pod, tokens, prefix, traced, indexer, model_name) -> dict:
    """Phase 4's traffic on one pod: the cold 4160-token prompt A, the
    routed prompt B (the 4096-token prefix + 64) decoding to 16 tokens, then
    8 warm prompts to 16 tokens each, every step synchronized and timed.
    With ``traced``, B is scored inside a root span whose traceparent and
    the score's feedback go to ``enqueue``; a twin serves the same prompts
    (``tokens`` is then a replay of the pod's) untraced."""
    from llmd_kv_cache_tpu_torch.telemetry import tracer

    name = pod.cfg.pod_identifier
    steps = {"n": 0, "ms_b8": []}

    def step(timed=False):
        t = time.perf_counter()
        pod.step()
        torch_sync()
        steps["n"] += 1
        if timed:
            steps["ms_b8"].append((time.perf_counter() - t) * 1e3)

    a = pod.enqueue("A", prefix + tokens(64), max_new_tokens=1)
    while not a.done:
        step()
    prompt_b = prefix[:4096] + tokens(64)
    root = scores = None
    if traced:
        with tracer().span("llm_d.kv_cache.route", request_id="B") as root:
            scores = indexer.score_tokens(prompt_b, model_name, {name})
        b = pod.enqueue("B", prompt_b, max_new_tokens=TEL_NEW_TOKENS,
                        traceparent=root.traceparent,
                        feedback=ScoreFeedback(scores.get(name, 0.0), scores))
    else:
        b = pod.enqueue("B", prompt_b, max_new_tokens=TEL_NEW_TOKENS)
    while not b.done:
        step()
    batch = [pod.enqueue(f"D{i}", prefix[:4096] + tokens(64), max_new_tokens=TEL_NEW_TOKENS)
             for i in range(8)]
    while any(not r.done for r in batch):
        decoding = sum(1 for r in batch if r.prefill_pos is None and r.output and not r.done)
        step(timed=decoding == 8 and all(r.prefill_pos is None for r in batch))
    return dict(reqs=[a, b, *batch], outputs=[list(r.output) for r in (a, b, *batch)],
                root=root, scores=scores, steps=steps["n"], step_ms_b8=steps["ms_b8"])


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def decode_step_times(torch, pod, prompts, timed_steps) -> dict:
    """Per-step host ms (each ending in a sync) of ``timed_steps`` steps with
    8 rows decoding, and host ms per generated token over them; the rows are
    aborted after."""
    reqs = [pod.enqueue(f"TS{i}", p, max_new_tokens=128) for i, p in enumerate(prompts)]
    while any(r.prefill_pos is not None for r in reqs):
        pod.step()
    pod.step()  # the last row's first decode
    torch.cuda.synchronize()
    n0 = sum(len(r.output) for r in reqs)
    ms = []
    for _ in range(timed_steps):
        t = time.perf_counter()
        pod.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    n = sum(len(r.output) for r in reqs) - n0
    for r in reqs:
        pod.abort_request(r.request_id)
    return dict(step_ms=ms, p50_ms=sorted(ms)[len(ms) // 2], ms_per_token=sum(ms) / n)


def check_tel_spans(pod_name, exporter, cursor, run) -> dict:
    """One trace from score to serve: B's route, score_tokens, admission,
    prefill-chunk and decode-step spans share the root's trace id, every
    one the root's child; no other request made an engine span."""
    spans = [s for s in exporter.drain_since(cursor)[0] if s.end_time is not None]
    root = run["root"]
    trace = [s for s in spans if s.trace_id == root.trace_id]
    names: dict = {}
    for s in trace:
        names[s.name] = names.get(s.name, 0) + 1
    children = [s for s in trace if s.span_id != root.span_id]
    decode_tokens = sum(s.attributes.get("tokens", 0) for s in trace
                        if s.name == "llm_d.kv_cache.engine.decode_step")
    stray = sorted({s.attributes.get("request_id") for s in spans
                    if s.name.startswith("llm_d.kv_cache.engine.")
                    and s.attributes.get("request_id") != "B"})
    want = {"llm_d.kv_cache.route": 1, "llm_d.kv_cache.score_tokens": 1,
            "llm_d.kv_cache.engine.admission": 1, "llm_d.kv_cache.engine.prefill_chunk": 1}
    b = run["reqs"][1]
    print(f"{pod_name}: B's trace {root.trace_id:032x}: {names}; decode_step tokens "
          f"{decode_tokens}; engine spans of untraced requests: {stray}", flush=True)
    if (any(names.get(k) != n for k, n in want.items())
            or "llm_d.kv_cache.engine.decode_step" not in names
            or decode_tokens != len(b.output) - 1
            or root.parent_span_id is not None
            or any(s.parent_span_id != root.span_id for s in children)
            or any(s.attributes.get("process") != pod_name for s in children
                   if s.name.startswith("llm_d.kv_cache.engine."))
            or stray):
        fail(f"{pod_name}: the trace from score to serve is not whole: {names}, decode "
             f"tokens {decode_tokens}, parents "
             f"{sorted({s.parent_span_id == root.span_id for s in children})}, stray {stray}")
    return dict(spans=names, decode_step_tokens=decode_tokens, trace_spans=len(trace))


def check_tel_lifecycle(pod_name, pod, run, hist0, samples0) -> dict:
    """Histogram counts equal the requests and tokens served; each request's
    timestamps are monotone; the routed request hit 256 blocks."""
    hist = {k: n - hist0.get(k, 0) for k, n in tel_histograms().items()}
    samples = tel_samples()

    def delta(name, **labels):
        key = (name, tuple(sorted(labels.items())))
        return samples.get(key, 0.0) - samples0.get(key, 0.0)

    tokens = sum(len(o) for o in run["outputs"])
    multi = sum(1 for o in run["outputs"] if len(o) > 1)
    want = {"ttft": TEL_REQUESTS, "itl": tokens - TEL_REQUESTS, "tpot": multi,
            "decode": run["steps"]}
    finished = delta("kvtpu_engine_requests_total", outcome="finished")
    summaries = {s["request_id"]: s for s in pod.telemetry.finished}
    keys = ("enqueue_ts", "admit_ts", "first_token_ts", "last_token_ts", "finish_ts")
    monotone = all(all(summaries[r.request_id][a] <= summaries[r.request_id][b]
                       for a, b in zip(keys, keys[1:])) for r in run["reqs"])
    hit_b = summaries["B"]["prefix_hit_blocks"]
    real = delta("kvtpu_engine_ragged_real_tokens_total", group=pod_name)
    padded = delta("kvtpu_engine_ragged_padded_tokens_total", group=pod_name)
    print(f"{pod_name}: histogram counts {hist} (want {want}), {finished:.0f} finished, "
          f"timestamps monotone {monotone}, B's prefix_hit_blocks {hit_b}, dispatch "
          f"tokens real {real:.0f} / dispatched {padded:.0f}", flush=True)
    if hist != want or finished != TEL_REQUESTS or not monotone or hit_b != 256:
        fail(f"{pod_name}: lifecycle: histograms {hist} (want {want}), finished {finished}, "
             f"monotone {monotone}, B's prefix_hit_blocks {hit_b}")
    if pod.cfg.ragged_attention and real != padded:
        fail(f"{pod_name}: a ragged dispatch reported {padded} tokens for {real} real ones")
    return dict(histogram_counts=hist, finished=finished, prefix_hit_blocks_b=hit_b,
                dispatch_tokens={"real": real, "dispatched": padded},
                ttft_ms={r: round((summaries[r]["first_token_ts"]
                                   - summaries[r]["enqueue_ts"]) * 1e3, 3) for r in ("A", "B")})


def check_tel_gauges(pod_name, pod) -> dict:
    """The pool gauges (scraped every step here) equal ``pool_stats()``."""
    from llmd_kv_cache_tpu_torch.metrics import REGISTRY

    stats = pod.block_manager.pool_stats()
    gauges = {k: REGISTRY.get_sample_value(f"kvtpu_engine_kv_pool_{k}", {"group": "full"})
              for k in ("free_pages", "cached_blocks", "orphan_pages")}
    if any(gauges[k] != stats[k] for k in gauges) or pod.telemetry.debug_vars()["pool"][
            "full"] != stats:
        fail(f"{pod_name}: pool gauges {gauges} != pool_stats() {stats}")
    return gauges


def check_tel_records(pod_name, recs) -> dict:
    """The flight records of one pod's counted run: one score decision, an
    admit and a finish per request (B's admit with 256 hit blocks), and an
    audit outcome per request."""
    from llmd_kv_cache_tpu_torch.telemetry.flight_recorder import (
        KIND_AUDIT,
        KIND_ENGINE_REQUEST,
        KIND_SCORE,
    )

    kinds: dict = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    admit_b = [r["data"] for r in recs if r["kind"] == KIND_ENGINE_REQUEST
               and r["data"]["request_id"] == "B" and r["data"]["phase"] == "admit"]
    want = {KIND_SCORE: 1, KIND_ENGINE_REQUEST: 2 * TEL_REQUESTS, KIND_AUDIT: TEL_REQUESTS}
    if ({k: kinds.get(k, 0) for k in want} != want
            or [d["prefix_hit_blocks"] for d in admit_b] != [256]):
        fail(f"{pod_name}: flight records {kinds} (want {want}), B's admit {admit_b}")
    return kinds


def tel_capture(torch, pods, tokens, prefixes) -> dict:
    """A ~1 s ProfilerCapture on a thread of its own while ``pod-telb`` and
    ``pod-tel`` decode on this one; a second capture during it must raise
    ProfileInProgress; the Chrome trace must name the decode kernel."""
    import threading

    from llmd_kv_cache_tpu_torch.telemetry import ProfileInProgress

    prof = pods["pod-telb"].telemetry.profiler
    reqs = {}
    waves = {"pod-tel": 0, "pod-telb": 0}

    def wave(p):
        """8 rows over a cached 1024-token prefix, prefilled. Rows are
        renewed until the capture ends: its start (Kineto's set-up) may
        take seconds, and the rows must still be decoding when it records."""
        waves[p] += 1
        reqs[p] = [pods[p].enqueue(f"PC{waves[p]}-{i}", prefixes[p][:1024] + tokens(64),
                                   max_new_tokens=256) for i in range(8)]
        while any(r.prefill_pos is not None for r in reqs[p]):
            pods[p].step()

    for p in ("pod-tel", "pod-telb"):
        wave(p)
    torch.cuda.synchronize()
    # One step profiled on this thread first: the process's first
    # torch.profiler session then belongs to the serving thread, as
    # chip_smoke's later sessions do (a capture thread's first session
    # leaves Kineto's client on that thread).
    window = profile_window(torch, pods["pod-tel"].step)
    result, errors = {}, []

    def capture():
        try:
            result.update(prof.capture(1.0))
        except Exception as exc:  # reported below
            errors.append(exc)

    th = threading.Thread(target=capture, name="profiler-capture")
    th.start()
    deadline = time.monotonic() + 5.0
    while not prof._lock.locked() and th.is_alive() and time.monotonic() < deadline:
        time.sleep(0.001)
    second = "no error"
    try:
        prof.capture(0.5)
    except ProfileInProgress as exc:
        second = f"ProfileInProgress: {exc}"
    except Exception as exc:
        second = f"{type(exc).__name__}: {exc}"
    steps = {"pod-tel": 0, "pod-telb": 0}
    while th.is_alive():
        for p in ("pod-tel", "pod-telb"):
            if all(r.done for r in reqs[p]):
                wave(p)
            pods[p].step()
            steps[p] += 1
    th.join()
    torch.cuda.synchronize()
    for p in reqs:
        for r in reqs[p]:
            pods[p].abort_request(r.request_id)
    if errors or not second.startswith("ProfileInProgress"):
        fail(f"profiler capture: errors {errors}, second capture {second}")
    with open(result["trace"]) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    decode = [k for k in kernels if "decode_kernel" in k]
    cpu_ops = sum(1 for e in events if e.get("cat") == "cpu_op")
    print(f"profiler capture: {result['trace']} ({os.path.getsize(result['trace'])} bytes, "
          f"{len(events)} events): {len(kernels)} kernels, {len(decode)} named decode_kernel, "
          f"{cpu_ops} CPU operators (the serving thread's are not collected); second "
          f"capture: {second}; steps during it {steps}, waves of 8 rows {waves}", flush=True)
    if not decode:
        fail(f"the profiler capture named no decode kernel ({len(kernels)} kernels: "
             f"{sorted(set(kernels))[:8]})")
    return dict(profile_one_step=window,
                trace_bytes=os.path.getsize(result["trace"]), kernel_events=len(kernels),
                decode_kernel_events=len(decode), cpu_op_events=cpu_ops,
                second_capture=second.split(":")[0], steps=steps, waves=waves,
                duration_s=result["duration_s"],
                wall_s=result["completed_ts"] - result["started_ts"])


def tel_hook_cost(pod, step_p50_ms: dict) -> dict:
    """JAX's analytic gate (``bench.py:1051-1084``): ``on_step`` (with its
    1-in-16 pool scrape) plus 8 rows' ``on_decode_tokens``, timed on this
    host, against the card's decode-step p50 with telemetry off, for a
    single step (one token a row) and a burst step (8 tokens a row)."""
    from llmd_kv_cache_tpu_torch.telemetry import EngineTelemetry, EngineTelemetryConfig

    tel = EngineTelemetry(EngineTelemetryConfig())
    pools = [("full", pod.block_manager)]
    n = 20_000
    t = time.perf_counter_ns()
    for _ in range(n):
        tel.on_step(1e-3, True, pools)
    ns_step = (time.perf_counter_ns() - t) / n
    tel.on_admitted("r0", 0)
    tel.on_first_token("r0")
    now = time.monotonic()
    ns_decode = {}
    for k in (1, TAIL_SLOTS):
        t = time.perf_counter_ns()
        for i in range(n):
            tel.on_decode_tokens("r0", k, now + i * 1e-3)
        ns_decode[k] = (time.perf_counter_ns() - t) / n
    out = {}
    for kind, k in (("single", 1), ("burst", TAIL_SLOTS)):
        hook_ns = ns_step + 8 * ns_decode[k]
        out[kind] = dict(hook_ns=round(hook_ns, 1), step_p50_off_ms=step_p50_ms[kind],
                         share_pct=100.0 * hook_ns / (step_p50_ms[kind] * 1e6))
    print(f"hook cost: on_step {ns_step:.0f} ns, on_decode_tokens {ns_decode[1]:.0f} ns (1 "
          f"token) / {ns_decode[TAIL_SLOTS]:.0f} ns ({TAIL_SLOTS}); share of the decode-step "
          f"p50 {json.dumps({k: round(v['share_pct'], 5) for k, v in out.items()})} %",
          flush=True)
    if any(v["share_pct"] >= 1.0 for v in out.values()):
        fail(f"engine telemetry hooks cost >= 1% of a decode step: {out}")
    return dict(on_step_ns=ns_step, on_decode_tokens_ns=ns_decode, **out)


def telemetry_path(torch, ops) -> dict:
    """Phase 17: ``pod-tel`` (padded), ``pod-telb`` (bursts of 8) and
    ``pod-telr`` (ragged), the bench model at full width with telemetry on,
    sharing one Indexer with an AuditLog and a WorkingSetTracker attached,
    one recording span exporter installed; each beside a twin with
    ``telemetry=None`` on the same weights and prompts."""
    from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
    from llmd_kv_cache_tpu_torch.events.model import EventBatch
    from llmd_kv_cache_tpu_torch.events.pool import Pool
    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import init_params
    from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig
    from llmd_kv_cache_tpu_torch.telemetry import (
        AuditJoiner,
        AuditLog,
        EngineTelemetryConfig,
        InMemorySpanExporter,
        WorkingSetConfig,
        WorkingSetTracker,
        flight_recorder,
        install_span_exporter,
        uninstall_span_exporter,
    )

    t_phase = time.perf_counter()
    model = gqa_model()
    params = init_params(model, seed=0, device="cuda")
    profile_dir = tempfile.mkdtemp(prefix="kvtpu-profile-")
    model_name = "llama-0.9b-telemetry"
    indexer = Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
        block_size_tokens=model.page_size)))
    pool = Pool(indexer.kv_block_index, indexer.token_processor)
    pool.ledger = indexer.ledger
    audit = AuditLog()
    workingset = WorkingSetTracker(WorkingSetConfig(enabled=True))
    indexer.attach_audit(audit)
    indexer.attach_workingset(workingset)
    exporter = install_span_exporter(InMemorySpanExporter(max_spans=100_000))
    recorder = flight_recorder()
    rng = torch.Generator().manual_seed(17)

    def tokens(n):
        return torch.randint(1, model.vocab_size, (n,), generator=rng).tolist()

    def make(pod_name, telemetry, **cfg_kw):
        def sink(evs):
            pool.process_event_batch(EventBatch(timestamp=time.time(), events=evs),
                                     pod_name, model_name)

        eng = MiniEngine(
            EngineConfig(model=model, num_pages=1024, max_pages_per_seq=272,
                         max_prefill_tokens=2048, model_name=model_name,
                         pod_identifier=pod_name,
                         # Gauges scraped every step: after the traffic they
                         # must equal pool_stats().
                         telemetry=EngineTelemetryConfig(profile_dir=profile_dir,
                                                         pool_gauge_every=1)
                         if telemetry else None, **cfg_kw),
            event_sink=sink if telemetry else None, params=params, device="cuda")
        if telemetry:
            eng.attach_audit(audit)
            eng.attach_workingset(workingset)
        return eng

    pods, twins, prefixes, out = {}, {}, {}, {"pods": {}}
    for pod_name, cfg_kw in TEL_PODS:
        pod, twin = make(pod_name, True, **cfg_kw), make(pod_name, False, **cfg_kw)
        pods[pod_name], twins[pod_name] = pod, twin
        prefix = prefixes[pod_name] = tokens(4096)
        warm = tokens(2048 + 64)
        for eng in (pod, twin):  # first launches, a burst pod's graph capture
            eng.generate("W", warm, max_new_tokens=2)
        replays = (record_calls(pod._burst_graph, "replay")
                   if pod._burst_graph is not None else None)
        counted = {name: record_calls(pod, name) for name in
                   ("_prefill_chunk", "_decode_chunk", "_decode_chunk_burst",
                    "_ragged_dispatch")}
        drawn = []

        def recorded(n):
            drawn.append(tokens(n))
            return drawn[-1]

        # --- phase 17's path on this pod: counters zeroed just before, read
        # just after ---
        hist0, samples0 = tel_histograms(), tel_samples()
        span_cursor = exporter.next_seq - 1
        rec_cursor = recorder.export_since(-1)["next_seq"]
        audit_cursor = audit.export_since(-1)["next_seq"]
        plain = PlainCalls()
        zero_launches(ops)
        for log in (*counted.values(), *([replays] if replays is not None else [])):
            log.clear()
        run = tel_traffic(pod, recorded, prefix, True, indexer, model_name)
        torch.cuda.synchronize()
        launches = read_launches(ops)
        plain.stop()
        calls = {k[1:]: len(v) for k, v in counted.items()}
        # --- end of phase 17's path on this pod ---

        layers = model.num_layers
        want = {"cuda_paged_prefill_attention": layers * calls["prefill_chunk"],
                "cuda_paged_decode_attention": layers * (
                    calls["decode_chunk"] + TAIL_SLOTS * calls["decode_chunk_burst"]),
                "cuda_paged_ragged_attention": layers * calls["ragged_dispatch"]}
        print(f"{pod_name}: {calls}, launches {launches}, {plain.calls} plain calls"
              + (f", {len(replays)} graph replays" if replays is not None else ""),
              flush=True)
        if (any(launches[fn] != n for fn, n in want.items()) or sum(want.values()) == 0
                or launches["cuda_paged_latent_decode_attention"]
                or launches["cuda_paged_latent_prefill_attention"] or plain.calls):
            fail(f"{pod_name}: launches {launches}, want {want}, plain calls {plain.calls}")
        if replays is not None and (len(replays) != calls["decode_chunk_burst"]
                                    or not replays):
            fail(f"{pod_name}: {len(replays)} graph replays for "
                 f"{calls['decode_chunk_burst']} bursts")
        scores = run["scores"]
        if scores.get(pod_name) != 256 or run["reqs"][1].cached_len != 4096:
            fail(f"{pod_name}: routing {scores}, cached_len {run['reqs'][1].cached_len}")
        res = dict(calls=calls, launches={k: v for k, v in launches.items() if v},
                   graph_replays=None if replays is None else len(replays),
                   routing=scores, step_ms_b8=run["step_ms_b8"])
        res["gauges"] = check_tel_gauges(pod_name, pod)
        res["lifecycle"] = check_tel_lifecycle(pod_name, pod, run, hist0, samples0)
        res["spans"] = check_tel_spans(pod_name, exporter, span_cursor, run)
        res["flight_records"] = check_tel_records(
            pod_name, recorder.export_since(rec_cursor)["records"])
        # The audit: B's outcome (HBM 256 blocks) joins its prediction.
        records = audit.export_since(audit_cursor)["records"]
        trace_id = f"{run['root'].trace_id:032x}"
        outcome_b = [r for r in records if r["kind"] == "outcome" and r["request_id"] == "B"]
        preds = [r for r in records if r["kind"] == "prediction" and r["trace_id"] == trace_id]
        joiner = AuditJoiner()
        joins = joiner.ingest(records)
        if (len(outcome_b) != 1 or outcome_b[0]["hbm_blocks"] != 256
                or outcome_b[0]["trace_id"] != trace_id or len(preds) != 1 or joins != 1
                or joiner.view()["pods"].get(pod_name, {}).get("joins") != 1):
            fail(f"{pod_name}: audit: outcome {outcome_b}, predictions {preds}, "
                 f"{joins} joins, {joiner.view()}")
        res["audit"] = dict(hbm_blocks=outcome_b[0]["hbm_blocks"], joins=joins,
                            records=len(records), joiner=joiner.view()["pods"][pod_name])
        # No change in output: the twin, telemetry off, on the same prompts.
        replay_tokens = iter(drawn)
        twin_run = tel_traffic(twin, lambda n: next(replay_tokens), prefix, False, None,
                               model_name)
        if twin_run["outputs"] != run["outputs"]:
            fail(f"{pod_name}: tokens with telemetry on differ from the twin's with it off")
        print(f"{pod_name}: tokens equal the twin's with telemetry off "
              f"({sum(len(o) for o in run['outputs'])} tokens)", flush=True)
        res["tokens_equal_twin"] = True
        out["pods"][pod_name] = res

    # Step p50s and host ms a token, telemetry on and off, in turns.
    turns: dict = {}
    for pod_name, _ in TEL_PODS:
        timed = 4 if pods[pod_name]._burst > 1 else 16
        for label, eng in (("on", pods[pod_name]), ("off", twins[pod_name]),
                           ("off", twins[pod_name]), ("on", pods[pod_name])):
            r = decode_step_times(torch, eng, [prefixes[pod_name][:4096] + tokens(64)
                                               for _ in range(8)], timed)
            turns.setdefault(pod_name, {}).setdefault(label, []).append(r)
    out["turns"] = {p: {label: {"p50_ms": [r["p50_ms"] for r in rs],
                                "ms_per_token": [r["ms_per_token"] for r in rs]}
                        for label, rs in t.items()} for p, t in turns.items()}
    print(f"decode step p50 ms / host ms a token, telemetry on and off in turns: "
          f"{json.dumps(out['turns'])}", flush=True)
    twins.clear()
    torch.cuda.empty_cache()

    out["capture"] = tel_capture(torch, pods, tokens, prefixes)
    p50 = {"single": min(min(r["p50_ms"] for r in turns["pod-tel"]["off"]),
                         min(r["p50_ms"] for r in turns["pod-telr"]["off"])),
           "burst": min(r["p50_ms"] for r in turns["pod-telb"]["off"])}
    out["hook_cost"] = tel_hook_cost(pods["pod-tel"], p50)
    out["workingset"] = workingset.debug_view()
    out["ledger"] = {p: indexer.ledger.snapshot()["pods"].get(p) for p in pods}
    uninstall_span_exporter()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 17: wall time {out['wall_s']:.1f} s", flush=True)
    shutil.rmtree(profile_dir, ignore_errors=True)
    return out


def sass_hgmma(lib_path) -> dict:
    """wgmma instructions (HGMMA in the SASS, ``cuobjdump -sass``) of each
    kernel of the built library, by "name<head_dim, group[, flags]>" (the
    GQA prefill's and ragged kernel's last flag: an fp8 pool; the ragged
    kernels' tail flag before it)."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"(latent_prefill|latent_decode|latent_ragged|latent_combine|"
                              r"split_combine|ragged|decode|prefill)_kernelILi(\d+)ELi(\d+)E"
                              r"((?:Lb\dE)*)", line)
            # Boolean template arguments (a tail, an fp8 pool) follow.
            flags = "".join(f", {b}" for b in re.findall(r"Lb(\d)E", found[4])) if found else ""
            name = f"{found[1]}<{found[2]}, {found[3]}{flags}>" if found else None
            if name:
                counts.setdefault(name, 0)
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def kernel_times(torch, ops) -> dict:
    """The GQA and redesigned kernels' times at their main-path shapes (the
    GQA decode at b 8 over ctx 4160 with and without an 8-token tail, the
    GQA prefill at S 2048 over ctx 2048, the latent decode at b 8 over ctx
    4160 at D 576 with and without an 8-token tail, the latent prefill's
    LATENT_PREFILL_TIMED at D 576, the GQA ragged kernel's RAGGED_TIMED over
    bf16 and fp8 pools and the latent ragged kernel's LATENT_RAGGED_TIMED,
    by kernel, with their plans where the checkout has a planner; the GQA
    decode and prefill at group 4, unwindowed and at windows 4096 and
    1024), each launch checked against its plain version first, and one
    decode step's
    logits against the fp32 forward (``decode_logits_vs_fp32``).
    ``--kernel-times`` runs only this, so that two checkouts can be timed
    in turns on one card."""
    from llmd_kv_cache_tpu_torch.models.llama import init_params
    from llmd_kv_cache_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_ragged_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {"decode b8 ctx4160": decode_timing(torch, ops, gen, 0),
             f"decode b8 ctx4160 + tail {TAIL_SLOTS}": decode_timing(
                 torch, ops, gen, TAIL_SLOTS),
             "prefill s2048 ctx2048": prefill_timing(torch, ops, gen),
             "latent decode b8 ctx4160 d576": latent_decode_b8_timing(torch, ops, gen, 0),
             f"latent decode b8 ctx4160 d576 + tail {TAIL_SLOTS}": latent_decode_b8_timing(
                 torch, ops, gen, TAIL_SLOTS)}
    k = latent_pool(torch, gen, 273, 576)
    table = page_table_for(torch, gen, [4160], 273)
    for ctx_len, seq in LATENT_PREFILL_TIMED:
        q = torch.randn(1, seq, MLA_HEADS, 576, generator=gen,
                        device="cuda").to(torch.bfloat16)
        ctx = torch.tensor([ctx_len], dtype=torch.int32, device="cuda")
        positions = ctx[:, None] + torch.arange(seq, device="cuda")[None]

        def kernel(q=q, ctx=ctx):
            return ops.cuda_paged_latent_prefill_attention(q, k, table, ctx, ctx + seq)

        def plain(q=q, ctx=ctx, positions=positions):
            return paged_attention(q, k, k, table, positions, ctx + seq)

        check_close(f"latent prefill s{seq} ctx{ctx_len}", kernel()[0], plain()[0])
        times[f"latent prefill s{seq} ctx{ctx_len}"] = latent_prefill_timing(
            torch, kernel, plain, ctx_len, seq, 576, q, table)
    # The ragged kernels at every timed shape, GQA over bf16 and fp8 pools
    # and latent, by kernel (a checkout's wrapper may launch more than its
    # kernels: nothing is held but parity), the plain versions untimed.
    for fp8 in (False, True):
        for name, (q_lens, ctx_l) in RAGGED_TIMED.items():
            inputs = ragged_inputs(torch, gen, q_lens, ctx_l, fp8=fp8)

            def kernel(inputs=inputs):
                return ops.cuda_paged_ragged_attention(*inputs)

            def plain(inputs=inputs):
                return paged_ragged_attention(*inputs)

            q, k, v, tab, starts, ctx = inputs
            check_ragged(torch, f"{kv_tag(fp8)}ragged {name}", kernel(), plain(), q_lens)
            times[f"{kv_tag(fp8)}ragged {name}"] = ragged_timing(
                torch, ops, kernel, plain, name, (q, k, v, tab, starts, ctx), q_lens, ctx_l,
                fp8, hold=False, plain_iters=0)
    for name, (q_lens, ctx_l) in LATENT_RAGGED_TIMED.items():
        q, k, tab, starts, ctx = latent_ragged_inputs(torch, gen, q_lens, ctx_l, 576)

        def kernel(q=q, k=k, tab=tab, starts=starts, ctx=ctx):
            return ops.cuda_paged_ragged_attention(q, k, None, tab, starts, ctx,
                                                   shared_kv=True)

        def plain(q=q, k=k, tab=tab, starts=starts, ctx=ctx):
            return paged_ragged_attention(q, k, None, tab, starts, ctx, shared_kv=True)

        check_ragged(torch, f"latent ragged {name}", kernel(), plain(), q_lens)
        times[f"latent ragged {name}"] = latent_ragged_timing(
            torch, ops, kernel, plain, name, (q, k, tab, starts, ctx), q_lens, ctx_l, 576,
            hold=False, plain_iters=0)
    times.update(g4_times(torch, ops, gen))
    model = gqa_model()
    times["decode step logits vs fp32"] = decode_logits_vs_fp32(
        torch, model, init_params(model, seed=0, device="cuda"))
    return times


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
    # --kernel-times [--root DIR]: only the redesigned kernels' times, with
    # the port package of the checkout at DIR (default: beside this script).
    only_times = "--kernel-times" in sys.argv
    if "--root" in sys.argv:
        sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1])
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
    if only_times:
        print(json.dumps({"kernel_times": kernel_times(torch, ops), "package": ops.__file__,
                          "card": smi}), flush=True)
        return 0
    if "--families" in sys.argv:  # phase 13 alone: a development shortcut
        fam = families_path(torch, ops, torch.Generator(device="cuda").manual_seed(0))
        print(json.dumps({"families": {**fam, "card": smi}}), flush=True)
        return 0
    if "--moe" in sys.argv:  # phase 15 alone: a development shortcut
        print(json.dumps({"moe": {**moe_path(torch, ops, smi), "card": smi}}), flush=True)
        return 0
    if "--telemetry" in sys.argv:  # phase 17 alone: a development shortcut
        print(json.dumps({"telemetry": {**telemetry_path(torch, ops), "card": smi}},
                         default=str), flush=True)
        return 0
    if "--tp-moe" in sys.argv:  # phase 16 alone: a development shortcut
        tpm = tp_moe_path(torch, ops, torch.Generator(device="cuda").manual_seed(0), smi)
        print(json.dumps({"tp_moe": {**tpm["line"], "card": smi}}), flush=True)
        print(json.dumps({"tp_moe_detail": {**tpm, "card": smi}}, default=str), flush=True)
        return 0
    kernel = None
    spills = {}
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        found = re.search(r"((?:latent_)?(?:decode|prefill|ragged))_kernelILi(\d+)ELi(\d+)E"
                          r"((?:Lb\dE)*)", line)
        if "Compiling entry" in line:
            # Other kernels (the combine passes) reset it, so their report
            # is not taken for the kernel compiled before them. Boolean
            # template arguments (shared_kv, tail) follow the group.
            flags = "".join(f", {b}" for b in re.findall(r"Lb(\d)E", found[4])) if found else ""
            kernel = (f"{found[1]}<head_dim {found[2]}, group {found[3]}{flags}>"
                      if found else None)
        elif kernel and ("registers" in line or "spill" in line):
            print(f"ptxas {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found:
                spills[kernel] = int(found[1]) + int(found[2])
    # The wgmma tiles hold their accumulators in registers (160 fp32 a
    # thread in the latent prefill); a spill would put them in local memory.
    # The GQA prefill comes in bf16 and fp8 (the last template flag)
    # instantiations, 16; the ragged kernel also with and without the burst
    # tail, 32; the latent ragged kernel (both latent tiles in one kernel)
    # at widths 576 and 640 with and without the tail, 4; the latent prefill
    # at both widths with 16 heads and a tp 2 rank's 8, 4.
    wide = {k: n for k, n in spills.items()
            if k.startswith(("latent_prefill", "latent_ragged", "ragged", "prefill"))}
    if len(wide) != 56 or any(wide.values()):
        fail(f"ptxas: latent prefill, latent ragged, prefill or ragged kernels missing or "
             f"spilling: {wide}")
    # The GQA decode: 8 shapes, with and without the burst tail, bf16 and fp8.
    gqa_dec = {k: n for k, n in spills.items() if k.startswith("decode")}
    if len(gqa_dec) != 32 or any(gqa_dec.values()):
        fail(f"ptxas: GQA decode kernels missing or spilling: {gqa_dec}")
    # The latent decode holds a quarter of Q's fragments and of O's
    # accumulators a thread (36 + 72 registers at width 576): every
    # instantiation (6 shapes, the two 8-head latent ones a tp 2 rank's,
    # with and without the burst tail) unspilled.
    latent_dec = {k: n for k, n in spills.items() if k.startswith("latent_decode")}
    if len(latent_dec) != 12 or any(latent_dec.values()):
        fail(f"ptxas: latent decode kernels missing or spilling: {latent_dec}")
    # The wgmma kernels must run on wgmma: their SASS holds HGMMA.
    counts = sass_hgmma(lib_path)
    print(f"sass HGMMA instructions per kernel: {json.dumps(counts)}", flush=True)
    hgmma = {kind: {k: n for k, n in counts.items() if k.startswith(kind + "<")}
             for kind in ("latent_prefill", "ragged", "prefill", "latent_ragged")}
    if [len(g) for g in hgmma.values()] != [4, 32, 16, 4] or not all(
            n > 0 for group in hgmma.values() for n in group.values()):
        fail(f"the latent prefill, ragged, prefill and latent ragged kernels must each hold "
             f"HGMMA: {hgmma}")

    # 17. Observability, first: pod-tel / pod-telb / pod-telr (the bench
    # model on each scheduler, telemetry on) beside twins with it off; one
    # trace from score to serve, lifecycle histograms, pool gauges, audit,
    # flight records, a torch.profiler capture, the hooks' cost. It runs
    # before any scheduled profiler session (device_ms): a capture after one
    # recorded no kernel on an H100 (PERF.md §6).
    tel = telemetry_path(torch, ops)
    release_memory(torch)

    # 3. Kernel parity
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = decode_parity(torch, ops, gen)
    pre = prefill_parity(torch, ops, gen)
    rag = ragged_parity(torch, ops, gen)
    lat_dec = latent_decode_parity(torch, ops, gen)
    lat_pre = latent_prefill_parity(torch, ops, gen)
    dec_tail = decode_tail_parity(torch, ops, gen)
    lat_tail = latent_tail_parity(torch, ops, gen)
    # The ragged kernel's last two arms: shared_kv (the latent ragged
    # kernel) and the burst tail (GQA bf16 and fp8, latent).
    lat_rag = latent_ragged_parity(torch, ops, gen)
    rag_tail = {arm: ragged_tail_parity(torch, ops, gen, arm)
                for arm in ("bf16", "fp8", "latent")}
    # Phase 10's kernels: the fp8 arms against the plain version, timed.
    f8_arms = fp8_arms(torch, ops, gen)

    # 4. Main path
    run, fleet = main_path(torch, ops)

    # 6. The ragged path: pod-r, one mixed dispatch's logits, and the mixed
    # and decode steps beside the padded pod's (same traffic, fresh prompts).
    rpath = ragged_path(torch, ops, fleet)
    ragged_logits_err = ragged_logits_parity(torch, fleet["model"], fleet["params"])
    # Queue C.2: the padded and the ragged decode paths against fp32.
    to_fp32 = decode_logits_vs_fp32(torch, fleet["model"], fleet["params"])
    tokens, prefix = fleet["tokens"], fleet["prefix"]
    steps = {"pod-0": [], "pod-r": []}
    for pod in ("pod-0", "pod-r", "pod-r", "pod-0"):  # in turns
        steps[pod].append(mixed_step_timing(
            torch, fleet["engines"][pod], [prefix + tokens(64) for _ in range(8)],
            tokens(4160)))

    # 7. The absorbed-MLA path: pod-m, and its logits through the kernels.
    mpath = mla_path(torch, ops, fleet)

    # 8. Fused decode bursts: pod-b (the GQA model) and pod-mb (the MLA
    # model), their captured bursts against eager ones, one tick's logits,
    # and host ms per token beside the single-step pods, in turns.
    engines = fleet["engines"]
    bpath = burst_path(torch, ops, fleet, "pod-b", fleet["model"], fleet["params"],
                       fleet["model_name"], prefix, fleet["batch_prompts"],
                       fleet["batch_outputs"])
    mbpath = burst_path(torch, ops, fleet, "pod-mb", mpath["model"], mpath["params"],
                        mpath["model_name"], mpath["prefix"], mpath["batch_prompts"],
                        mpath["batch_outputs"])
    tick = {"gqa": burst_tick_logits_parity(torch, fleet["model"], fleet["params"]),
            "mla": burst_tick_logits_parity(torch, mpath["model"], mpath["params"])}
    per_token = {p: [] for p in ("pod-0", "pod-b", "pod-m", "pod-mb")}
    for pod in ("pod-0", "pod-b", "pod-b", "pod-0", "pod-m", "pod-mb", "pod-mb", "pod-m"):
        pfx = mpath["prefix"] if pod in ("pod-m", "pod-mb") else prefix
        per_token[pod].append(decode_token_ms(
            torch, engines[pod], [pfx + tokens(64) for _ in range(8)],
            timed_steps=2 if engines[pod]._burst > 1 else 16,
            profile=not per_token[pod]))
    print(f"host ms per generated token at batch 8: "
          f"{ {p: [r['ms_per_token'] for r in runs] for p, runs in per_token.items()} }",
          flush=True)

    # 9. The offload path: write-through and restore of paged KV through a
    # shared store, pod-o/pod-o2/pod-o3 (GQA) and pod-mo/pod-mo2 (MLA).
    opath = offload_path(torch, ops, fleet, mpath)

    # 10. fp8 KV pools: the fp8 arms' parity, pod-f / pod-fr / pod-fb, the
    # fp8 store's round trip (pod-fo -> pod-fo2), logits.
    f8 = fp8_path(torch, ops, fleet, f8_arms)
    f8_pods = f8["pods"]

    # 11. Absorbed MLA on the ragged scheduler: pod-mr beside pod-m.
    mrpath = mla_ragged_path(torch, ops, fleet, mpath)

    # 12. Disaggregated serving: pod-p streams chunk commits to pod-d through
    # a shared store; prefill death with fallback; pod-d2's deadline gate.
    dpath = disagg_path(torch, ops, fleet)

    # 13. The model families at public widths: the earlier phases' pods and
    # weights freed first; the GQA kernels at group 4 with and without
    # windows; Mistral-7B (pod-w, pod-wr, pod-ws), the hybrid stand-in
    # (pod-h, pod-hb, pod-ho -> pod-ho2) and Qwen3-8B (pod-q).
    tp_reference = {"gqa": fleet["tp_reference"], "mla": mpath["tp_reference"]}
    release_memory(torch, fleet, run, rpath, mpath, bpath, mbpath, opath, f8, mrpath, dpath)
    print(f"phase 13: device memory after freeing the earlier phases "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    fam = families_path(torch, ops, gen)
    fam_pods, g4, g4_err = fam["pods"], fam["g4"], fam["g4_parity"]

    # 14. Tensor-parallel serving at tp 2: the latent kernels' 8-head arms
    # and both sharded wrappers at a rank's shapes; pod-t and pod-mt on two
    # ranks (spawned) with pod-0's and pod-m's traffic.
    release_memory(torch)
    tp = tp_path(torch, ops, gen, tp_reference)
    tp_rank0 = tp["ranks"][0]
    tp_h8_dec, tp_h8_pre, tp_wrap = (tp["latent_decode_h8"], tp["latent_prefill_h8"],
                                     tp["wrappers"])

    # 15. Mixture-of-experts serving: the MoE layer of each router on the
    # card against the CPU; Moonlight-16B-A3B (pod-e, pod-eb, pod-er) and
    # Mixtral-8x7B's widths at 8 layers (pod-x, pod-xr).
    release_memory(torch)
    moe = moe_path(torch, ops, smi)
    moe_pods = moe["pods"]

    # 16. Fused projections and tp over fused and expert layers: fused vs
    # unfused products and pods timed; pod-tf (the bench model fused at tp
    # 2), pod-xt (Mixtral's widths, fused, experts split) and pod-et
    # (Moonlight-16B-A3B) on two ranks, each against its tp 1 pod.
    release_memory(torch)
    tpm = tp_moe_path(torch, ops, gen, smi)
    tpm_rank0 = tpm["ranks"][0]
    tpm_pods = ("pod-tf", "pod-xt", "pod-et")

    def tel_launches(fn):
        return {p: r["launches"][fn] for p, r in tel["pods"].items() if fn in r["launches"]}

    def moe_launches(*fns):
        return {p: {fn: r["launches"][fn] for fn in fns if fn in r["launches"]}
                for p, r in moe_pods.items() if isinstance(r.get("launches"), dict)
                and any(fn in r["launches"] for fn in fns)}

    def fam_launches(fn):
        return {p: r["launches"][fn] for p, r in fam_pods.items()
                if isinstance(r.get("launches"), dict) and fn in r["launches"]}

    # A kernel's wgmma counts by flavour: the last template flag is an fp8 pool.
    by_kv = {kind: {fl: {k: n for k, n in g.items() if k.endswith(f", {int(fl == 'fp8')}>")}
                    for fl in ("bf16", "fp8")}
             for kind, g in hgmma.items() if kind in ("ragged", "prefill")}

    # 5. Report
    kernels = [
        dict(name="paged_decode", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/paged_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:375",
             launches=run["launches"]["decode"], max_abs_err=dec["max_abs_err"],
             ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
             bound_by=dec["bound_by"], library_ms=None, splits=dec["splits"],
             events_ms=dec["events_ms"], sdpa_contiguous_ms=dec["sdpa_contiguous_ms"],
             families_launches=fam_launches("cuda_paged_decode_attention"),
             moe_launches=moe_launches("cuda_paged_decode_attention"),
             g4={k: v for k, v in g4.items() if k.startswith("decode")},
             g4_max_abs_err={"decode": g4_err["decode"], "tail": g4_err["decode_tail"]},
             telemetry_launches=tel_launches("cuda_paged_decode_attention"),
             **tail_fields(dec_tail, bpath["launches"])),
        dict(name="paged_prefill", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/paged_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:597",
             launches=run["launches"]["prefill"], max_abs_err=pre["max_abs_err"],
             ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
             bound_by=pre["bound_by"], library_ms=None, events_ms=pre["events_ms"],
             sdpa_contiguous_ms=pre["sdpa_contiguous_ms"], hgmma=by_kv["prefill"]["bf16"],
             families_launches=fam_launches("cuda_paged_prefill_attention"),
             moe_launches=moe_launches("cuda_paged_prefill_attention"),
             g4={k: v for k, v in g4.items() if k.startswith("prefill")},
             g4_max_abs_err=g4_err["prefill"],
             telemetry_launches=tel_launches("cuda_paged_prefill_attention")),
        dict(name="paged_ragged", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/paged_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:736",
             launches=rpath["launches"]["ragged"], max_abs_err=rag["max_abs_err"],
             ms=rag["ms"], plain_ms=rag["plain_ms"], bound_ms=rag["bound_ms"],
             bound_by=rag["bound_by"], library_ms=None,
             launches_by_shape=rpath["launches_by_shape"], decode_only=rag["decode_only"],
             shapes=brief(rag["shapes"]), hgmma=by_kv["ragged"]["bf16"],
             families_launches={"pod-wr": fam_pods["pod-wr"]["launches"]["ragged"]},
             moe_launches={"pod-xr": moe_pods["pod-xr"]["launches"]["ragged"]},
             g4_max_abs_err=g4_err["ragged"],
             telemetry_launches=tel_launches("cuda_paged_ragged_attention"),
             **tail_fields(rag_tail["bf16"], rpath["launches"]["ragged_tail"])),
        dict(name="paged_decode_latent", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/latent_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:234",
             launches=mpath["launches"]["cuda_paged_latent_decode_attention"],
             max_abs_err=lat_dec["max_abs_err"], ms=lat_dec["ms"],
             plain_ms=lat_dec["plain_ms"], bound_ms=lat_dec["bound_ms"],
             bound_by=lat_dec["bound_by"], library_ms=None, splits=lat_dec["splits"],
             busy_splits=lat_dec["busy_splits"], chunk_keys=lat_dec["chunk_keys"],
             by_kernel=lat_dec["by_kernel"], events_ms=lat_dec["events_ms"],
             sdpa_contiguous_ms=lat_dec["sdpa_contiguous_ms"],
             sdpa_backend=lat_dec["sdpa_backend"],
             moe_launches=moe_launches("cuda_paged_latent_decode_attention"),
             **tail_fields(lat_tail, mbpath["launches"])),
        dict(name="paged_prefill_latent", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/latent_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:597",
             launches=mpath["launches"]["cuda_paged_latent_prefill_attention"],
             max_abs_err=lat_pre["max_abs_err"], ms=lat_pre["ms"],
             plain_ms=lat_pre["plain_ms"], bound_ms=lat_pre["bound_ms"],
             bound_by=lat_pre["bound_by"], library_ms=None,
             launches_by_shape=mpath["prefill_launches_by_shape"], shapes=lat_pre["shapes"],
             moe_launches=moe_launches("cuda_paged_latent_prefill_attention"),
             hgmma={k: n for k, n in hgmma["latent_prefill"].items()
                    if k.endswith(f", {MLA_HEADS}>")}),
        dict(name="paged_decode_fp8", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/paged_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:375",
             launches=f8_pods["pod-f"]["launches_fp8"]["cuda_paged_decode_attention"],
             max_abs_err=f8["decode"]["max_abs_err"], ms=f8["decode"]["ms"],
             plain_ms=f8["decode"]["plain_ms"], bound_ms=f8["decode"]["bound_ms"],
             bound_by=f8["decode"]["bound_by"], library_ms=None, splits=f8["decode"]["splits"],
             events_ms=f8["decode"]["events_ms"],
             sdpa_contiguous_ms=f8["decode"]["sdpa_contiguous_ms"],
             **tail_fields(f8["tail"],
                           f8_pods["pod-fb"]["launches_fp8"]["cuda_paged_decode_attention"])),
        dict(name="paged_prefill_fp8", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/paged_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:597",
             reference="llmd_kv_cache_tpu/models/engine.py:855 (XLA prefill of an fp8 pool)",
             launches=f8_pods["pod-f"]["launches_fp8"]["cuda_paged_prefill_attention"],
             max_abs_err=f8["prefill"]["max_abs_err"], ms=f8["prefill"]["ms"],
             plain_ms=f8["prefill"]["plain_ms"], bound_ms=f8["prefill"]["bound_ms"],
             bound_by=f8["prefill"]["bound_by"], library_ms=None,
             events_ms=f8["prefill"]["events_ms"],
             sdpa_contiguous_ms=f8["prefill"]["sdpa_contiguous_ms"],
             hgmma=by_kv["prefill"]["fp8"]),
        dict(name="paged_ragged_fp8", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/paged_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:736",
             launches=f8_pods["pod-fr"]["launches_fp8"]["cuda_paged_ragged_attention"],
             max_abs_err=f8["ragged"]["max_abs_err"], ms=f8["ragged"]["ms"],
             plain_ms=f8["ragged"]["plain_ms"], bound_ms=f8["ragged"]["bound_ms"],
             bound_by=f8["ragged"]["bound_by"], library_ms=None,
             launches_by_shape=f8_pods["pod-fr"]["launches_by_shape"],
             decode_only=f8["ragged"]["decode_only"], shapes=brief(f8["ragged"]["shapes"]),
             hgmma=by_kv["ragged"]["fp8"],
             **tail_fields(rag_tail["fp8"],
                                  f8_pods["pod-fr"]["launches"]["ragged_tail"])),
        dict(name="paged_decode_latent_h8", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/latent_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:234",
             launches=tp_rank0["pod-mt"]["launches"]["cuda_paged_latent_decode_attention"],
             max_abs_err=tp_h8_dec["max_abs_err"], ms=tp_h8_dec["ms"],
             plain_ms=tp_h8_dec["plain_ms"], bound_ms=tp_h8_dec["bound_ms"],
             bound_by=tp_h8_dec["bound_by"], library_ms=None, splits=tp_h8_dec["splits"],
             busy_splits=tp_h8_dec["busy_splits"], by_kernel=tp_h8_dec["by_kernel"],
             sdpa_contiguous_ms=tp_h8_dec["sdpa_contiguous_ms"],
             tp_moe_launches={"pod-et": tpm_rank0["pod-et"]["launches"][
                 "cuda_paged_latent_decode_attention"]},
             heads=TP_HEADS, **tail_fields(tp_h8_dec["tail"], 0)),
        dict(name="paged_prefill_latent_h8", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/latent_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:597",
             launches=tp_rank0["pod-mt"]["launches"]["cuda_paged_latent_prefill_attention"],
             max_abs_err=tp_h8_pre["max_abs_err"], ms=tp_h8_pre["ms"],
             plain_ms=tp_h8_pre["plain_ms"], bound_ms=tp_h8_pre["bound_ms"],
             bound_by=tp_h8_pre["bound_by"], library_ms=None, shapes=tp_h8_pre["shapes"],
             tp_moe_launches={"pod-et": tpm_rank0["pod-et"]["launches"][
                 "cuda_paged_latent_prefill_attention"]},
             tp_moe_max_abs_err=tpm["latent_prefill_h8"]["max_abs_err"],
             heads=TP_HEADS, hgmma={k: n for k, n in hgmma["latent_prefill"].items()
                                    if k.endswith(f", {TP_HEADS}>")}),
        dict(name="sharded_paged_decode", route="cuda",
             source="llmd_kv_cache_tpu_torch/ops/cuda_paged_attention.py",
             kernels=["llmd_kv_cache_tpu_torch/csrc/paged_attention.cu decode_kernel",
                      "llmd_kv_cache_tpu_torch/csrc/latent_attention.cu latent_decode_kernel"],
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:1593",
             launches=sum(tp_rank0[p]["sharded_launches"]["decode"]
                          for p in ("pod-t", "pod-mt")),
             launches_by_pod={p: tp_rank0[p]["sharded_launches"]["decode"]
                              for p in ("pod-t", "pod-mt")},
             tp_moe_launches={p: tpm_rank0[p]["sharded_launches"]["decode"]
                              for p in tpm_pods},
             max_abs_err=max(tp_wrap["max_abs_err"]["decode"],
                             tpm["wrappers"]["max_abs_err"]["decode"]),
             **{k: tp_wrap["decode"]["gqa"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None, shapes=tp_wrap["decode"],
             tp_moe_shapes=tpm["wrappers"]["decode"]),
        dict(name="sharded_paged_prefill", route="cuda",
             source="llmd_kv_cache_tpu_torch/ops/cuda_paged_attention.py",
             kernels=["llmd_kv_cache_tpu_torch/csrc/paged_attention.cu prefill_kernel",
                      "llmd_kv_cache_tpu_torch/csrc/latent_attention.cu latent_prefill_kernel"],
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:1657",
             launches=sum(tp_rank0[p]["sharded_launches"]["prefill"]
                          for p in ("pod-t", "pod-mt")),
             launches_by_pod={p: tp_rank0[p]["sharded_launches"]["prefill"]
                              for p in ("pod-t", "pod-mt")},
             tp_moe_launches={p: tpm_rank0[p]["sharded_launches"]["prefill"]
                              for p in tpm_pods},
             max_abs_err=max(tp_wrap["max_abs_err"]["prefill"],
                             tpm["wrappers"]["max_abs_err"]["prefill"]),
             **{k: tp_wrap["prefill"]["gqa"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
             library_ms=None, shapes=tp_wrap["prefill"],
             tp_moe_shapes=tpm["wrappers"]["prefill"]),
        dict(name="paged_ragged_latent", route="cuda",
             source="llmd_kv_cache_tpu_torch/csrc/latent_attention.cu",
             replaces="llmd_kv_cache_tpu/ops/pallas_paged_attention.py:736",
             launches=mrpath["launches"]["ragged_shared_kv"],
             max_abs_err=lat_rag["max_abs_err"], ms=lat_rag["ms"],
             plain_ms=lat_rag["plain_ms"], bound_ms=lat_rag["bound_ms"],
             bound_by=lat_rag["bound_by"], library_ms=None, events_ms=lat_rag["events_ms"],
             launches_by_shape=mrpath["launches_by_shape"],
             decode_only=lat_rag["decode_only"], chunk_only=lat_rag["chunk_only"],
             shapes=brief(lat_rag["shapes"]), plan=lat_rag["plan"],
             moe_launches={"pod-er": moe_pods["pod-er"]["launches"]["ragged_shared_kv"]},
             hgmma=hgmma["latent_ragged"],
             **tail_fields(rag_tail["latent"], mrpath["launches"]["ragged_tail"])),
    ]
    print(json.dumps({"timing": {
        "ttft_cold_ms": run["ttft_cold_ms"], "ttft_warm_ms": run["ttft_warm_ms"],
        "decode_ms_per_step_b8": run["decode_ms_per_step"],
        "decode_steps_timed": run["decode_steps_timed"],
        "prefill_logits_max_abs_err": run["logits_err"], "profile": run["profile"],
        "card": smi}}), flush=True)
    print(json.dumps({"ragged_timing": {
        "ragged_dispatches": rpath["dispatches"],
        "mixed_step_ms_pod_r_window": rpath["mixed_step_ms_in_window"],
        "mixed_step_ms": {p: [x for r in runs for x in r["mixed_step_ms"]]
                          for p, runs in steps.items()},
        "decode_step_ms_b8": {p: [x for r in runs for x in r["decode_step_ms_b8"]]
                              for p, runs in steps.items()},
        "profile_mixed_step": {p: runs[0]["profile_mixed_step"]
                               for p, runs in steps.items()},
        "ragged_kernel_decode_only_b8": rag["decode_only"],
        "greedy_agreement_pod_r_vs_padded": rpath["greedy_agreement"],
        "mixed_dispatch_logits_max_abs_err": ragged_logits_err,
        "decode_step_logits_vs_fp32": to_fp32,
        "card": smi}}), flush=True)
    print(json.dumps({"mla_timing": {
        "model": "DeepSeek-V2-Lite attention, 27 layers, dense MLP in every layer",
        "ttft_cold_ms": mpath["ttft_cold_ms"], "ttft_warm_ms": mpath["ttft_warm_ms"],
        "decode_ms_per_step_b8": mpath["decode_ms_per_step"],
        "decode_steps_timed": mpath["decode_steps_timed"],
        "prefill_chunks": mpath["prefill_chunks"], "decode_steps": mpath["decode_steps"],
        "logits": mpath["logits_err"], "profile": mpath["profile"],
        "latent_decode_b8_ms_between_events": lat_dec["events_ms"],
        "card": smi}}), flush=True)
    print(json.dumps({"burst_timing": {
        "decode_burst": TAIL_SLOTS,
        "host_ms_per_token_b8": {p: [r["ms_per_token"] for r in runs]
                                 for p, runs in per_token.items()},
        "profile_one_step_b8": {p: runs[0]["profile_one_step"]
                                for p, runs in per_token.items()},
        "bursts": {"pod-b": bpath["bursts"], "pod-mb": mbpath["bursts"]},
        "decode_launches": {"pod-b": bpath["launches"], "pod-mb": mbpath["launches"]},
        "greedy_agreement_vs_single_step": {"pod-b": bpath["greedy_agreement"],
                                            "pod-mb": mbpath["greedy_agreement"]},
        "graph_vs_eager": {"pod-b": bpath["graph_vs_eager"],
                           "pod-mb": mbpath["graph_vs_eager"]},
        "warmup_with_capture_s": {"pod-b": bpath["warmup_with_capture_s"],
                                  "pod-mb": mbpath["warmup_with_capture_s"]},
        "tick_logits_tail8": tick,
        "card": smi}}), flush=True)
    print(json.dumps({"offload": {**opath, "card": smi}}), flush=True)
    print(json.dumps({"fp8": {
        "pods": {p: {k: run[k] for k in ("launches", "launches_fp8", "plain_calls",
                                          "greedy_agreement", "prefill_chunks", "bursts",
                                          "decode_steps", "dispatches", "graph_vs_eager")
                     if k in run} for p, run in f8_pods.items()},
        "offload": f8["offload"], "logits": f8["logits"], "fp8_vs_bf16": f8["fp8_vs_bf16"],
        "decode_b32_ctx2048": f8["decode_b32_ctx2048"],
        "host_ms_per_token_b8": f8["host_ms_per_token_b8"],
        "profile_one_step_b8": f8["profile_one_step_b8"], "card": smi}}), flush=True)
    print(json.dumps({"mla_ragged": {
        "pod": "pod-mr", "dispatches": mrpath["dispatches"], "launches": mrpath["launches"],
        "launches_by_shape": mrpath["launches_by_shape"],
        "greedy_agreement_vs_pod_m": mrpath["greedy_agreement"],
        "mixed_step_ms_pod_mr_window": mrpath["mixed_step_ms_in_window"],
        "mixed_step_ms": mrpath["mixed_step_ms"],
        "decode_step_ms_b8": mrpath["decode_step_ms_b8"],
        "profile_mixed_step": mrpath["profile_mixed_step"],
        "mixed_dispatch_logits_max_abs_err": mrpath["mixed_dispatch_logits_max_abs_err"],
        "q72_dispatch_logits": mrpath["q72_logits"],
        "wall_s": mrpath["wall_s"], "card": smi}}), flush=True)
    print(json.dumps({"disagg": {**dpath, "card": smi}}), flush=True)
    print(json.dumps({"families": {**fam, "card": smi}}), flush=True)
    print(json.dumps({"tp": {**tp, "card": smi}}), flush=True)
    print(json.dumps({"moe": {**moe, "card": smi}}), flush=True)
    print(json.dumps({"tp_moe_detail": {**tpm, "card": smi}}, default=str), flush=True)
    print(json.dumps({"tp_moe": {**tpm["line"], "card": smi}}), flush=True)
    print(json.dumps({"telemetry": {**tel, "card": smi}}, default=str), flush=True)
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
