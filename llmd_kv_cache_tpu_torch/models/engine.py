"""Mini serving engine: paged KV cache + prefix caching + KV events.

Port of the main path of ``llmd_kv_cache_tpu/models/engine.py``. One engine
instance ≙ one "pod": it manages a physical page pool with
content-addressed prefix caching (block hashes computed by the same
``ChunkedTokenDatabase`` as the indexer, so engine keys ARE canonical keys
— a 1:1 mapping), runs chunked prefill and batched decode (a token a step,
or fused bursts) on the paged Llama model, and emits BlockStored / BlockRemoved /
AllBlocksCleared events to any callback.

Prefix caching semantics (mirroring vLLM's): on admission the prompt's
full blocks are hashed along the chain; the longest prefix of blocks
already resident is *reused* — those pages are attached to the new request
and their tokens are never recomputed, which is where the TTFT win comes
from. Evictions are LRU over unreferenced pages and emit BlockRemoved.

Observability, at the JAX engine's sites: with ``EngineConfig.telemetry``
(a ``telemetry.EngineTelemetryConfig``) the engine keeps TTFT, ITL, TPOT
and step-time histograms, KV-pool gauges (``BlockManager.pool_stats``),
dispatch-token counters and per-request flight records, read through
``engine.telemetry.debug_vars()``; ``telemetry=None`` leaves one attribute
load and a branch at each site. A request enqueued with a ``traceparent``
gets the admission, prefill-chunk and decode-step spans under that trace;
``attach_audit`` and ``attach_workingset`` wire the ground-truth audit log
and the working-set tracker; shed decisions, restores, admission delays and
offload results land in the metric families (``metrics.collector``) and the
flight recorder. Telemetry reads the engine's ``clock``; the ragged
scheduler reports the tokens it dispatches, which are not padded (see
below). ``engine.telemetry.attach_admin(server)`` serves ``debug_vars`` and
the profiler on a ``services.admin.AdminServer``; the fleet exporters wait
for the fleet planes (ROADMAP A.8.6). The pool holds the model's dtype or, with
``EngineConfig.kv_cache_dtype="f8_e4m3"``, fp8 e4m3 (cast on write by the
JAX package's rule, upcast on read by the kernels' fp8 arms). With an ``offload_spec``
(``offload.SharedStorageOffloadSpec``) the engine runs the JAX engine's
shared-storage tier: every committed prompt block is
written through to the store, and a prefix missing from the pool is
restored from it instead of recomputed — synchronously in ``add_request``,
or, for ``enqueue``, as a load polled from ``step()`` while the other rows
decode. The store's files are the JAX package's, byte for byte, so either
package restores what the other wrote. A spec whose storage blocks hold
``pages_per_block`` > 1 pages (a vLLM pod's 256-token blocks through
``offload.vllm_spec``, 16 pages of 16 tokens a file) is the port's own: the
engine stores and restores whole storage blocks, each file keyed by the
hash of its last page (vLLM's offload key), and restores only from a
storage-block boundary; such a spec takes neither a hybrid model nor a role
other than ``"both"``. Unlike the JAX engine, the copier
scatters into the engine's own pools in place (they are never rebound).

Model families: a uniform sliding window (Mistral) advertises its blocks as
``sliding_window`` and, with StreamingLLM sinks, ``sink_full_attention``;
both ride every scheduler. A hybrid model (full-attention and SWA layers,
Gemma-style) keeps two page pools with a ``BlockManager`` each (group 0 full
attention, group 1 the SWA layers, ``EngineConfig.num_swa_pages`` pages):
SWA pages are taken just in time for each chunk or decode position and the
slots that slide out of the window go back after it, so a request's SWA
demand is window + chunk, not prompt length; admission resumes at the
deepest prefix whose trailing window is resident; bursts pre-extend and
freeze the SWA table (and latch single-token decoding when the SWA pool
cannot cover a burst); offload writes both groups (group 1 the in-window
blocks) and restores all or nothing, synchronously. A hybrid model takes
neither the ragged scheduler (``ValueError`` at construction, where JAX
warns and keeps the padded path), a prefill or decode role, nor
``handoff=True``. Its single steps run the GQA kernels once a layer on the
layer's group pool, table and window (JAX runs them on XLA attention: the
same function).

Admission control: ``enqueue(deadline_s=...)`` (or an ambient
``resilience.deadline_scope``) skips a deferred restore whose budget is
spent or shorter than the restore-latency EMA, and with
``EngineConfig.shed_target_delay_s`` a CoDel shedder fed the admission
delay (enqueue to first scheduler pick) sheds low-priority work
(``OverloadShedError``) and browns out the rest (admitted, restore
dropped) under sustained overload. Disaggregated serving
(``EngineConfig.role``, ``offload.handoff``): a "prefill" pod commits each
prefill chunk's full blocks to the store as it computes them and reports
each store job to a ``HandoffCoordinator``; a "decode" pod's
``enqueue(handoff=True)`` requests pull those blocks in re-armed deferred
restores while its other rows decode, and prefill locally only what never
arrived (the last prompt token at least), after the transfer completed,
the peer failed or ``handoff_wait_s`` ran out. Handoff waits, deadlines
and admission delays read one clock, the engine's ``clock``.

Tensor-parallel serving (``MiniEngine(..., tp=group)``, the JAX engine's
``mesh``): each rank of a ``parallel.mesh.TPGroup`` is a process with one
engine, running the same host control plane (scheduler, ``BlockManager``,
page tables, sampling) on the same requests, with its Megatron shard of the
parameters and its part of the pool (its kv heads, or the whole latent
pool of an MLA model); every step goes through the sharded attention
wrappers, and only rank 0 hands events to the sink, so an indexer sees each
block once. Under tp these raise ``ValueError`` at construction (the JAX
engine serves them; deliberate differences for now): the ragged scheduler,
``decode_burst > 1`` (a captured burst cannot hold a gloo collective), a
hybrid model, an offload spec, a role other than ``"both"`` and fp8 pools.
A mixture-of-experts model splits each expert's inner width over the ranks.

Fused projections (``EngineConfig.fuse_projections``, the JAX gate): the
engine fuses its tree at construction (``llama.fuse_params``), before a
burst graph is captured, when asked to or, by default, when
``llama.fuse_profitable`` holds at the rank's width; under tp in the
per-rank interleaved order (``fused_interleave`` = tp on a copy of the
model config), and an MLA model never (refused when asked).

Decode takes one token a step, or, with ``EngineConfig.decode_burst``, a
fused burst of up to that many tokens a row per dispatch, which on the
card is one replay of a captured CUDA graph. An absorbed-MLA model
(``LlamaConfig.kv_lora_rank > 0``) pools one latent row per token and
advertises its blocks as ``mla_attention``. Two schedulers serve it: the
padded two-kernel path (a batch-1 prefill chunk, then decode padded to
``max_batch``) and, with
``EngineConfig.ragged_attention``, the ragged path, where the prefill chunk
and every decode row go out as one dispatch over a flat token axis through
the ragged kernel. One deliberate difference from the JAX ragged path: the
flat token axis and the row axis are not bucketed to powers of two. JAX
buckets them to bound its jit recompiles; eager PyTorch has no such cache,
and a bucket would run the projection and MLP GEMMs over up to twice the
real tokens (4096 rows for 8 decode rows plus a 2048-token chunk). Tokens,
``cached_len`` and events do not depend on it. The one place the bucket
would show is an MoE model's capacity dispatch, whose per-expert buffers
grow with the token count: a ragged dispatch computes them from the length
JAX would pad to (``jax_flat_bucket``), so the same assignments drop. The
other place is telemetry: a ragged dispatch reports its real tokens as its
dispatched tokens (``on_dispatch_tokens(t, t)``, where JAX reports its
bucket), so the padded-token counter and the waste ratio read what the
card ran. An MoE model (``LlamaConfig.num_experts > 0``) rides every scheduler and burst
graphs, and under tp the padded scheduler.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..core.hma import SPEC_FULL_ATTENTION, SPEC_MLA, SPEC_SINK_FULL, SPEC_SLIDING_WINDOW
from ..core.keys import EMPTY_BLOCK_HASH
from ..core.token_processor import ChunkedTokenDatabase, TokenProcessorConfig
from ..events.model import (
    AllBlocksClearedEvent,
    BlockRemovedEvent,
    BlockStoredEvent,
    GenericEvent,
)
from ..metrics.collector import (
    record_admission_delay,
    record_engine_restore,
    record_io_pool_placement,
    record_offload_restore,
    record_offload_result,
    record_shed,
)
from ..offload.cuda_copier import CUDABlockCopier
from ..ops import cuda_paged_attention
from ..resilience.deadline import Deadline, current_deadline
from ..resilience.shedding import (
    BROWNOUT,
    PRIORITY_NORMAL,
    SHED,
    CoDelShedder,
    OverloadShedError,
)
from ..telemetry.flight_recorder import KIND_AUDIT, KIND_SHED
from ..telemetry.flight_recorder import record as record_flight
from ..telemetry.engine_telemetry import STEP_GATE, EngineTelemetry, EngineTelemetryConfig
from ..telemetry.tracing import tracer
from .llama import (
    LlamaConfig,
    forward_decode,
    forward_decode_steps,
    forward_decode_steps_hybrid,
    forward_hybrid,
    forward_prefill,
    forward_ragged,
    fuse_params,
    fuse_profitable,
    init_kv_cache,
    init_kv_cache_hybrid,
    init_params,
    resolve_device,
    unfuse_params,
)
from ..parallel.mesh import shard_params
from ..parallel.serve import mesh_tp_size, validate_tp_config

logger = logging.getLogger(__name__)

EventSink = Callable[[list[GenericEvent]], None]


def _resolve_kv_dtype(name: str) -> torch.dtype:
    """EngineConfig.kv_cache_dtype string → torch dtype (loud on typos),
    the JAX engine's table."""
    table = {
        "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
        "f8_e4m3": torch.float8_e4m3fn, "float8_e4m3fn": torch.float8_e4m3fn,
    }
    if name not in table:
        raise ValueError(
            f"kv_cache_dtype must be one of {sorted(table)}, got {name!r}")
    return table[name]


@dataclass
class EngineConfig:
    model: LlamaConfig = field(default_factory=LlamaConfig.tiny)
    num_pages: int = 512
    # Hybrid models: pages of the SWA group's own pool (None: num_pages).
    # SWA pages are taken just in time and given back as slots slide out
    # of the window, so a request's peak demand is window + max(prefill
    # chunk, decode_burst) pages (+ the decode page), not prompt length.
    # Bursts freeze the window tables for up to decode_burst tokens; a pool
    # too small for that latches single-token decoding instead of failing.
    num_swa_pages: Optional[int] = None
    max_pages_per_seq: int = 64
    max_batch: int = 8
    hash_seed: str = ""
    model_name: str = "tiny-llama"
    pod_identifier: str = "pod-0"
    # Chunked prefill: the uncached suffix is processed in chunks of at
    # most this many tokens (vLLM-style), bounding per-step activation
    # memory for long prompts. Must be a multiple of the page size.
    max_prefill_tokens: int = 512
    # Ragged scheduling: each step packs the prefill chunk and every active
    # decode row into one flat-token-axis dispatch (forward_ragged, the
    # ragged kernel) instead of the batch-1 prefill call plus the padded
    # decode call. A model the ragged kernel cannot take (head_dim, GQA
    # group, latent width) raises from the kernel's wrapper; it never falls
    # back. A hybrid model raises at construction (JAX warns and keeps
    # the padded path): its two pools have no ragged dispatch. An MLA
    # model runs the kernel's shared_kv arm (its
    # LlamaConfig.mla_decode_stream is accepted and changes nothing on the
    # card: one staged latent chunk feeds both products). decode_burst > 1
    # raises at engine construction (bursts scan the padded decode program;
    # JAX warns and keeps the padded path).
    ragged_attention: bool = False
    # Fused decode bursts: up to this many greedy tokens per device
    # dispatch (one CUDA graph replay on the card). 1 = one token per step()
    # — finest-grained continuous batching; larger values amortize dispatch
    # overhead at the cost of admitting new requests only between bursts.
    # Bursts are the power-of-two floor of this value, fixed per engine.
    decode_burst: int = 1
    # Paged KV pool element type: None (the model's dtype), "bf16", or
    # "f8_e4m3" (float8_e4m3fn), which halves the pools' bytes and the
    # decode's KV reads. e4m3 needs no scales: the pools keep their layout,
    # scatters cast on write, the kernels' fp8 arms upcast on read, and the
    # offload tier moves 1-byte elements under a store directory of their
    # own (dtype is a fingerprint field). MLA latent pools refuse it, as in
    # JAX. JAX's TPU-only kv_heads * page_size % 32 gate does not apply.
    kv_cache_dtype: Optional[str] = None
    # Fused projections (llama.fuse_params: w_qkv, w_mla_in, w_gate_up,
    # w_gate_up_sh), applied to the tree at construction. None (default):
    # fuse iff llama.fuse_profitable(model, tp) (a rank's hidden width >=
    # 4096, JAX's gate) and the model is not MLA under tp. True / False
    # force it; True on MLA under tp raises (its fused block mixes
    # head-sharded and replicated columns). Under tp the columns are
    # interleaved per rank (fused_interleave = tp, on a copy of the model
    # config), and a pre-fused canonical tree (llama.maybe_fuse_params, the
    # way several single-rank pods share one fused tree) is unfused and
    # fused again in that order. The port has no pp, so JAX's pp refusal
    # has no case here.
    fuse_projections: Optional[bool] = None
    # The JAX engine's attention-backend knobs: use_pallas_decode and
    # use_pallas_prefill (None = auto; True / False force its Pallas or XLA
    # attention) and decode_batch_rows (batch rows co-scheduled per Pallas
    # flash-decode program; JAX clamps it to at least 1 and warns, never
    # raises, on a knob its backend cannot honour). On the card the
    # hand-written kernels always run (a wrapper launches its kernel or
    # raises; on CPU tensors the plain version runs), so the three are
    # accepted as JAX accepts them and change nothing here (ROADMAP A.6).
    use_pallas_decode: Optional[bool] = None
    use_pallas_prefill: Optional[bool] = None
    decode_batch_rows: int = 1
    # Engine data-plane telemetry (telemetry/engine_telemetry.py): an
    # EngineTelemetryConfig (or a dict of its fields, camel or snake case)
    # enables TTFT/ITL/TPOT/step histograms, KV-pool gauges, dispatch-token
    # counters, per-request flight-recorder events and the on-demand
    # torch.profiler capture. None (default) keeps the step path free of
    # every hook: each site costs one attribute load and a branch.
    telemetry: Optional[Any] = None
    # Disaggregated serving role (offload.handoff): "both" (default —
    # monolithic pod, prefill and decode), "prefill" (prefill-only pod:
    # each chunk's full blocks commit write-through to the transfer tier
    # as they are computed, the request finishes at first token and
    # decoding happens elsewhere), or "decode" (decode-side pod:
    # ``enqueue(handoff=True)`` requests wait up to ``handoff_wait_s``
    # for transferred blocks before falling back to local prefill). A role
    # other than "both" needs an offload spec.
    role: str = "both"
    # Decode-side handoff patience: how long a ``handoff=True`` request
    # waits for the prefill peer's blocks to land before recomputing the
    # remainder locally. Decodes keep running the whole time (the wait
    # costs only that request's TTFT, never the running batch).
    handoff_wait_s: float = 10.0
    # CoDel-style overload shedding at admission (resilience.shedding):
    # when admission delay (enqueue → first scheduler pick) stays above
    # the target for a full interval, ``enqueue`` sheds lowest-priority
    # work first instead of letting the queue grow without bound. 0
    # (default) disables the shedder entirely.
    shed_target_delay_s: float = 0.0
    shed_interval_s: float = 0.1


@dataclass
class _BlockInfo:
    page: int
    ref_count: int = 0
    last_used: float = 0.0
    parent_hash: int = 0
    tokens: tuple[int, ...] = ()


@dataclass
class Request:
    request_id: str
    prompt: list[int]
    max_new_tokens: int
    # runtime state
    output: list[int] = field(default_factory=list)
    pages: list[int] = field(default_factory=list)  # physical pages, logical order
    swa_pages: list[int] = field(default_factory=list)  # hybrid: group 1 pages
    # Hybrid: first logical block whose SWA page this request references
    # (earlier slots map to the garbage page: out of window).
    swa_acquired_from: int = 0
    block_hashes: list[int] = field(default_factory=list)  # hash-chained, per full block
    cached_len: int = 0  # tokens skipped via prefix cache at admission
    computed_len: int = 0  # tokens with KV resident (cached + prefilled + decoded)
    last_logits: Optional[np.ndarray] = None
    done: bool = False
    # Continuous batching: next prompt index to prefill, or None once the
    # request is decoding. ``enqueue`` admits with this set; ``step``
    # advances one chunk at a time interleaved with decode.
    prefill_pos: Optional[int] = None
    # Prompt blocks registered in the block manager on this request's
    # behalf (acquired prefix at admission, extended by
    # _commit_full_blocks). _release treats pages past this watermark as
    # unregistered orphans.
    committed_blocks: int = 0
    # Device-resident page table, cached across prefill chunks (pages are
    # fixed from admission until commit). Cleared at prefill finish.
    table_dev: Optional[torch.Tensor] = None
    # Deferred storage restore (enqueue path): the lookup has not run yet /
    # an async load is in flight. ``step`` polls the job across steps so a
    # slow restore never stalls running decodes.
    restore_pending: bool = False
    # (job_id, first_missing_block, hashes, pages, deadline, started)
    # while loading.
    restore_job: Optional[tuple] = None
    # Blocks restored from the storage tier for this request.
    restored_blocks: int = 0
    # enqueue() timestamp on the engine's clock, cleared at the first
    # scheduler pick: the admission delay that feeds the shedder.
    enqueued_at: Optional[float] = None
    # Decode-side handoff wait (enqueue(handoff=True) on a decode-role
    # engine): the engine-clock deadline until which step() holds this
    # request's local prefill, polling the transfer tier for the prefill
    # peer's blocks in re-armed deferred-restore rounds. None once settled.
    handoff_deadline: Optional[float] = None
    # End-to-end budget carried from the caller (enqueue(deadline_s=...),
    # or the ambient deadline_scope at enqueue time). A deferred storage
    # restore that cannot finish inside the remaining budget is skipped —
    # recompute beats a restore whose result arrives after the caller
    # stopped waiting.
    deadline: Optional[Deadline] = None
    # resilience.shedding priority class: sheds lowest-first under
    # admission overload.
    priority: int = PRIORITY_NORMAL
    # W3C traceparent carried from the scorer (enqueue(traceparent=...)):
    # when set, the engine parents admission/prefill/decode spans under it
    # so one trace covers score→serve. None = no spans.
    traceparent: Optional[str] = None
    # Ground-truth audit (telemetry/audit.py): the ScoreFeedback this
    # request was routed on (duck-typed, None when the scheduler passed
    # none) and the HBM prefix hit at admission; with restored_blocks they
    # decompose the realized prefix outcome emitted at prefill finish.
    feedback: Any = None
    hbm_hit_blocks: int = 0

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output)


class BlockManager:
    """Physical page pool with content-addressed prefix caching.

    Page 0 is the reserved garbage page (see ``ops.kv_pages``). Full blocks
    are indexed by chain hash; unreferenced pages stay cached until LRU
    eviction reclaims them.
    """

    def __init__(self, cfg: EngineConfig, processor: ChunkedTokenDatabase,
                 event_sink: Optional[EventSink] = None, group_idx: int = 0,
                 num_pages: Optional[int] = None, spec_kind: Optional[str] = None,
                 spec_window: Optional[int] = None):
        self.cfg = cfg
        self.processor = processor
        self.event_sink = event_sink
        self.group_idx = group_idx
        self.num_pages = num_pages if num_pages is not None else cfg.num_pages
        self.free_pages: list[int] = list(range(1, self.num_pages))  # 0 reserved
        self.blocks: dict[int, _BlockInfo] = {}  # block_hash → info
        self.page_to_hash: dict[int, int] = {}
        # Lifetime eviction count: a plain int (one add per eviction) that
        # telemetry turns into kvtpu_engine_kv_pool_evictions_total deltas.
        self.evictions = 0
        # Optional eviction tap: called with the victim's age (seconds
        # since last use) — the working-set tracker's eviction-age
        # histogram (engine.attach_workingset wires it).
        self.on_evict: Optional[Callable[[float], None]] = None
        if spec_kind is not None:
            # A hybrid engine's managers, one a cache group.
            self.spec_kind, self.spec_window = spec_kind, spec_window
            return
        # The KV-cache spec advertised in events. An MLA pool's blocks are
        # latents, not per-head K/V, so consumers must not mix them with
        # full_attention blocks of the same tokens (reference events.go:34).
        # A pool is sliding_window only when every layer is SWA, and
        # sink_full_attention with sinks (events.go:40).
        mcfg = cfg.model
        self.spec_kind, self.spec_window = SPEC_FULL_ATTENTION, None
        if mcfg.is_mla:
            self.spec_kind = SPEC_MLA
        elif (mcfg.sliding_window is not None
              and set(mcfg.swa_layers) >= set(range(mcfg.num_layers))):
            self.spec_kind = SPEC_SINK_FULL if mcfg.attention_sinks else SPEC_SLIDING_WINDOW
            self.spec_window = mcfg.sliding_window

    def num_free(self) -> int:
        return len(self.free_pages)

    def num_cached_blocks(self) -> int:
        return len(self.blocks)

    def pool_stats(self) -> dict:
        """Occupancy snapshot for telemetry: cheap plain-int reads.

        ``orphan_pages`` are pages neither free nor registered as hashed
        blocks — held by in-flight requests (partial tails, decode room)
        and not reusable as prefix cache until commit.
        """
        free = len(self.free_pages)
        cached_pages = len(self.page_to_hash)
        return {
            "total_pages": self.num_pages,
            "free_pages": free,
            "cached_blocks": len(self.blocks),
            "cached_pages": cached_pages,
            # Page 0 is the reserved garbage page.
            "orphan_pages": max((self.num_pages - 1) - free - cached_pages, 0),
            "evictions": self.evictions,
        }

    def _emit(self, events: list[GenericEvent]) -> None:
        if self.event_sink is not None and events:
            self.event_sink(events)

    def match_prefix(self, block_hashes: Sequence[int]) -> list[int]:
        """Longest resident prefix: returns the pages for matched blocks."""
        pages = []
        for h in block_hashes:
            info = self.blocks.get(h)
            if info is None:
                break
            pages.append(info.page)
        return pages

    def acquire_prefix(self, block_hashes: Sequence[int]) -> list[int]:
        """Reference the longest resident prefix; bumps ref counts."""
        pages = self.match_prefix(block_hashes)
        now = time.monotonic()
        for h in block_hashes[: len(pages)]:
            info = self.blocks[h]
            info.ref_count += 1
            info.last_used = now
        return pages

    def try_acquire_blocks(self, block_hashes: Sequence[int]) -> Optional[list[int]]:
        """All-or-nothing reference of these blocks (the SWA trailing
        window: the set needed is a window, not a prefix); None when one is
        not resident."""
        infos = [self.blocks.get(h) for h in block_hashes]
        if any(info is None for info in infos):
            return None
        now = time.monotonic()
        for info in infos:
            info.ref_count += 1
            info.last_used = now
        return [info.page for info in infos]

    def allocate_page(self) -> Optional[int]:
        """Pop a free page, evicting LRU unreferenced blocks if needed."""
        if not self.free_pages and not self._evict_one():
            return None
        return self.free_pages.pop()

    def _evict_one(self) -> bool:
        victim_hash = None
        victim_time = float("inf")
        for h, info in self.blocks.items():
            if info.ref_count == 0 and info.last_used < victim_time:
                victim_time = info.last_used
                victim_hash = h
        if victim_hash is None:
            return False
        info = self.blocks.pop(victim_hash)
        self.page_to_hash.pop(info.page, None)
        self.free_pages.append(info.page)
        self.evictions += 1
        if self.on_evict is not None:
            try:
                self.on_evict(time.monotonic() - victim_time)
            except Exception:  # telemetry never interferes with serving
                logger.debug("eviction tap failed", exc_info=True)
        # Must carry the same group tag as the BlockStored that created the
        # entry, or the index's entry-match eviction is a silent no-op.
        self._emit([
            BlockRemovedEvent(block_hashes=[victim_hash], group_idx=self.group_idx)
        ])
        return True

    def commit_blocks(
        self,
        block_hashes: Sequence[int],
        pages: Sequence[int],
        tokens_per_block: Sequence[Sequence[int]],
        parent_of_first: int,
    ) -> list[int]:
        """Register newly computed full blocks in the prefix cache.

        Returns the canonical page per block: when a block's content is
        already resident (recomputed duplicate), the existing page wins and
        the redundant page is freed — the KV bytes are identical.

        Emits one BlockStored event per *contiguous run* of newly stored
        blocks, each with its own correct parent hash, so the indexer's
        chained request-key recomputation never spans a gap.
        """
        now = time.monotonic()
        canonical_pages: list[int] = []
        events: list[GenericEvent] = []
        run_hashes: list[int] = []
        run_tokens: list[int] = []
        run_parent = parent_of_first
        parent = parent_of_first

        def flush_run():
            nonlocal run_hashes, run_tokens
            if run_hashes:
                events.append(
                    BlockStoredEvent(
                        block_hashes=list(run_hashes),
                        tokens=list(run_tokens),
                        parent_hash=run_parent,
                        block_size=self.processor.block_size,
                        group_idx=self.group_idx,
                        kv_cache_spec_kind=self.spec_kind,
                        kv_cache_spec_sliding_window=self.spec_window,
                    )
                )
            run_hashes, run_tokens = [], []

        for h, page, toks in zip(block_hashes, pages, tokens_per_block):
            existing = self.blocks.get(h)
            if existing is None:
                self.blocks[h] = _BlockInfo(
                    page=page, ref_count=1, last_used=now,
                    parent_hash=parent, tokens=tuple(toks),
                )
                self.page_to_hash[page] = h
                if not run_hashes:
                    run_parent = parent
                run_hashes.append(h)
                run_tokens.extend(toks)
                canonical_pages.append(page)
            else:
                # Recomputed duplicate: adopt the resident page, free ours.
                existing.ref_count += 1
                existing.last_used = now
                if page != existing.page:
                    self.free_pages.append(page)
                canonical_pages.append(existing.page)
                flush_run()
            parent = h
        flush_run()
        self._emit(events)
        return canonical_pages

    def release(self, block_hashes: Sequence[int], orphan_pages: Sequence[int]) -> None:
        """Drop a finished request's references; free unhashed pages."""
        for h in block_hashes:
            info = self.blocks.get(h)
            if info is not None and info.ref_count > 0:
                info.ref_count -= 1
        self.free_pages.extend(orphan_pages)

    def clear(self, emit: bool = True) -> None:
        """Drop the whole prefix cache (weight rollout) and emit the reset.

        AllBlocksCleared is pod-wide (it clears every group at the index),
        so a hybrid engine emits it from one manager only (``emit=False``
        on the other)."""
        for info in self.blocks.values():
            self.free_pages.append(info.page)
        self.blocks.clear()
        self.page_to_hash.clear()
        if emit:
            self._emit([AllBlocksClearedEvent()])


def jax_flat_bucket(tokens: int) -> int:
    """The length the JAX ragged engine pads a dispatch's flat token axis
    to: a power of two, at least 8 (its jit bucket). The axis here is not
    padded; an MoE capacity dispatch computes its buffers from this length
    so that it drops the assignments JAX drops."""
    bucket = 8
    while bucket < tokens:
        bucket *= 2
    return bucket


class _BurstGraph:
    """An engine's fused decode burst captured as one CUDA graph (the JAX
    engine compiles one burst program per engine): ``forward_decode_steps``
    (a hybrid model's ``forward_decode_steps_hybrid``, over both pools) at
    batch ``max_batch`` and the engine's burst size, its final scatter into
    the pages included, over static input tensors (one page table a pool,
    each frozen for the burst) and a static ``[max_batch, steps]`` token
    output.

    Captured at the engine's first burst, after a warm-up on a side stream
    as PyTorch documents (it loads the kernels and sets their attributes
    outside the capture; its launches count like any eager launch). The
    warm-up runs with every budget 0, so it writes only the garbage page. A
    capture that fails raises: nothing falls back to the eager loop. A
    replay copies the inputs in, replays, and reads the tokens back — one
    host sync a burst. A replay runs no Python, so the kernels' launch
    counters would advance only while capturing, which launches nothing:
    the graph takes each one's count over the capture off and adds it at
    every replay.
    """

    def __init__(self, engine: "MiniEngine", steps: int, last, ctx, tables: tuple):
        dev = engine.device
        self.last = torch.from_numpy(last).to(dev)
        self.ctx = torch.from_numpy(ctx).to(dev)
        self.tables = tuple(torch.from_numpy(t).to(dev) for t in tables)
        self.budgets = torch.zeros(len(last), dtype=torch.int32, device=dev)

        def burst():
            if engine.hybrid:
                return forward_decode_steps_hybrid(
                    engine.params, engine.cfg.model, self.last, engine.k_cache,
                    engine.v_cache, engine.k_swa, engine.v_swa, *self.tables, self.ctx,
                    self.budgets, steps)[0]
            return forward_decode_steps(
                engine.params, engine.cfg.model, self.last, engine.k_cache,
                engine.v_cache, *self.tables, self.ctx, self.budgets, steps)[0]

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            burst()
        torch.cuda.current_stream(dev).wait_stream(side)
        # Every launch counter (``launches``, and an fp8 pool's
        # ``launches_fp8``) of every wrapper.
        counted = [(fn, attr) for fn in vars(cuda_paged_attention).values()
                   for attr in ("launches", "launches_fp8") if hasattr(fn, attr)]
        before = [getattr(fn, attr) for fn, attr in counted]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.tokens = burst()
        # A capture records launches and runs none: its counts go to the
        # replays.
        self.launches = [(fn, attr, getattr(fn, attr) - n)
                         for (fn, attr), n in zip(counted, before)]
        for (fn, attr), n in zip(counted, before):
            setattr(fn, attr, n)

    def replay(self, last, ctx, tables: tuple, budgets) -> np.ndarray:
        """Run the captured burst on these inputs; returns the tokens."""
        for dst, src in ((self.last, last), (self.ctx, ctx), (self.budgets, budgets),
                         *zip(self.tables, tables)):
            dst.copy_(torch.from_numpy(src))
        self.graph.replay()
        for fn, attr, n in self.launches:
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.tokens.cpu().numpy()


class MiniEngine:
    """Single-pod batched serving engine over the paged Llama model.

    Runs on ``device`` (CUDA by default; raises when CUDA is absent unless
    ``device="cpu"``). The KV pools and weights live there; page tables and
    token ids cross per step. ``clock`` is the monotonic clock of handoff
    waits, request deadlines and admission delays (tests inject one).

    ``tp``: this rank's tensor-parallel group (``parallel.mesh.TPGroup``);
    the engine runs on the group's device, checks the model against the
    group (``parallel.serve.validate_tp_config``), places its shard of
    the full ``params`` it is given on the group's device
    (``parallel.mesh.shard_params``: a tree on the host puts only the shard
    on the card; one made from ``seed`` is made on the card first) and
    allocates its part of the pool. Every rank must see the same calls in
    the same order.

    ``EngineConfig.fuse_projections`` fuses the tree (a new tree: the
    caller's is not changed) before it is sharded; ``cfg`` then holds a
    copy of the model config with the tree's ``fused_interleave``.
    """

    def __init__(
        self,
        cfg: Optional[EngineConfig] = None,
        event_sink: Optional[EventSink] = None,
        params=None,
        seed: int = 0,
        device="cuda",
        offload_spec=None,
        clock: Callable[[], float] = time.monotonic,
        tp=None,
    ):
        self.cfg = cfg or EngineConfig()
        self._clock = clock
        mcfg = self.cfg.model
        # Burst size: the power-of-two floor of decode_burst, fixed for the
        # engine's lifetime (one captured burst graph on the card).
        self._burst = 1
        while self._burst * 2 <= self.cfg.decode_burst:
            self._burst *= 2
        if self.cfg.ragged_attention and self._burst > 1:
            raise ValueError(
                f"ragged_attention=True with decode_burst={self.cfg.decode_burst}: "
                "fused bursts run the padded decode program; set one of them off")
        # Hybrid (mixed full/SWA layers): two cache groups with page pools
        # and block managers of their own; events carry group tags and
        # specs, so the indexer's GroupCatalog and HybridAwareScorer see
        # the real layout (reference hma.go:32-66, producer side).
        self.hybrid = mcfg.is_hybrid
        if self.cfg.ragged_attention and self.hybrid:
            raise ValueError(
                "ragged_attention=True with a hybrid model: its two page pools have "
                "no ragged dispatch; serve it on the padded path")
        self._burst_graph: Optional[_BurstGraph] = None
        # Latched when the SWA pool proves too small for a burst's transient
        # pages: the engine then decodes single-token for its lifetime.
        self._burst_degraded = False
        self.tp = tp
        self.device = resolve_device(device if tp is None else tp.device)
        if self.cfg.max_pages_per_seq * self.cfg.max_batch > self.cfg.num_pages:
            logger.warning("page pool smaller than worst-case demand; requests may stall")
        self.processor = ChunkedTokenDatabase(
            TokenProcessorConfig(
                block_size_tokens=mcfg.page_size, hash_seed=self.cfg.hash_seed
            )
        )
        self.params = params if params is not None else init_params(
            mcfg, seed, self.device)
        self.requests: dict[str, Request] = {}
        self._running: list[str] = []
        self._kv_dtype = (mcfg.dtype if self.cfg.kv_cache_dtype is None
                          else _resolve_kv_dtype(self.cfg.kv_cache_dtype))
        self._fp8_cache = self._kv_dtype.itemsize == 1
        if self._fp8_cache and mcfg.is_mla:
            raise ValueError(
                "kv_cache_dtype=f8_e4m3 does not support MLA latent "
                "pools yet (absorbed-attention latents are more "
                "quantization-sensitive; keep bf16)")
        if tp is not None:
            self._check_tp(offload_spec)
        self._fuse_projections()
        if tp is not None:
            self.params = shard_params(self.params, tp)
            # Every rank keeps the same bookkeeping; rank 0 alone publishes it.
            if tp.rank != 0:
                event_sink = None
        self.swa_manager: Optional[BlockManager] = None
        self.k_swa = self.v_swa = None
        if self.hybrid:
            num_swa = self.cfg.num_swa_pages or self.cfg.num_pages
            self.block_manager = BlockManager(
                self.cfg, self.processor, event_sink, group_idx=0,
                spec_kind=SPEC_FULL_ATTENTION, spec_window=None)
            self.swa_manager = BlockManager(
                self.cfg, self.processor, event_sink, group_idx=1, num_pages=num_swa,
                spec_kind=SPEC_SLIDING_WINDOW, spec_window=mcfg.sliding_window)
            self.k_cache, self.v_cache, self.k_swa, self.v_swa = init_kv_cache_hybrid(
                mcfg, self.cfg.num_pages, num_swa, self._kv_dtype, self.device)
        else:
            self.block_manager = BlockManager(self.cfg, self.processor, event_sink)
            self.k_cache, self.v_cache = init_kv_cache(
                mcfg, self.cfg.num_pages, self._kv_dtype, self.device,
                tp_size=mesh_tp_size(tp))

        # Optional shared-storage offload tier: write-through on commit,
        # restore on prefix miss at admission.
        self.offload_manager = None
        self.offload_handlers = None
        self._store_ppb = 1
        # The offload medium's label in the metric families.
        self._offload_medium = ""
        self._pending_store_jobs: dict[int, list[int]] = {}
        # Deferred-restore bookkeeping: results for these job ids must be
        # stashed by ANY drain (poll_offload's untargeted drain would
        # otherwise swallow a completion before the owning request polls).
        self._restore_job_ids: set[int] = set()
        self._restore_results: dict[int, object] = {}
        if offload_spec is not None:
            if getattr(offload_spec, "attention_sinks", 0) != mcfg.attention_sinks:
                # The sink mask changes deeper layers' KV past the window;
                # a spec that disagrees would fingerprint to the wrong
                # store directory and resume byte-incompatible blocks.
                raise ValueError(
                    f"offload spec attention_sinks="
                    f"{getattr(offload_spec, 'attention_sinks', 0)} does "
                    f"not match the model's {mcfg.attention_sinks}")
            spec_dtype = getattr(offload_spec, "dtype", "bfloat16")
            cache_dtype_name = str(self.k_cache.dtype).removeprefix("torch.")
            if spec_dtype != cache_dtype_name:
                # The dtype is a fingerprint field: a mismatched spec would
                # resume stores whose bytes are another element type.
                raise ValueError(
                    f"offload spec dtype={spec_dtype!r} does not match "
                    f"the engine's KV cache dtype {cache_dtype_name!r} "
                    f"(set OffloadSpec dtype accordingly)")
            self.offload_manager = offload_spec.get_manager()
            self._offload_medium = offload_spec.medium
            # The copier holds these very pools and scatters into them in
            # place: a captured burst graph keeps addressing them.
            self.offload_handlers = offload_spec.get_handlers(
                self.k_cache, self.v_cache)
            # Pages a storage block holds (1: the JAX engine's one page a
            # block; more: whole vLLM-sized storage blocks, see above).
            self._store_ppb = getattr(self.offload_handlers, "pages_per_block", 1)
            if self._store_ppb > 1 and self.hybrid:
                raise ValueError(
                    f"an offload spec of {self._store_ppb} pages a storage block does "
                    "not take a hybrid model")
            if self.hybrid:
                # Group 1 (SWA) gets a copier of its own, bound to the SWA
                # pool; both groups store and restore, keyed by group_idx
                # into per-group store directories or key prefixes. The
                # POSIX and object backends both route per-group copiers.
                if not hasattr(self.offload_handlers, "copiers"):
                    raise NotImplementedError(
                        "hybrid models need per-group offload copiers; the "
                        f"{offload_spec.backend!r} backend has none")
                self.offload_handlers.copiers[1] = CUDABlockCopier(self.k_swa, self.v_swa)
        # Disaggregated serving (offload.handoff): a coordinator attached
        # via attach_handoff turns a "prefill"-role engine into the
        # transfer's producer (per-chunk write-through commits notify it)
        # and a "decode"-role engine into its consumer (handoff=True
        # enqueues wait on it). A hybrid model takes neither role.
        self._check_role(self.cfg.role)
        self.handoff = None
        # store job id → (request_id, block hashes) for jobs the handoff
        # coordinator must hear about when they settle.
        self._handoff_store_jobs: dict[int, tuple[str, list[int]]] = {}
        # on_restore_latency is an optional tap fed each successful
        # restore's wall time. The streaming EMA of those times feeds the
        # deferred-restore deadline gate: a request whose remaining budget
        # is smaller than what a restore typically costs recomputes.
        self.on_restore_latency: Optional[Callable[[float], None]] = None
        self._restore_latency_ema = 0.0
        # Admission overload shedding (CoDel over admission delay), None
        # unless configured; it reads the engine's clock.
        self.shedder: Optional[CoDelShedder] = None
        if self.cfg.shed_target_delay_s > 0:
            self.shedder = CoDelShedder(
                "engine.admission",
                target_delay_s=self.cfg.shed_target_delay_s,
                interval_s=self.cfg.shed_interval_s,
                clock=clock,
            )

        # Engine data-plane telemetry: request-lifecycle histograms
        # (TTFT/ITL/TPOT), decimated KV-pool gauge scrapes, per-request
        # flight-recorder events, on the engine's clock. None when the
        # config leaves it off — every hook site guards on that, so the
        # disabled step path pays one attribute load + branch per site.
        self.telemetry: Optional[EngineTelemetry] = None
        # Working-set analytics and the ground-truth audit log: None until
        # attach_workingset / attach_audit wire them (same guard style).
        self.workingset = None
        self.audit = None
        self._telemetry_pools: list[tuple[str, BlockManager]] = []
        tcfg = self.cfg.telemetry
        if tcfg is not None and not isinstance(tcfg, EngineTelemetryConfig):
            # A dict of fields, or another package's config of the same
            # fields (the JAX EngineTelemetryConfig).
            tcfg = EngineTelemetryConfig.from_dict(
                tcfg if isinstance(tcfg, dict) else dataclasses.asdict(tcfg))
        if tcfg is not None and tcfg.enabled:
            self.telemetry = EngineTelemetry(
                tcfg, group=self.cfg.pod_identifier, clock=clock)
            self._telemetry_pools = [("full", self.block_manager)]
            if self.hybrid:
                self._telemetry_pools.append(("swa", self.swa_manager))
            self.telemetry.scrape_pools(self._telemetry_pools)

    def _check_tp(self, offload_spec) -> None:
        """The model against the tp group (the JAX messages), and the
        combinations tensor-parallel serving does not take yet."""
        validate_tp_config(self.cfg.model, self.tp)
        refused = []
        if self.cfg.ragged_attention:
            refused.append("ragged_attention=True (serve it on the padded path)")
        if self._burst > 1:
            refused.append(f"decode_burst={self.cfg.decode_burst} (a captured burst cannot "
                           "hold a gloo collective)")
        if self.hybrid:
            refused.append("a hybrid model (two page pools)")
        if offload_spec is not None:
            refused.append("an offload_spec (per-rank store folders are not ported)")
        if self.cfg.role != "both":
            refused.append(f"role={self.cfg.role!r}")
        if self._fp8_cache:
            refused.append(f"kv_cache_dtype={self.cfg.kv_cache_dtype!r}")
        if refused:
            raise ValueError(f"tensor-parallel serving (tp={self.tp.size}) does not take "
                             + ", ".join(refused))

    def _fuse_projections(self) -> None:
        """``EngineConfig.fuse_projections``, the JAX engine's gate: fuse the
        tree with ``fuse_params`` when asked to or, by default, when
        ``fuse_profitable`` holds at the rank's width, never for an MLA
        model under tp. Under tp (size > 1) the columns are interleaved per
        rank: the model config becomes a copy with ``fused_interleave`` =
        tp, and a pre-fused canonical tree is unfused first (``fuse_params``
        changes nothing on fused leaves, so they would keep the canonical
        order and a rank's shard would straddle q/k/v)."""
        mcfg, tp = self.cfg.model, mesh_tp_size(self.tp)
        blocked = self.tp is not None and mcfg.is_mla
        fuse = self.cfg.fuse_projections
        if fuse is None:
            fuse = fuse_profitable(mcfg, tp=tp) and not blocked
        if fuse and blocked:
            raise ValueError(
                "fuse_projections=True is incompatible with MLA under a mesh "
                "(head-sharded and replicated columns cannot interleave uniformly)")
        if not fuse:
            return
        if tp > 1:
            if "w_qkv" in self.params["layers"][0]:
                self.params = unfuse_params(self.params, mcfg)
            mcfg = dataclasses.replace(mcfg, fused_interleave=tp)
            self.cfg = dataclasses.replace(self.cfg, model=mcfg)
        self.params = fuse_params(self.params, mcfg)

    # -- roles --

    def _check_role(self, role: str) -> None:
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"unknown engine role {role!r} "
                "(expected 'both', 'prefill', or 'decode')")
        if role != "both" and self.tp is not None:
            raise ValueError(
                f"tensor-parallel serving (tp={self.tp.size}) does not take role={role!r}")
        if role != "both" and self.hybrid:
            raise ValueError(
                "prefill/decode disaggregation needs a non-hybrid model "
                "(hybrid restores are all-or-nothing, not chunk-granular)")
        if role != "both" and self.offload_manager is None:
            raise ValueError(
                f"role={role!r} needs an offload spec — the "
                "handoff moves KV through the shared transfer tier")
        if role != "both" and self._store_ppb > 1:
            raise ValueError(
                f"role={role!r} streams one page a chunk block; the offload spec "
                f"stores {self._store_ppb} pages a storage block")

    def attach_handoff(self, coordinator) -> None:
        """Wire a :class:`~..offload.handoff.HandoffCoordinator`.

        On a "prefill"-role engine every chunk-commit store job reports
        chunk start/landed/failed to it; on a "decode"-role engine
        ``enqueue(handoff=True)`` requests consult it to decide between
        waiting, pulling, and falling back to local prefill.
        """
        self.handoff = coordinator

    def set_role(self, role: str) -> str:
        """Re-role a running engine (the fleet controller's
        prefill↔decode flip); returns the previous role.

        Same invariants as construction: a non-"both" role needs an
        offload spec. The flip affects requests admitted *after* it —
        in-flight requests finish under the role they were admitted with.
        """
        self._check_role(role)
        old = self.cfg.role
        self.cfg = dataclasses.replace(self.cfg, role=role)
        return old

    # -- observability taps --

    def attach_workingset(self, tracker) -> None:
        """Wire a telemetry.workingset.WorkingSetTracker into this
        engine's cache paths: admission feeds the "hbm" reuse stream
        (every request's block keys, hit count = resident prefix), the
        block manager's evictions feed the eviction-age histogram, and
        the offload manager's lookups/stores feed the storage-tier
        stream plus the written-never-read ledger. Also declares the
        real HBM pool capacity so the what-if table has its 1x anchor.
        """
        self.workingset = tracker
        self.block_manager.on_evict = tracker.record_eviction_age
        tracker.set_capacity("hbm", self.block_manager.num_pages)
        if self.offload_manager is not None:
            self.offload_manager.workingset = tracker

    def attach_audit(self, audit_log) -> None:
        """Wire a :class:`~..telemetry.audit.AuditLog`: every admitted
        request's realized prefix outcome (HBM hit vs restored vs
        recomputed blocks) is recorded at prefill finish, tagged with the
        request's traceparent and the ScoreFeedback it was routed on, for
        the score-vs-reality join (``telemetry.audit.AuditJoiner``)."""
        self.audit = audit_log

    # -- admission --

    def add_request(self, request_id: str, prompt: Sequence[int],
                    max_new_tokens: int = 16) -> Request:
        """Admit a request: acquire cached prefix pages, allocate the rest,
        and run the prefill step for the uncached suffix (synchronously —
        the request returns ready to decode)."""
        with STEP_GATE.step():
            req = self._admit(request_id, prompt, max_new_tokens)
            self._prefill(req)
            self._finish_prefill(req)
        return req

    def _record_shed(self, outcome: str, priority: int) -> None:
        """Best-effort shed accounting: metric family + flight recorder.
        Never lets telemetry failures interfere with admission."""
        try:
            record_shed("engine.admission", outcome)
            record_flight(KIND_SHED, {
                "site": "engine.admission",
                "outcome": outcome,
                "priority": priority,
            })
        except Exception:
            logger.debug("shed accounting failed", exc_info=True)

    def enqueue(self, request_id: str, prompt: Sequence[int],
                max_new_tokens: int = 16,
                traceparent: Optional[str] = None,
                handoff: bool = False,
                deadline_s: Optional[float] = None,
                priority: int = PRIORITY_NORMAL,
                feedback=None) -> Request:
        """Admit a request for continuous batching: prefill runs from
        ``step()``, chunk-at-a-time interleaved with decode — a long prompt
        stalls running decodes by at most one chunk (``max_prefill_tokens``),
        not its whole prefill (vLLM chunked-prefill scheduling). The storage
        restore is likewise deferred and polled across steps, so a slow
        storage tier costs the restored request latency, never the running
        decodes'.

        ``traceparent`` (the scorer's ``score_tokens`` span, or any W3C
        header value) parents the engine's admission/prefill/decode-step
        spans under the scorer's trace — one trace covers score→serve.
        Requests without one create no spans at all.

        ``handoff=True`` (decode-role engines) marks this request as the
        receiving end of a prefill→decode handoff: ``step()`` holds its
        local prefill for up to ``cfg.handoff_wait_s``, re-arming the
        deferred-restore probe as the prefill peer's chunks land on the
        transfer tier — the KV pull overlaps the running decode batch. A
        failed or timed-out transfer falls back to local prefill (the
        request is never lost).

        ``deadline_s`` attaches an end-to-end budget (falls back to the
        ambient :func:`deadline_scope` when omitted): a deferred storage
        restore that cannot land inside the remaining budget is skipped
        in favor of recompute. When the admission shedder is configured
        (``cfg.shed_target_delay_s``), sustained admission delay sheds
        non-critical requests (:class:`OverloadShedError`) and browns out
        the rest — admitted, but without the storage-restore attempt.

        ``feedback`` (a ``ScoreFeedback``, or any object with its fields) is
        the prediction this request was routed on; with an
        :meth:`attach_audit` log it rides the realized outcome record.
        """
        brownout = False
        if self.shedder is not None:
            verdict = self.shedder.admit(priority)
            if verdict == SHED:
                self._record_shed("shed", priority)
                raise OverloadShedError(
                    "engine.admission", self.shedder.last_delay_s)
            if verdict == BROWNOUT:
                brownout = True
                self._record_shed("brownout", priority)
        if handoff and (self.hybrid or self.offload_manager is None):
            raise ValueError(
                "handoff=True needs a non-hybrid engine with an offload spec "
                "(the transfer arrives via the tier)")
        if traceparent is not None:
            with tracer().span(
                "llm_d.kv_cache.engine.admission",
                parent_traceparent=traceparent,
                request_id=request_id,
                prompt_tokens=len(prompt),
                process=self.cfg.pod_identifier,
            ) as sp:
                req = self._admit(request_id, prompt, max_new_tokens,
                                  defer_restore=True)
                sp.set_attribute(
                    "prefix_hit_blocks",
                    req.cached_len // self.cfg.model.page_size)
            req.traceparent = traceparent
            if self.telemetry is not None:
                self.telemetry.set_traceparent(request_id, traceparent)
        else:
            req = self._admit(request_id, prompt, max_new_tokens,
                              defer_restore=True)
        req.deadline = (
            Deadline.after(deadline_s, clock=self._clock)
            if deadline_s is not None else current_deadline()
        )
        req.priority = priority
        req.feedback = feedback
        if brownout and req.restore_pending:
            # Brownout: admitted, but skip the storage-tier restore —
            # under queue pressure the offload round trip is the first
            # cost to drop (recompute keeps the scheduler moving).
            req.restore_pending = False
        req.enqueued_at = self._clock()
        if handoff:
            req.handoff_deadline = self._clock() + self.cfg.handoff_wait_s
        return req

    def _admit(self, request_id: str, prompt: Sequence[int],
               max_new_tokens: int, defer_restore: bool = False) -> Request:
        """Shared admission: prefix-cache acquisition, storage restore,
        page allocation, registration. No model compute."""
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        req = Request(request_id=request_id, prompt=prompt,
                      max_new_tokens=max_new_tokens)
        page_size = self.cfg.model.page_size
        total_needed = (req.total_len + max_new_tokens + page_size - 1) // page_size + 1
        if total_needed > self.cfg.max_pages_per_seq:
            raise ValueError(
                f"request needs {total_needed} pages "
                f"(prompt {len(prompt)} + {max_new_tokens} new tokens) but "
                f"max_pages_per_seq is {self.cfg.max_pages_per_seq}"
            )
        req.block_hashes = self.processor.tokens_to_kv_block_keys(
            EMPTY_BLOCK_HASH, prompt, self.cfg.model_name
        )

        cached_pages = self.block_manager.acquire_prefix(req.block_hashes)
        if self.hybrid:
            # A resume at depth d needs group 0's whole chain [0, d) but
            # only group 1's trailing window: the blocks covering the last
            # sliding_window tokens (earlier SWA blocks are out of window,
            # never read again). Find the deepest d whose trailing SWA
            # window is resident; out-of-window slots map to the garbage
            # page (attention masks them anyway).
            window = self.cfg.model.sliding_window
            d = len(cached_pages)
            swa_map: dict[int, int] = {}
            start_blk = 0
            while d > 0:
                start_blk = max(0, (d * page_size - window) // page_size)
                pages = self.swa_manager.try_acquire_blocks(req.block_hashes[start_blk:d])
                if pages is not None:
                    swa_map = dict(zip(range(start_blk, d), pages))
                    break
                d -= 1
            if d < len(cached_pages):
                self.block_manager.release(req.block_hashes[d:len(cached_pages)], [])
            cached_pages = cached_pages[:d]
            req.swa_pages = [swa_map.get(i, 0) for i in range(d)]
            req.swa_acquired_from = start_blk if d > 0 else 0
        req.pages = list(cached_pages)
        req.cached_len = len(cached_pages) * page_size
        req.computed_len = req.cached_len
        req.hbm_hit_blocks = len(cached_pages)
        if self.workingset is not None:
            # Admission is the HBM tier's reuse stream: one access per
            # prompt block, hits = the resident prefix length.
            self.workingset.record_accesses(
                "hbm", req.block_hashes, hits=len(cached_pages))

        # Storage tier: extend the HBM prefix hit with blocks resident on
        # shared storage. add_request restores here — one high-priority
        # read, far below a prefill; enqueue defers the lookup and load to
        # step(), where the job is polled across steps (a hybrid model's
        # two-pool restore is all or nothing and stays synchronous: a
        # half-restored window is no resume).
        if self.offload_manager is not None:
            if defer_restore and not self.hybrid:
                req.restore_pending = True
            else:
                self._restore_from_storage(req)

        # Pages for the uncached remainder (incl. partial tail + decode
        # room). Group 1 (SWA) pages are not taken here: prefill and decode
        # take them just in time and give back the out-of-window slots.
        new_pages: list[int] = []
        while len(req.pages) + len(new_pages) < total_needed:
            page = self.block_manager.allocate_page()
            if page is None:
                # Return popped pages and drop the refs on the acquired
                # prefix and any blocks just restored from storage, so a
                # failed admission cannot shrink the pool or pin blocks
                # against eviction.
                n_cached = req.cached_len // page_size
                self.block_manager.free_pages.extend(new_pages)
                self.block_manager.release(req.block_hashes[:n_cached], [])
                if self.hybrid:
                    self.swa_manager.release(
                        req.block_hashes[req.swa_acquired_from:n_cached], [])
                raise RuntimeError("out of KV pages")
            new_pages.append(page)
        req.pages.extend(new_pages)

        req.committed_blocks = req.cached_len // page_size
        # Prefill cursor (a full-prefix hit still recomputes the last
        # prompt token for logits, hence the min with len-1).
        req.prefill_pos = min(req.cached_len, len(req.prompt) - 1)
        self.requests[request_id] = req
        self._running.append(request_id)
        if self.telemetry is not None:
            self.telemetry.on_admitted(request_id, req.cached_len // page_size)
        return req

    def _finish_prefill(self, req: Request) -> int:
        """Prefill done: register the prompt's full blocks in the prefix
        cache and bootstrap decoding with the first generated token (from
        the prefill step's final logits — vLLM semantics: even a
        full-prefix hit recomputes the last prompt token for logits).
        Returns that token."""
        req.table_dev = None  # pages may swap to canonical at commit
        self._commit_full_blocks(req)
        # last_logits is on the host: TTFT ends after the device work.
        req.output.append(int(np.argmax(req.last_logits)))
        if self.telemetry is not None:
            self.telemetry.on_first_token(req.request_id)
        if self.audit is not None:
            self._emit_audit_outcome(req)
        if self._streams_chunks():
            # Prefill pod: the request's life here ends at first token —
            # every full block is now committed (the final chunk's store
            # job just entered the plane; its gather is done, so the pages
            # may be released), the decode pod recomputes the partial tail
            # and the bootstrap token itself, so this token is discarded.
            # Mark the transfer complete-when-settled before finishing so
            # the coordinator flips ``done`` as the last store job lands.
            self.handoff.prefill_finished(req.request_id)
            req.done = True
            self._finish(req)
        elif req.max_new_tokens <= 1:
            req.done = True
            self._finish(req)
        return req.output[-1]

    def _emit_audit_outcome(self, req: Request) -> None:
        """Best-effort ground-truth emission at prefill finish: the
        realized prefix decomposition (HBM hit at admission, restored
        since, recomputed remainder) into the attached AuditLog plus a
        KIND_AUDIT flight record. Never interferes with serving."""
        page_size = self.cfg.model.page_size
        total = len(req.block_hashes)
        realized = min(req.cached_len // page_size, total)
        hbm = min(req.hbm_hit_blocks, realized)
        restored = min(req.restored_blocks, realized - hbm)
        recomputed = max(total - realized, 0)
        try:
            self.audit.record_outcome(
                traceparent=req.traceparent,
                request_id=req.request_id,
                pod=self.cfg.pod_identifier,
                total_blocks=total,
                hbm_blocks=hbm,
                restored_blocks=restored,
                recomputed_blocks=recomputed,
                feedback=req.feedback,
            )
        except Exception:
            logger.debug("audit outcome failed", exc_info=True)
        try:
            record_flight(KIND_AUDIT, {
                "op": "outcome",
                "request_id": req.request_id,
                "pod": self.cfg.pod_identifier,
                "total_blocks": total,
                "hbm_blocks": hbm,
                "restored_blocks": restored,
                "recomputed_blocks": recomputed,
            })
        except Exception:
            logger.debug("audit flight record failed", exc_info=True)

    # -- storage restore --

    def _restore_from_storage(self, req: Request) -> None:
        """Load storage-resident blocks that extend the HBM prefix hit
        (synchronous: ``add_request``, and a hybrid model's ``enqueue``)."""
        if self.hybrid:
            self._restore_from_storage_hybrid(req)
            return
        page_size = self.cfg.model.page_size
        first_missing = req.cached_len // page_size
        restore_hashes = self._stored_prefix(req, first_missing)
        if not restore_hashes:
            return
        pages: list[int] = []
        for _ in restore_hashes:
            page = self.block_manager.allocate_page()
            if page is None:
                break
            pages.append(page)
        whole = len(pages) - len(pages) % self._store_ppb
        self.block_manager.free_pages.extend(pages[whole:])
        pages = pages[:whole]
        if not pages:
            return
        restore_hashes = restore_hashes[: len(pages)]

        started = time.monotonic()
        job = self.offload_handlers.async_load_blocks(
            self._load_transfers(restore_hashes, pages))
        result = None
        deadline = started + 30.0
        while result is None and time.monotonic() < deadline:
            result = self._drain_offload(target_job=job)
            if result is None:
                time.sleep(0.002)
        if result is None:
            # Timed out: cancel so a late completion can never scatter into
            # pages about to be recycled.
            self.offload_handlers.wait_job(job, timeout_s=5.0)
        if result is None or not result.success:
            record_engine_restore("timeout" if result is None else "failure")
            logger.warning("storage restore failed for %d blocks", len(pages))
            self.block_manager.free_pages.extend(pages)
            return
        elapsed = time.monotonic() - started
        record_engine_restore("success", elapsed)
        record_offload_restore(self._offload_medium, elapsed)
        self._observe_restore_latency(elapsed)

        # Register restored blocks in the prefix cache (the HBM BlockStored
        # is emitted through commit so the index learns the HBM copy).
        canonical = self._commit_restored_blocks(
            req, first_missing, restore_hashes, pages)
        req.pages.extend(canonical)
        req.cached_len += len(canonical) * page_size
        req.computed_len = req.cached_len
        req.restored_blocks += len(canonical)

    def _restore_from_storage_hybrid(self, req: Request) -> None:
        """Storage restore for hybrid models, all or nothing.

        A resume at depth d needs group 0's whole chain [0, d) and group
        1's trailing window of d, and only the window: earlier SWA blocks
        are masked for every later position, and SWA KV depends on
        activations that depend on the missing keys, so an incomplete
        window cannot be resumed. Group 1 stores hold exactly the blocks in
        window at commit, so a whole-chain resume normally finds its
        window; anything less skips the restore.
        """
        page_size = self.cfg.model.page_size
        wb = -(-self.cfg.model.sliding_window // page_size)
        d = req.cached_len // page_size  # HBM-resident depth
        remaining = req.block_hashes[d:]
        if not remaining:
            return
        n_stored = self.offload_manager.lookup(remaining)
        if n_stored == 0:
            return
        depth_end = d + n_stored
        # Window slots below d are already resident (the trailing-window
        # acquisition made sure of it); only [load_from, depth_end) loads.
        load_from = max(depth_end - wb, d, 0)
        win_hashes = req.block_hashes[load_from:depth_end]
        if self.offload_manager.lookup(win_hashes, group_idx=1) < len(win_hashes):
            logger.info("hybrid restore skipped: SWA window of depth %d not fully stored",
                        depth_end)
            return
        g0_hashes = req.block_hashes[d:depth_end]
        g0_pages = [self.block_manager.allocate_page() for _ in g0_hashes]
        g1_pages = [self.swa_manager.allocate_page() for _ in win_hashes]
        if None in g0_pages or None in g1_pages:
            self.block_manager.free_pages.extend(p for p in g0_pages if p)
            self.swa_manager.free_pages.extend(p for p in g1_pages if p)
            return

        job0 = self.offload_handlers.async_load_blocks(
            [(h, [p]) for h, p in zip(g0_hashes, g0_pages)])
        job1 = self.offload_handlers.async_load_blocks(
            [(h, [p]) for h, p in zip(win_hashes, g1_pages)], group_idx=1)
        targets = {job0, job1}
        results: dict = {}
        deadline = time.monotonic() + 30.0
        while len(results) < 2 and time.monotonic() < deadline:
            results.update(self._drain_offload_multi(targets))
            if len(results) < 2:
                time.sleep(0.002)
        for job in targets - set(results):
            # Timed out: cancel so a late completion can never scatter into
            # pages about to be recycled.
            self.offload_handlers.wait_job(job, timeout_s=5.0)
            results[job] = None
        if any(r is None or not r.success for r in results.values()):
            logger.warning("hybrid storage restore failed; recomputing")
            self.block_manager.free_pages.extend(g0_pages)
            self.swa_manager.free_pages.extend(g1_pages)
            return

        def toks(i):
            return req.prompt[i * page_size:(i + 1) * page_size]

        canonical0 = self.block_manager.commit_blocks(
            g0_hashes, g0_pages, [toks(d + i) for i in range(n_stored)],
            req.block_hashes[d - 1] if d > 0 else EMPTY_BLOCK_HASH)
        req.pages.extend(canonical0)
        canonical1 = self.swa_manager.commit_blocks(
            win_hashes, g1_pages, [toks(load_from + i) for i in range(len(win_hashes))],
            req.block_hashes[load_from - 1] if load_from > 0 else EMPTY_BLOCK_HASH)
        req.swa_pages.extend([0] * (load_from - len(req.swa_pages)))
        req.swa_pages.extend(canonical1)
        req.cached_len = depth_end * page_size
        req.computed_len = req.cached_len
        req.restored_blocks += len(canonical0)
        # Blocks acquired for the old depth that now sit out of the window
        # go back (their refs drop, their slots map to the garbage page).
        self._swa_reclaim(req)

    def _observe_restore_latency(self, elapsed: float) -> None:
        """Fold a successful restore's wall time into the EMA (the first
        sample seeds it) and feed ``on_restore_latency``."""
        ema = self._restore_latency_ema
        self._restore_latency_ema = (
            elapsed if ema == 0.0 else ema + 0.2 * (elapsed - ema))
        if self.on_restore_latency is not None:
            self.on_restore_latency(elapsed)

    def _stored_prefix(self, req: Request, first_missing: int) -> list:
        """The page hashes from ``first_missing`` on that the store holds as
        a consecutive run. With storage blocks of ``pages_per_block`` > 1
        pages, whole blocks keyed by their last page's hash, counted from a
        storage-block boundary only (a partly cached block is recomputed)."""
        remaining = req.block_hashes[first_missing:]
        ppb = self._store_ppb
        if len(remaining) < ppb or first_missing % ppb:
            return []
        return remaining[:self.offload_manager.lookup(remaining[ppb - 1::ppb]) * ppb]

    def _load_transfers(self, hashes: list, pages: list[int]) -> list:
        """``(file key, pages)`` of a restore: one page a file, or whole
        storage blocks keyed by their last page's hash."""
        ppb = self._store_ppb
        return [(hashes[i + ppb - 1], list(pages[i:i + ppb]))
                for i in range(0, len(pages) - ppb + 1, ppb)]

    def _commit_restored_blocks(self, req: Request, first_missing: int,
                                hashes: list, pages: list[int]) -> list[int]:
        """Adopt storage-restored blocks into the prefix cache — the shared
        commit tail of the synchronous and deferred restore paths. Returns
        the canonical pages (``commit_blocks`` may swap duplicates)."""
        page_size = self.cfg.model.page_size
        tokens_per_block = [
            req.prompt[(first_missing + i) * page_size:
                       (first_missing + i + 1) * page_size]
            for i in range(len(hashes))
        ]
        parent = (req.block_hashes[first_missing - 1] if first_missing > 0
                  else EMPTY_BLOCK_HASH)
        return self.block_manager.commit_blocks(
            hashes, pages, tokens_per_block, parent)

    def _start_deferred_restore(self, req: Request) -> None:
        """Kick off the enqueue-path storage restore.

        Unlike the synchronous path, the load lands in the pages the
        request already owns for those blocks (allocated at admission for
        the uncached remainder), so no extra pages are taken; on success
        ``commit_blocks`` adopts canonical pages and frees duplicates.

        Deadline gate: a request whose budget has expired — or whose
        remaining budget is smaller than what a restore typically costs
        (streaming EMA of past successes) — skips the storage tier and
        recomputes. A restore that lands after the caller stopped
        waiting is pure waste.
        """
        req.restore_pending = False
        dl = req.deadline
        if dl is not None:
            remaining = dl.remaining_s()
            if remaining <= 0 or (0 < self._restore_latency_ema
                                  and remaining < self._restore_latency_ema):
                record_engine_restore("deadline_skip")
                self._record_shed("restore_skip", req.priority)
                logger.debug(
                    "skipping storage restore for %s: %.3fs budget left, "
                    "restores take ~%.3fs", req.request_id,
                    max(0.0, remaining), self._restore_latency_ema)
                return
        page_size = self.cfg.model.page_size
        first_missing = req.cached_len // page_size
        restore_hashes = self._stored_prefix(req, first_missing)
        if not restore_hashes:
            return
        pages = req.pages[first_missing:first_missing + len(restore_hashes)]
        job = self.offload_handlers.async_load_blocks(
            self._load_transfers(restore_hashes, pages))
        self._restore_job_ids.add(job)
        started = time.monotonic()
        req.restore_job = (job, first_missing, restore_hashes, pages,
                           started + 30.0, started)

    def _poll_deferred_restore(self, req: Request) -> bool:
        """Advance an in-flight deferred restore. Returns True once settled
        (success, failure, or timeout) — prefill may proceed; False while
        the load is still in flight (the step goes on decoding)."""
        job, first_missing, hashes, pages, deadline, started = req.restore_job
        result = self._restore_results.pop(job, None)
        if result is None:
            result = self._drain_offload(target_job=job)
        if result is not None:
            self._restore_job_ids.discard(job)
        if result is None:
            if time.monotonic() < deadline:
                return False
            # Timed out: non-blocking cancel (timeout 0) — kvio marks the
            # job cancelled so it can never scatter, and parks its staging
            # buffers; blocking here would stall every running decode.
            self.offload_handlers.wait_job(job, timeout_s=0.0)
            self._restore_job_ids.discard(job)
            self._restore_results.pop(job, None)
            req.restore_job = None
            record_engine_restore("timeout")
            logger.warning("deferred storage restore timed out; recomputing")
            return True
        req.restore_job = None
        if not result.success:
            record_engine_restore("failure", time.monotonic() - started)
            logger.warning("deferred storage restore failed; recomputing")
            return True
        elapsed = time.monotonic() - started
        record_engine_restore("success", elapsed)
        record_offload_restore(self._offload_medium, elapsed)
        self._observe_restore_latency(elapsed)
        page_size = self.cfg.model.page_size
        canonical = self._commit_restored_blocks(req, first_missing, hashes, pages)
        req.pages[first_missing:first_missing + len(canonical)] = canonical
        req.cached_len = (first_missing + len(canonical)) * page_size
        req.computed_len = max(req.computed_len, req.cached_len)
        req.restored_blocks += len(canonical)
        req.committed_blocks = max(req.committed_blocks,
                                   first_missing + len(canonical))
        req.prefill_pos = min(req.cached_len, len(req.prompt) - 1)
        req.table_dev = None  # pages may have swapped to canonical
        return True

    def _commit_prefill_chunk(self, req: Request) -> None:
        """Prefill-role mid-prefill commit: push the blocks this chunk
        completed into the prefix cache and the transfer tier."""
        before = req.committed_blocks
        self._commit_full_blocks(
            req, upto=req.computed_len // self.cfg.model.page_size)
        if req.committed_blocks != before:
            # commit_blocks may have swapped duplicate pages to canonical;
            # the cached device table would keep scattering into the
            # abandoned copies.
            req.table_dev = None

    def _handoff_gate(self, req: Request) -> bool:
        """Decide whether a handoff-admitted request may prefill locally.

        True once the handoff settled — transfer complete, peer failed
        (fallback), or deadline hit (timeout) — and prefill proceeds from
        whatever prefix is resident; False while the wait is live, in
        which case this step skips the prefill and keeps decoding.
        """
        target = len(req.prompt) // self.cfg.model.page_size
        if req.cached_len // self.cfg.model.page_size >= target:
            # Every full prompt block is resident; only the partial tail
            # and the last prompt token remain, and those always
            # recompute locally.
            self._handoff_settle(req, "complete")
            return True
        st = (self.handoff.state(req.request_id)
              if self.handoff is not None else None)
        if st is not None and st.failed:
            # Prefill peer died mid-handoff: fall back to local prefill —
            # landed blocks still count, the request is re-prefilled
            # here, never lost.
            self._handoff_settle(req, "fallback")
            return True
        if self._clock() >= req.handoff_deadline:
            self._handoff_settle(req, "timeout")
            return True
        # Re-arm the transfer probe: more peer chunks may have landed
        # since the last round. The lookup is cheap and a load job starts
        # only when the stored prefix actually grew.
        if req.restore_job is None:
            self._start_deferred_restore(req)
        if req.restore_job is not None:
            return False  # pull in flight — polled next step
        if st is not None and st.done:
            # Transfer settled and everything restorable was pulled; any
            # remainder (shed chunks) recomputes locally.
            self._handoff_settle(req, "complete")
            return True
        return False

    def _handoff_settle(self, req: Request, outcome: str) -> None:
        req.handoff_deadline = None
        if self.handoff is not None:
            self.handoff.decode_settled(req.request_id, outcome)

    # -- prefill --

    def _page_table_for(self, req: Request) -> np.ndarray:
        table = np.zeros((self.cfg.max_pages_per_seq,), np.int32)
        table[: len(req.pages)] = req.pages
        return table

    # -- hybrid: the SWA group's pages --

    def _swa_table_for(self, req: Request) -> np.ndarray:
        table = np.zeros((self.cfg.max_pages_per_seq,), np.int32)
        table[: len(req.swa_pages)] = req.swa_pages
        return table

    def _swa_ensure(self, req: Request, upto_block: int) -> None:
        """Extend the request's SWA pages through ``upto_block``
        (inclusive), just in time, so the pool's peak demand is window +
        chunk, not prompt length."""
        while len(req.swa_pages) <= upto_block:
            page = self.swa_manager.allocate_page()
            if page is None:
                raise RuntimeError("out of SWA KV pages")
            req.swa_pages.append(page)

    def _swa_reclaim(self, req: Request) -> None:
        """Give the request's out-of-window SWA pages back.

        Slots below the window's start are never read again by this request
        (attention masks them). Private pages not yet committed go back to
        the pool; committed blocks drop this request's reference but stay
        cached: a committed SWA block i serves a resume at block boundary
        i + 1 (whose trailing window covers it), and LRU eviction reclaims
        the space, emitting BlockRemoved as for full-attention blocks.
        Reclaimed slots map to the garbage page.
        """
        page_size = self.cfg.model.page_size
        first_in_window = max(0, req.computed_len - self.cfg.model.sliding_window) // page_size
        start = req.swa_acquired_from
        limit = min(first_in_window, len(req.swa_pages))
        if limit <= start:
            return
        committed: list[int] = []
        for i in range(start, limit):
            page = req.swa_pages[i]
            if not page:
                continue
            h = req.block_hashes[i] if i < len(req.block_hashes) else None
            info = self.swa_manager.blocks.get(h) if h is not None else None
            if info is not None and info.page == page:
                committed.append(h)
            else:
                self.swa_manager.free_pages.append(page)
            req.swa_pages[i] = 0
        if committed:
            self.swa_manager.release(committed, [])
        req.swa_acquired_from = limit

    def _release_burst_transients(self, chunk: list[Request]) -> None:
        """Give back the SWA pages pre-extended for a burst that cannot run:
        slots past each request's current decode block exist only for this
        burst (a finished burst has advanced ``computed_len`` past every
        slot it wrote), so they are private and uncommitted."""
        page_size = self.cfg.model.page_size
        for req in chunk:
            keep = req.computed_len // page_size + 1
            while len(req.swa_pages) > keep:
                page = req.swa_pages.pop()
                if page:
                    self.swa_manager.free_pages.append(page)

    def _prefill(self, req: Request) -> None:
        """Run the model over the whole uncached prompt suffix, chunked."""
        while req.prefill_pos is not None:
            self._prefill_chunk(req)

    def _prefill_chunk(self, req: Request) -> None:
        """One prefill chunk at ``req.prefill_pos``; advances it (None once
        the prompt is fully prefilled, with ``last_logits`` populated —
        only the final chunk's logits are copied to the host)."""
        page_size = self.cfg.model.page_size
        if req.table_dev is None:
            req.table_dev = torch.from_numpy(
                self._page_table_for(req))[None, :].to(self.device)

        pos = req.prefill_pos
        chunk = req.prompt[pos:pos + self._chunk_cap()]
        # Bucket the padded length to powers of two (in pages), as the JAX
        # engine does for its jit cache: the same few shapes every run.
        pages_needed = max(1, (len(chunk) + page_size - 1) // page_size)
        bucket = 1
        while bucket < pages_needed:
            bucket *= 2
        tokens = np.zeros((1, bucket * page_size), np.int64)
        tokens[0, : len(chunk)] = chunk
        tokens_dev = torch.from_numpy(tokens).to(self.device)
        ctx = torch.tensor([pos], dtype=torch.int32, device=self.device)
        new = torch.tensor([len(chunk)], dtype=torch.int32, device=self.device)

        if self.hybrid:
            # SWA pages arrive just in time for this chunk's blocks, and the
            # out-of-window slots go back after it: a long prompt's peak SWA
            # demand is window + chunk.
            self._swa_ensure(req, (pos + len(chunk) - 1) // page_size)
            swa_table = torch.from_numpy(self._swa_table_for(req))[None, :].to(self.device)
            logits = forward_hybrid(
                self.params, self.cfg.model, tokens_dev, self.k_cache, self.v_cache,
                self.k_swa, self.v_swa, req.table_dev, swa_table, ctx, new,
                last_only=True)[0]
            req.computed_len = pos + len(chunk)  # _swa_reclaim reads it
            self._swa_reclaim(req)
        else:
            logits, self.k_cache, self.v_cache = forward_prefill(
                self.params, self.cfg.model, tokens_dev, self.k_cache, self.v_cache,
                req.table_dev, ctx, new, last_only=True, tp=self.tp)
        if self.telemetry is not None:
            # Padding-waste accounting: len(chunk) real tokens rode a
            # dispatch padded to the power-of-two page bucket.
            self.telemetry.on_dispatch_tokens(len(chunk), bucket * page_size)
        # last_only: logits row 0 is the chunk's final valid position.
        self._advance_prefill(req, len(chunk), logits[0, 0])

    def _chunk_cap(self) -> int:
        """Tokens per prefill chunk: ``max_prefill_tokens`` in whole pages."""
        page_size = self.cfg.model.page_size
        return max(page_size, self.cfg.max_prefill_tokens // page_size * page_size)

    @staticmethod
    def _advance_prefill(req: Request, n: int, logits_row: torch.Tensor) -> None:
        """Move ``req``'s prefill cursor past a computed chunk of ``n``
        tokens. On the prompt's last chunk the cursor becomes None and
        ``logits_row`` (the chunk's final token's) is copied to the host as
        ``last_logits``; earlier chunks' logits never leave the device."""
        end = req.prefill_pos + n
        req.computed_len = end
        if end >= len(req.prompt):
            req.last_logits = logits_row.cpu().numpy()
            req.prefill_pos = None
        else:
            req.prefill_pos = end

    def _commit_full_blocks(self, req: Request,
                            upto: Optional[int] = None) -> None:
        """Register newly computed full prompt blocks in the prefix cache.

        ``upto`` (prefill-role chunk commits) caps the commit at that many
        leading blocks: each prefill chunk's full blocks enter the prefix
        cache and the write-through store as they are computed instead of
        at prefill end, so a decode peer can start pulling chunk 1 while
        chunk 2 is still on the device.
        """
        page_size = self.cfg.model.page_size
        n_full = len(req.prompt) // page_size
        if upto is not None:
            n_full = min(n_full, upto)
        # committed_blocks, not cached_len: incremental chunk commits
        # advance it past the admission prefix.
        first_new = max(req.committed_blocks, req.cached_len // page_size)
        if n_full <= first_new:
            return
        new_hashes = req.block_hashes[first_new:n_full]
        new_pages = req.pages[first_new:n_full]
        tokens_per_block = [
            req.prompt[i * page_size:(i + 1) * page_size]
            for i in range(first_new, n_full)
        ]
        parent = (
            req.block_hashes[first_new - 1] if first_new > 0 else EMPTY_BLOCK_HASH
        )
        canonical = self.block_manager.commit_blocks(
            new_hashes, new_pages, tokens_per_block, parent
        )
        # Adopt canonical pages (duplicates swapped to the resident copy).
        req.pages[first_new:n_full] = canonical
        req.committed_blocks = max(req.committed_blocks, n_full)
        # Group 1: commit only the slots still holding pages; the blocks
        # that fell out of the window were reclaimed mid-prefill and are
        # gone from group 1 by design.
        swa_first = max(first_new, req.swa_acquired_from)
        swa_commit = self.hybrid and swa_first < n_full
        if swa_commit:
            req.swa_pages[swa_first:n_full] = self.swa_manager.commit_blocks(
                req.block_hashes[swa_first:n_full], req.swa_pages[swa_first:n_full],
                [req.prompt[i * page_size:(i + 1) * page_size]
                 for i in range(swa_first, n_full)],
                req.block_hashes[swa_first - 1] if swa_first > 0 else EMPTY_BLOCK_HASH)

        # Write-through to the storage tier (async; writes may be shed under
        # pressure, degrading to future cache misses).
        if self.offload_handlers is not None:
            # Whole storage blocks completed by this commit, keyed by their
            # last page's hash (one page a block unless the spec says more).
            ppb = self._store_ppb
            page_of = {req.block_hashes[end - 1]: list(req.pages[end - ppb:end])
                       for end in range((first_new // ppb + 1) * ppb, n_full + 1, ppb)}
            to_store = self.offload_manager.prepare_store(list(page_of))
            if to_store:
                job = self.offload_handlers.async_store_blocks(
                    [(h, page_of[h]) for h in to_store])
                self._pending_store_jobs[job] = list(to_store)
                if self._streams_chunks():
                    # One handoff chunk per store job: the coordinator
                    # hears landed/failed from the drain that settles it.
                    self._handoff_store_jobs[job] = (
                        req.request_id, list(to_store))
                    self.handoff.on_chunk_start(req.request_id, to_store)
            if swa_commit:
                # Group 1: only the in-window committed blocks exist, which
                # is what a trailing-window restore needs. The job is not
                # registered in _pending_store_jobs: the manager learns a
                # block is stored from its group-0 job, and a group-1 file
                # without its group-0 chain (the group-0 write shed) must
                # not be advertised.
                swa_hashes = req.block_hashes[swa_first:n_full]
                to_store1 = self.offload_manager.prepare_store(swa_hashes, group_idx=1)
                if to_store1:
                    spage_of = dict(zip(swa_hashes, req.swa_pages[swa_first:n_full]))
                    self.offload_handlers.async_store_blocks(
                        [(h, [spage_of[h]]) for h in to_store1], group_idx=1)

    # -- decode --

    def step(self) -> dict[str, int]:
        """One scheduling step: advance at most one prefill chunk, then one
        decode step for every decoding request.

        Returns {request_id: newest_token}. Decode is batched with padding
        up to ``max_batch`` rows per call. ``enqueue``d requests prefill
        here, chunk-at-a-time, oldest first. With ``ragged_attention`` the
        chunk and the decode rows share one dispatch (``_ragged_step``).
        A profiler capture's start and stop wait for it (``STEP_GATE``).
        """
        with STEP_GATE.step():
            return self._step()

    def _step(self) -> dict[str, int]:
        tel = self.telemetry
        step_t0 = self._clock() if tel is not None else 0.0
        self.poll_offload()
        emitted: dict[str, int] = {}
        just_prefilled: Optional[str] = None
        # Start every pending deferred restore up front, not just the FIFO
        # head's: the loads are independent jobs, so a younger request's
        # storage fetch overlaps the older request's restore+prefill.
        for rid in list(self._running):
            req = self.requests[rid]
            if req.prefill_pos is not None and req.restore_pending:
                self._start_deferred_restore(req)
        # The FIFO head's prefill chunk, unless its deferred restore is
        # still in flight or its handoff wait is live (then no prefill
        # this step; decodes run on).
        prefill_req = next(
            (self.requests[rid] for rid in self._running
             if self.requests[rid].prefill_pos is not None), None)
        if prefill_req is not None and prefill_req.enqueued_at is not None:
            # First scheduler pick: the wait is the admission delay (the
            # queueing behind older prefills or an in-flight burst), the
            # shedder's CoDel signal. A deferred restore may still follow;
            # that wait is a storage cost, deliberately not part of it.
            admission_delay = self._clock() - prefill_req.enqueued_at
            record_admission_delay(admission_delay)
            if self.shedder is not None:
                self.shedder.observe_delay(admission_delay)
            prefill_req.enqueued_at = None
            if tel is not None:
                tel.on_first_schedule(prefill_req.request_id)
        if (prefill_req is not None and prefill_req.restore_job is not None
                and not self._poll_deferred_restore(prefill_req)):
            prefill_req = None
        if (prefill_req is not None and prefill_req.handoff_deadline is not None
                and not self._handoff_gate(prefill_req)):
            prefill_req = None
        if self.cfg.ragged_attention:
            emitted.update(self._ragged_step(prefill_req))
        else:
            if prefill_req is not None:
                req = prefill_req
                if req.traceparent is not None:
                    with tracer().span(
                        "llm_d.kv_cache.engine.prefill_chunk",
                        parent_traceparent=req.traceparent,
                        request_id=req.request_id,
                        prefill_pos=req.prefill_pos,
                        process=self.cfg.pod_identifier,
                    ):
                        self._prefill_chunk(req)
                else:
                    self._prefill_chunk(req)
                if req.prefill_pos is not None and self._streams_chunks():
                    # Prefill pod: commit this chunk's full blocks now so
                    # the transfer streams chunk-granular (the final chunk
                    # commits in _finish_prefill as usual).
                    self._commit_prefill_chunk(req)
                if req.prefill_pos is None:
                    emitted[req.request_id] = self._finish_prefill(req)
                    # Its decode starts next step: including it in this
                    # step's decode batch would overwrite the prefill
                    # bootstrap token just emitted.
                    just_prefilled = req.request_id
            active = [self.requests[rid] for rid in self._running
                      if not self.requests[rid].done
                      and self.requests[rid].prefill_pos is None
                      and rid != just_prefilled]
            for chunk_start in range(0, len(active), self.cfg.max_batch):
                chunk = active[chunk_start:chunk_start + self.cfg.max_batch]
                if self._burst > 1:
                    emitted.update(self._decode_chunk_burst(chunk, self._burst))
                else:
                    emitted.update(self._decode_chunk(chunk))
        for rid in list(self._running):
            req = self.requests[rid]
            if req.done:
                self._finish(req)
        if tel is not None:
            # After the step's token reads: on the card the interval covers
            # the device work of every dispatch that emitted a token.
            tel.on_step(self._clock() - step_t0, bool(emitted), self._telemetry_pools)
        return emitted

    def _ragged_step(self, prefill_req: Optional[Request]) -> dict[str, int]:
        """One scheduling step on the ragged single-kernel path.

        Active decode rows still group into chunks of ``max_batch`` (the
        same per-dispatch activation bound as the padded path); the FIFO
        head's prefill chunk rides the first dispatch as one extra long
        row. A request that finishes prefill here was assembled before its
        bootstrap token existed, so it cannot also decode this step — the
        padded path's ``just_prefilled`` exclusion, structurally.
        """
        emitted: dict[str, int] = {}
        active = [self.requests[rid] for rid in self._running
                  if not self.requests[rid].done
                  and self.requests[rid].prefill_pos is None]
        b = self.cfg.max_batch
        chunks = [active[i:i + b] for i in range(0, len(active), b)] or [[]]
        for ci, chunk in enumerate(chunks):
            p_req = prefill_req if ci == 0 else None
            if chunk or p_req is not None:
                emitted.update(self._ragged_dispatch(chunk, p_req))
        return emitted

    def _ragged_dispatch(self, decode_rows: list[Request],
                         prefill_req: Optional[Request]) -> dict[str, int]:
        """One mixed prefill+decode dispatch over the flat ragged axis.

        Decode rows are 1-token rows; the prefill chunk (when present) is
        the last, longer row. The flat axis holds exactly the real tokens
        and the row axis the real rows (no power-of-two buckets, see the
        module docstring).
        """
        n_dec = len(decode_rows)
        flat, ctx, tables = self._decode_batch_arrays(decode_rows, n_dec)
        q_lens = [1] * n_dec
        if prefill_req is not None:
            pos = prefill_req.prefill_pos
            chunk = prefill_req.prompt[pos:pos + self._chunk_cap()]
            flat = np.concatenate([flat, np.asarray(chunk, np.int64)])
            ctx = np.append(ctx, np.int32(pos))
            tables = np.concatenate([tables, self._page_table_for(prefill_req)[None]])
            q_lens.append(len(chunk))
        row_starts = np.zeros((len(q_lens) + 1,), np.int32)
        np.cumsum(q_lens, out=row_starts[1:])
        dev = self.device
        span_cm = None
        if prefill_req is not None and prefill_req.traceparent is not None:
            span_cm = tracer().span(
                "llm_d.kv_cache.engine.prefill_chunk",
                parent_traceparent=prefill_req.traceparent,
                request_id=prefill_req.request_id,
                prefill_pos=prefill_req.prefill_pos,
                process=self.cfg.pod_identifier,
            )
            span_cm.__enter__()
        try:
            logits, self.k_cache, self.v_cache = forward_ragged(
                self.params, self.cfg.model,
                torch.from_numpy(flat[None]).to(dev),
                self.k_cache, self.v_cache,
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(row_starts).to(dev),
                torch.from_numpy(ctx).to(dev),
                capacity_tokens=jax_flat_bucket(len(flat)),
            )
        finally:
            if span_cm is not None:
                span_cm.__exit__(None, None, None)
        if self.telemetry is not None:
            # The flat axis is not padded: the dispatch carries exactly its
            # real tokens (JAX reports its power-of-two bucket here).
            self.telemetry.on_dispatch_tokens(len(flat), len(flat))

        out: dict[str, int] = {}
        if decode_rows:
            out.update(self._apply_decoded(
                decode_rows, torch.argmax(logits[:n_dec], dim=-1).cpu().numpy()))
        if prefill_req is not None:
            # The prefill row is the last; its logits are its final token's.
            self._advance_prefill(prefill_req, q_lens[-1], logits[-1])
            if prefill_req.prefill_pos is None:
                out[prefill_req.request_id] = self._finish_prefill(prefill_req)
            elif self._streams_chunks():
                self._commit_prefill_chunk(prefill_req)
        return out

    def _streams_chunks(self) -> bool:
        """A prefill-role engine with a coordinator: it commits each prefill
        chunk's full blocks to the transfer tier as soon as they are
        computed, and a request's life here ends at its first token."""
        return self.handoff is not None and self.cfg.role == "prefill"

    def _decode_batch_arrays(self, chunk: list[Request], rows: int):
        """Per-row decode inputs padded to ``rows``: (last tokens, computed
        context, page tables). The last token may have come from sampling
        with its KV not yet computed — that is why positions derive from
        ``computed_len``."""
        last = np.zeros((rows,), np.int64)
        ctx = np.zeros((rows,), np.int32)
        tables = np.zeros((rows, self.cfg.max_pages_per_seq), np.int32)
        for i, req in enumerate(chunk):
            last[i] = req.output[-1] if req.output else req.prompt[-1]
            ctx[i] = req.computed_len
            tables[i] = self._page_table_for(req)
        return last, ctx, tables

    def _decode_chunk(self, chunk: list[Request]) -> dict[str, int]:
        # Pad to max_batch so every decode call has one shape; padded rows
        # have new_lens=0 and ctx 0 (their writes go to the garbage page,
        # their attention returns zeros, their logits are ignored).
        last, ctx, tables = self._decode_batch_arrays(chunk, self.cfg.max_batch)
        new_lens = np.zeros((self.cfg.max_batch,), np.int32)
        new_lens[: len(chunk)] = 1
        dev = self.device
        tokens = torch.from_numpy(last[:, None]).to(dev)
        args = (torch.from_numpy(ctx).to(dev), torch.from_numpy(new_lens).to(dev))
        if self.hybrid:
            swa_tables = np.zeros_like(tables)
            for i, req in enumerate(chunk):
                # The new token's KV lands in block computed_len // page: that
                # SWA slot needs a live page.
                self._swa_ensure(req, req.computed_len // self.cfg.model.page_size)
                swa_tables[i] = self._swa_table_for(req)
            logits = forward_hybrid(
                self.params, self.cfg.model, tokens, self.k_cache, self.v_cache,
                self.k_swa, self.v_swa, torch.from_numpy(tables).to(dev),
                torch.from_numpy(swa_tables).to(dev), *args)[0]
        else:
            logits, self.k_cache, self.v_cache = forward_decode(
                self.params, self.cfg.model, tokens, self.k_cache, self.v_cache,
                torch.from_numpy(tables).to(dev), *args, tp=self.tp)
        next_tokens = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        if self.telemetry is not None:
            # Padding-waste accounting for the padded path: len(chunk) real
            # tokens ride a max_batch-row dispatch.
            self.telemetry.on_dispatch_tokens(len(chunk), self.cfg.max_batch)
        out = self._apply_decoded(chunk, next_tokens)
        if self.hybrid:
            for req in chunk:
                self._swa_reclaim(req)
        return out

    def _decode_chunk_burst(self, chunk: list[Request], steps: int) -> dict[str, int]:
        """Fused multi-token decode (the JAX ``_decode_chunk_burst``): one
        dispatch emits up to ``steps``
        greedy tokens a row; each row decodes until its own remaining budget
        and freezes after. On the card the dispatch is one replay of the
        engine's captured burst (``_BurstGraph``); on the CPU the same loop
        runs eagerly.

        A hybrid model's SWA table is pre-extended through every page the
        burst writes, frozen for it, and the slots that slid out of the
        window are reclaimed once a burst. When the SWA pool cannot cover
        the burst's transient pages, the pages taken for it go back and the
        engine latches single-token decoding (before any capture)."""
        if self.hybrid and self._burst_degraded:
            return self._decode_chunk(chunk)
        page_size = self.cfg.model.page_size
        last, ctx, tables = self._decode_batch_arrays(chunk, self.cfg.max_batch)
        budgets = np.zeros((self.cfg.max_batch,), np.int32)
        swa_tables = np.zeros_like(tables)
        for i, req in enumerate(chunk):
            budgets[i] = req.max_new_tokens - len(req.output)
            if self.hybrid:
                taken = min(steps, int(budgets[i]))
                try:
                    self._swa_ensure(req, (req.computed_len + max(taken, 1) - 1) // page_size)
                except RuntimeError:
                    self._release_burst_transients(chunk)
                    self._burst_degraded = True
                    logger.warning(
                        "SWA pool cannot cover a %d-token burst transient; decoding "
                        "single-token from now on (size num_swa_pages for window + "
                        "decode_burst to keep bursts)", steps)
                    return self._decode_chunk(chunk)
                swa_tables[i] = self._swa_table_for(req)
        all_tables = (tables, swa_tables) if self.hybrid else (tables,)
        if self.device.type == "cuda":
            if self._burst_graph is None:
                self._burst_graph = _BurstGraph(self, steps, last, ctx, all_tables)
            toks = self._burst_graph.replay(last, ctx, all_tables, budgets)
        else:
            dev = self.device
            args = (torch.from_numpy(ctx).to(dev), torch.from_numpy(budgets).to(dev), steps)
            tabs = [torch.from_numpy(t).to(dev) for t in all_tables]
            last_dev = torch.from_numpy(last).to(dev)
            if self.hybrid:
                toks = forward_decode_steps_hybrid(
                    self.params, self.cfg.model, last_dev, self.k_cache, self.v_cache,
                    self.k_swa, self.v_swa, *tabs, *args)[0]
            else:
                toks = forward_decode_steps(
                    self.params, self.cfg.model, last_dev, self.k_cache, self.v_cache,
                    *tabs, *args)[0]
            toks = toks.cpu().numpy()
        out = {}
        tel = self.telemetry
        # The burst's tokens are on the host: hooks run after its device work
        # and outside the captured graph.
        now = self._clock() if tel is not None else 0.0
        for i, req in enumerate(chunk):
            taken = min(steps, int(budgets[i]))
            req.output.extend(int(t) for t in toks[i, :taken])
            req.computed_len += taken
            out[req.request_id] = req.output[-1]
            if tel is not None:
                tel.on_decode_tokens(req.request_id, taken, now)
            if req.traceparent is not None:
                with tracer().span(
                    "llm_d.kv_cache.engine.decode_step",
                    parent_traceparent=req.traceparent,
                    request_id=req.request_id,
                    tokens=taken,
                    computed_len=req.computed_len,
                    process=self.cfg.pod_identifier,
                ):
                    pass  # event-style span: marks the emission point
            if len(req.output) >= req.max_new_tokens:
                req.done = True
            if self.hybrid:
                self._swa_reclaim(req)
        return out

    def _apply_decoded(self, reqs: list[Request], next_tokens: np.ndarray) -> dict[str, int]:
        """Append each request's decoded token (row i of ``next_tokens``,
        already on the host): the previous token's KV is now computed.
        Feeds the ITL hook and the decode-step span. Marks a request done
        at ``max_new_tokens``. Returns {request_id: token}."""
        out = {}
        tel = self.telemetry
        now = self._clock() if tel is not None else 0.0
        for req, tok in zip(reqs, next_tokens):
            req.computed_len += 1
            req.output.append(int(tok))
            out[req.request_id] = int(tok)
            if tel is not None:
                tel.on_decode_tokens(req.request_id, 1, now)
            if req.traceparent is not None:
                with tracer().span(
                    "llm_d.kv_cache.engine.decode_step",
                    parent_traceparent=req.traceparent,
                    request_id=req.request_id,
                    tokens=1,
                    computed_len=req.computed_len,
                    process=self.cfg.pod_identifier,
                ):
                    pass  # event-style span: marks the emission point
            if len(req.output) >= req.max_new_tokens:
                req.done = True
        return out

    # -- offload completions --

    def _drain_offload(self, target_job: Optional[int] = None):
        results = self._drain_offload_multi(
            {target_job} if target_job is not None else frozenset())
        return results.get(target_job)

    def _drain_offload_multi(self, targets) -> dict:
        """Single dispatcher for offload completions.

        Every finished job is routed here exactly once: store jobs report
        their stored blocks to the manager (minus shed blocks), corrupt
        loads de-advertise theirs, and results of awaited jobs (ids in
        ``targets``) are returned; a deferred restore's result is stashed
        for its request's poll.
        """
        results: dict = {}
        # Placement gauges exist only for backends with a native I/O pool
        # (the object-store backend transfers through its client library).
        io_pool = getattr(self.offload_handlers, "io", None)
        if io_pool is not None:
            record_io_pool_placement(io_pool)
        for res in self.offload_handlers.get_finished():
            record_offload_result(self._offload_medium, res)
            hashes = self._pending_store_jobs.pop(res.job_id, None)
            if hashes is not None:
                if res.success:
                    shed = set(res.shed_hashes)
                    stored = [h for h in hashes if h not in shed]
                    if stored:
                        self.offload_manager.complete_store(stored)
                else:
                    logger.warning("write-through store job %d failed", res.job_id)
            ho = self._handoff_store_jobs.pop(res.job_id, None)
            if ho is not None and self.handoff is not None:
                # Prefill-role chunk commit settled (its request may be
                # gone already): stream the chunk completion, or its
                # failure, to the coordinator so the decode peer's next
                # probe sees the landed blocks.
                ho_rid, ho_hashes = ho
                shed = set(res.shed_hashes) if res.success else set()
                landed = [h for h in ho_hashes if h not in shed]
                if res.success and landed:
                    self.handoff.on_chunk_landed(
                        ho_rid, landed, shed=[h for h in ho_hashes if h in shed])
                else:
                    self.handoff.on_chunk_failed(ho_rid, ho_hashes)
            if res.corrupt_hashes:
                # Checksum-failed files are already quarantined by the
                # worker; de-advertise the blocks.
                self.offload_manager.complete_load_failure(res.corrupt_hashes)
            if res.job_id in targets:
                results[res.job_id] = res
            elif res.job_id in self._restore_job_ids:
                self._restore_results[res.job_id] = res
        return results

    def poll_offload(self) -> None:
        """Reap finished offload jobs (called each step)."""
        if self.offload_handlers is None:
            return
        self._drain_offload()

    def flush_offload(self, timeout_s: float = 30.0) -> None:
        """Block until all pending store jobs complete (testing/shutdown)."""
        deadline = time.monotonic() + timeout_s
        while self._pending_store_jobs and time.monotonic() < deadline:
            self.poll_offload()
            time.sleep(0.005)

    # -- lifecycle --

    def _finish(self, req: Request, outcome: str = "finished") -> None:
        if self.telemetry is not None:
            self.telemetry.on_finish(req.request_id, outcome)
        if req.handoff_deadline is not None:
            # Aborted while waiting on a transfer: settle the ledger so
            # the coordinator never holds a ghost entry.
            self._handoff_settle(req, "failed")
        if self._streams_chunks() and req.prefill_pos is not None:
            # Prefill-role death/abort mid-prefill: no more chunks will
            # ever commit — flip the transfer failed so the decode peer
            # stops waiting and re-prefills the remainder itself.
            self.handoff.fail(req.request_id, outcome)
        if req.restore_job is not None:
            # Abort with a deferred restore in flight: non-blocking cancel —
            # kvio marks the job cancelled (never scatters) and parks its
            # staging buffers, so recycling the pages is safe immediately.
            self.offload_handlers.wait_job(req.restore_job[0], timeout_s=0.0)
            self._restore_job_ids.discard(req.restore_job[0])
            self._restore_results.pop(req.restore_job[0], None)
            req.restore_job = None
        if req.request_id in self._running:
            self._running.remove(req.request_id)
        self._release(req)
        # Drop the bookkeeping entry: callers keep the Request object they
        # got from add_request/enqueue.
        self.requests.pop(req.request_id, None)

    def _release(self, req: Request) -> None:
        page_size = self.cfg.model.page_size
        n_hashed = min(len(req.prompt) // page_size, len(req.block_hashes))
        # Only blocks up to the committed watermark are registered in the
        # block manager; an aborted mid-prefill request's later pages are
        # private and must be freed directly.
        n_comm = min(req.committed_blocks, n_hashed)
        committed_pages = set(req.pages[:n_comm])
        orphans = [p for p in req.pages[n_comm:] if p not in committed_pages]
        self.block_manager.release(req.block_hashes[:n_comm], orphans)
        if self.hybrid:
            # The SWA group: this request references blocks from
            # swa_acquired_from on (earlier slots were reclaimed as the
            # window slid). Committed blocks stay cached for resumes; LRU
            # eviction reclaims their space and emits BlockRemoved.
            start = req.swa_acquired_from
            swa_committed = set(req.swa_pages[:n_comm])
            swa_orphans = [p for p in req.swa_pages[n_comm:] if p and p not in swa_committed]
            self.swa_manager.release(req.block_hashes[start:n_comm], swa_orphans)

    def abort_request(self, request_id: str) -> bool:
        """Preempt a running request: release its pages and references.

        Pending write-through stores for its blocks are harmless
        (content-addressed, idempotent) and are left to complete; an
        in-flight deferred restore is cancelled in ``_finish`` before its
        pages are released. Returns False for unknown/finished requests."""
        req = self.requests.get(request_id)
        if req is None or req.done:
            return False
        req.done = True
        self._finish(req, outcome="aborted")
        return True

    def reset_cache(self) -> None:
        """Drop all KV state (e.g. after a weight update).

        In-flight requests are aborted and *released* first so their
        unhashed pages (partial tail + decode room) return to the pool.
        """
        for rid in list(self._running):
            req = self.requests[rid]
            req.done = True
            self._finish(req, outcome="aborted")
        self.block_manager.clear()
        if self.hybrid:
            self.swa_manager.clear(emit=False)

    def generate(self, request_id: str, prompt: Sequence[int],
                 max_new_tokens: int = 16) -> list[int]:
        """Convenience: admit one request and run it to completion."""
        req = self.add_request(request_id, prompt, max_new_tokens)
        while not req.done:
            self.step()
        return req.output
