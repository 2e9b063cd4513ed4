"""Scatter-gather scoring router over the sharded indexer fleet.

Port of ``llmd_kv_cache_tpu/cluster/router.py``: the same plans, early
exit, failover, degraded serving, breakers, hedging under the budget,
batched fan-out with its fallback to the old wire, epoch pinning and
residency bonus, so equal shard answers give an equal ``RouterScore``.
One difference: an ``UNIMPLEMENTED`` status is recognised only when
``grpc`` is already imported (an error of a ``grpc`` that was never
imported cannot have reached here), so the router never imports it.

The scheduler-side counterpart of the shard replicas: tokens are
content-addressed locally (same ``ChunkedTokenDatabase`` + prefix-key
cache as an embedded indexer), block keys are partitioned by the
consistent-hash ring, and ``LookupBlocks`` RPCs fan out per owning
shard. Scoring then runs locally with the ordinary
``LongestPrefixScorer`` over the merged hit map.

Early exit generalizes the index's chunked lookup to cross-shard fan-out:
keys are processed in chain order, ``fanoutChunkBlocks`` at a time, and
fanning stops at the first chunk that breaks the longest-prefix chain —
deep misses never pay cross-shard round trips.

Failure policy lifts the resilience primitives to inter-node scope: every
shard sits behind a :class:`~llmd_kv_cache_tpu_torch.resilience.policy.
CircuitBreaker`; a broken or unreachable shard is skipped, its keys
retried on their replica owners (``replicationFactor``), and only if no
owner is reachable are the keys served *degraded* — treated as index
misses under ``degradedServeMode: skip`` (the default), so scoring
never blocks on a dead shard.

Gray failures — a shard that is slow rather than dead — never trip the
breaker, so the gather *hedges* instead ("The Tail at Scale"): each
shard's RPC latency feeds a streaming quantile estimate, and a lookup
that outlives its shard's ``hedgeQuantile`` trigger is re-issued to the
keys' next replica owner; the first response wins and the loser is
cancelled. Hedges are capped by a token-bucket budget refilled by
primary traffic (``hedgeBudgetRate``), so a melting-down fleet cannot
double its own load. The whole chunk gather runs under ONE overall
deadline — ``fanoutDeadlineS`` capped by the ambient request deadline —
rather than accumulating per-future waits; keys still unresolved at the
deadline are served degraded, never silently late.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.keys import BlockHash, PodEntry
from ..core.token_processor import ChunkedTokenDatabase, TokenProcessorConfig
from ..metrics.collector import (
    record_batch_rpc,
    record_hedge,
    record_ring_load,
    record_shard_degraded_lookup,
    record_shard_fanout,
    record_shard_plan_cache,
    record_shard_rpc,
)
from ..resilience.deadline import Deadline, current_deadline
from ..resilience.hedging import HedgeBudget, LatencyQuantileTracker
from ..resilience.policy import CircuitBreaker
from ..scoring.scorer import KVBlockScorerConfig, create_scorer
from ..telemetry.flight_recorder import KIND_HEDGE
from ..telemetry.flight_recorder import record as record_event
from ..telemetry.tracing import tracer
from ..utils.logging import get_logger
from ..utils.lru import LRUCache
from .config import DEGRADED_SERVE_FAIL, ClusterConfig
from .remote import ShardClient
from .ring import HashRing

logger = get_logger("cluster.router")


class DegradedShardError(RuntimeError):
    """Raised under ``degradedServeMode: fail`` when owners of some keys
    are all unreachable."""

    def __init__(self, shards: Sequence[str]):
        super().__init__(f"shards unreachable: {sorted(shards)}")
        self.shards = sorted(shards)


@dataclass
class RouterScore:
    """One scatter-gather scoring result."""

    scores: dict[str, float] = field(default_factory=dict)
    # Unreachable shards whose keys no replica owner could serve either.
    # Non-empty means the prefix view was incomplete and scores are a
    # lower bound. A failed shard fully covered by replica failover is
    # NOT listed (scores stayed exact).
    degraded_shards: list[str] = field(default_factory=list)
    # True when any serving shard was itself warming (post-restart) or
    # any shard was skipped — routers should widen their fallback.
    degraded: bool = False
    # Fan-out accounting (bench/debug).
    blocks: int = 0
    hit_blocks: int = 0
    rpcs: int = 0
    # Hedged fan-out accounting: hedges issued for this score, and how
    # many beat their primary (the rest were wasted-but-bounded work).
    hedges: int = 0
    hedge_wins: int = 0
    # True when the overall gather deadline expired with lookups still in
    # flight — the result is a degraded lower bound, not silently late.
    deadline_expired: bool = False
    # Topology epoch this scatter-gather was pinned to (0 = no membership
    # plane attached) and how many responses arrived stamped with a newer
    # epoch — those are served degraded-not-fatal while the router's ring
    # catches up for the next score.
    epoch: int = 0
    cross_epoch: int = 0


@dataclass
class _Attempt:
    """One in-flight LookupBlocks attempt inside a chunk gather."""

    shard: str
    keys: list[BlockHash]
    keyset: frozenset
    future: Future
    started: float
    kind: str  # "primary" (incl. failover) | "hedge"
    hedged: bool = False  # a hedge decision was already made for this attempt
    settled: bool = False


class ShardRouter:
    """Client-side scatter-gather scorer for a sharded indexer fleet."""

    def __init__(
        self,
        config: ClusterConfig,
        token_processor_config: Optional[TokenProcessorConfig] = None,
        scorer_config: Optional[KVBlockScorerConfig] = None,
        clients: Optional[dict[str, ShardClient]] = None,
    ):
        if not config.enabled:
            raise ValueError("ClusterConfig has no shardAddresses")
        self.cfg = config
        self.ring: HashRing = config.build_ring()
        self.token_processor = ChunkedTokenDatabase(
            token_processor_config or TokenProcessorConfig()
        )
        self.scorer = create_scorer(
            scorer_config or KVBlockScorerConfig(),
            block_size_tokens=self.token_processor.block_size,
        )
        members = config.membership()
        self.clients = clients if clients is not None else {
            sid: ShardClient(config.address_of(sid),
                             timeout_s=config.fanout_timeout_s)
            for sid in members
        }
        self.breakers = {
            sid: CircuitBreaker(
                target=f"shard:{sid}",
                failure_threshold=config.breaker_failure_threshold,
                reset_timeout_s=config.breaker_reset_timeout_s,
            )
            for sid in members
        }
        # Ring-plan prefix cache: block keys are chained FNV hashes, so
        # keys[-1] fingerprints the entire chain — (ring version, chain
        # length, last key) uniquely identifies the per-key owner plan at
        # the same trust level as the token-processor's prefix-key cache.
        self._plan_cache: Optional[LRUCache] = (
            LRUCache(config.plan_cache_size) if config.plan_cache_size > 0 else None
        )
        self.plan_hits = 0
        self.plan_misses = 0
        # Hedging holds extra attempts in flight, and a gray-slow shard's
        # RPCs linger on their worker threads long after the gather moved
        # on (cancel() cannot stop a running future) — size the pool for
        # primary + hedge + several stale stragglers per shard, so a slow
        # shard cannot starve the next gather's submits.
        per_shard = 4 if config.hedge_enabled else 2
        self._executor = ThreadPoolExecutor(
            max_workers=max(4, per_shard * len(members)),
            thread_name_prefix="kvtpu-shard-fanout",
        )
        # Tail-tolerant hedging state: per-shard latency quantiles arm the
        # trigger, the budget caps hedges at a fraction of primary load.
        self.hedge_latency = LatencyQuantileTracker(
            quantile=config.hedge_quantile
        )
        self.hedge_budget = HedgeBudget(
            rate=config.hedge_budget_rate, burst=config.hedge_budget_burst
        )
        # Residency-aware disaggregated routing (scoring.residency): when
        # attached, ``score(role="decode")`` adds each decode pod's
        # transferred-prefix bonus on top of the scatter-gathered prefix
        # scores — the shards know nothing about in-flight handoffs, the
        # tracker is router-local state fed by the handoff coordinator.
        self.residency = None
        # Batched fan-out (docs/architecture.md "Native data plane"): one
        # framed multi-chunk RPC per shard per gather window instead of
        # one RPC per chunk. Engaged only when every client speaks the
        # batch surface — injected test doubles that implement only
        # lookup_blocks keep the per-chunk wire untouched. Shards whose
        # *server* predates the frame (UNIMPLEMENTED) are remembered here
        # and served through the legacy per-chunk call from then on.
        self._batch_capable = config.fanout_batch_chunks > 0 and all(
            hasattr(c, "lookup_blocks_batch") for c in self.clients.values()
        )
        self._legacy_shards: set[str] = set()
        self.batch_rpcs = 0
        self.batch_fallbacks = 0
        # Epoch discipline (cluster.membership): each scatter-gather pins
        # one epoch, responses stamped newer are degraded-not-fatal, and
        # an epoch bump swaps the ring plan atomically (one attribute
        # store — in-flight gathers keep their pinned ring snapshot).
        self.membership = None
        self.epoch_bumps = 0
        self.cross_epoch_responses = 0
        record_ring_load(self.ring.load())

    def attach_residency(self, tracker) -> None:
        """Wire a :class:`~..scoring.residency.ResidencyTracker` for
        role-aware decode scoring."""
        self.residency = tracker

    def attach_membership(self, table) -> None:
        """Wire a :class:`~.membership.MembershipTable`: scores stamp its
        epoch on every shard RPC, piggybacked newer epochs are learned
        back into it, and its bumps swap this router's ring plan."""
        self.membership = table
        table.add_epoch_listener(self._on_epoch_bump)
        if table.epoch != self.ring.epoch:
            self._on_epoch_bump(table.epoch)

    def _on_epoch_bump(self, epoch: int) -> None:
        """Atomic ring-plan swap on a topology-epoch bump. Membership is
        unchanged (a membership change builds a whole new router config);
        the new ring differs only in ``version``/``epoch``, so the plan
        cache misses cleanly and in-flight gathers finish on the ring
        object they captured."""
        self.ring = self.ring.with_epoch(epoch)
        self.epoch_bumps += 1
        record_ring_load(self.ring.load())

    # -- plan cache -------------------------------------------------------

    def plan(self, keys: Sequence[BlockHash],
             ring: Optional[HashRing] = None) -> tuple[str, ...]:
        """Primary owner per key, via the chained-fingerprint plan cache.

        ``ring`` lets a scatter-gather plan against the ring snapshot it
        pinned at entry rather than ``self.ring`` (which an epoch bump
        may swap mid-score)."""
        if not keys:
            return ()
        if ring is None:
            ring = self.ring
        cache = self._plan_cache
        if cache is None:
            return tuple(ring.owner(k) for k in keys)
        cache_key = (ring.version, len(keys), keys[-1])
        plan = cache.get(cache_key)
        hit = plan is not None
        if hit:
            self.plan_hits += 1
        else:
            self.plan_misses += 1
            plan = tuple(ring.owner(k) for k in keys)
            cache.add(cache_key, plan)
        record_shard_plan_cache(hit)
        return plan

    # -- fan-out ----------------------------------------------------------

    def _shard_rpc(
        self,
        shard: str,
        keys: list[BlockHash],
        pods: Optional[Sequence[str]],
        timeout: Optional[float] = None,
        deadline: Optional[Deadline] = None,
        hedge: bool = False,
        epoch: int = 0,
    ) -> dict:
        """One breaker-guarded LookupBlocks against one shard."""
        breaker = self.breakers[shard]
        if not breaker.allow():
            record_shard_rpc(shard, "skipped")
            raise ConnectionError(f"breaker open for shard {shard}")
        timeout_s = self.cfg.fanout_timeout_s if timeout is None else timeout
        kwargs = {}
        if deadline is not None:
            kwargs["deadline"] = deadline
        if hedge:
            kwargs["hedge"] = True
        if epoch:
            kwargs["epoch"] = epoch
        try:
            try:
                res = self.clients[shard].lookup_blocks(
                    keys, pods, timeout=timeout_s, **kwargs
                )
            except TypeError:
                # Injected test doubles may predate the deadline/hedge
                # kwargs; the wire fields are best-effort metadata.
                res = self.clients[shard].lookup_blocks(
                    keys, pods, timeout=timeout_s
                )
        except Exception:
            breaker.record_failure()
            record_shard_rpc(shard, "failure")
            raise
        breaker.record_success()
        record_shard_rpc(shard, "success")
        return res

    def _shard_rpc_batch(
        self,
        shard: str,
        keys: list[BlockHash],
        key_chunk: dict[BlockHash, int],
        pods: Optional[Sequence[str]],
        timeout: Optional[float] = None,
        deadline: Optional[Deadline] = None,
        hedge: bool = False,
        epoch: int = 0,
    ) -> dict:
        """One breaker-guarded LookupBlocksBatch: the shard's keys for a
        whole gather window, framed as ordered chunks. Falls back to the
        flat per-chunk wire *inside the same attempt* when the shard's
        server predates the batch frame (UNIMPLEMENTED), and remembers it
        in ``_legacy_shards`` so later gathers skip the probe."""
        breaker = self.breakers[shard]
        if not breaker.allow():
            record_shard_rpc(shard, "skipped")
            raise ConnectionError(f"breaker open for shard {shard}")
        timeout_s = self.cfg.fanout_timeout_s if timeout is None else timeout
        by_chunk: dict[int, list[BlockHash]] = {}
        for k in keys:
            by_chunk.setdefault(key_chunk[k], []).append(k)
        chunks = [by_chunk[i] for i in sorted(by_chunk)]
        kwargs = {}
        if deadline is not None:
            kwargs["deadline"] = deadline
        if hedge:
            kwargs["hedge"] = True
        if epoch:
            kwargs["epoch"] = epoch
        try:
            if shard not in self._legacy_shards:
                try:
                    res = self.clients[shard].lookup_blocks_batch(
                        chunks, pods, timeout=timeout_s, **kwargs
                    )
                    self.batch_rpcs += 1
                    record_batch_rpc("batched")
                    breaker.record_success()
                    record_shard_rpc(shard, "success")
                    return res
                except Exception as e:
                    if not self._unimplemented(e):
                        raise
                    # Old shard: not a failure, just an older wire. Replay
                    # the window flat — the plain lookup has no per-chunk
                    # state, so one call over all keys answers the same
                    # hits the per-chunk loop would have gathered.
                    self._legacy_shards.add(shard)
            self.batch_fallbacks += 1
            record_batch_rpc("fallback")
            try:
                res = self.clients[shard].lookup_blocks(
                    keys, pods, timeout=timeout_s, **kwargs
                )
            except TypeError:
                res = self.clients[shard].lookup_blocks(
                    keys, pods, timeout=timeout_s
                )
        except Exception:
            breaker.record_failure()
            record_shard_rpc(shard, "failure")
            raise
        breaker.record_success()
        record_shard_rpc(shard, "success")
        return res

    @staticmethod
    def _unimplemented(exc: BaseException) -> bool:
        grpc = sys.modules.get("grpc")
        if grpc is not None and isinstance(exc, grpc.RpcError):
            code = exc.code() if callable(getattr(exc, "code", None)) else None
            return code == grpc.StatusCode.UNIMPLEMENTED
        return isinstance(exc, (AttributeError, NotImplementedError))

    def _fanout_chunk(
        self,
        keys: Sequence[BlockHash],
        pods: Optional[Sequence[str]],
        plan: Sequence[str],
        stats: RouterScore,
        key_chunk: Optional[dict[BlockHash, int]] = None,
        ring: Optional[HashRing] = None,
        epoch: int = 0,
    ) -> dict[BlockHash, list[PodEntry]]:
        """Scatter one chunk across its owning shards under one overall
        gather deadline, hedging slow lookups and failing dead shards'
        keys over to replica owners; returns the merged hit map.

        With ``key_chunk`` (key → global chunk index) the unit is a whole
        gather *window*: each shard gets ONE framed LookupBlocksBatch RPC
        carrying its keys grouped by chunk, instead of one RPC per chunk.
        All the per-key machinery — rf-bounded failover, hedging, the
        overall deadline — is chunk-agnostic and applies unchanged;
        hedged and rerouted attempts re-frame their keys the same way.

        ``ring``/``epoch`` are the snapshot this gather is pinned to:
        reroutes and hedges resolve replica owners against that ring
        even if an epoch bump swaps ``self.ring`` mid-gather, and every
        RPC of the gather carries the same epoch stamp."""
        if ring is None:
            ring = self.ring
        rf = max(1, self.cfg.replication_factor)
        deadline = current_deadline()
        overall_s = self.cfg.fanout_deadline_s or self.cfg.fanout_timeout_s
        if deadline is not None:
            overall_s = deadline.cap_timeout(overall_s)
        gather_deadline = time.monotonic() + overall_s

        merged: dict[BlockHash, list[PodEntry]] = {}
        resolved: set[BlockHash] = set()
        dead: set[BlockHash] = set()
        # Per-key shards already attempted (primary, failover, or hedge):
        # a key visits each of its <= rf owners at most once, bounding the
        # gather at rf attempts per key.
        tried: dict[BlockHash, set[str]] = {
            k: {o} for k, o in zip(keys, plan)
        }
        failed_shards: set[str] = set()
        late_shards: set[str] = set()
        # Shards whose attempt in THIS gather ran slow enough to be
        # hedged (or failed outright): re-issues prefer other owners, so
        # a healthy shard's natural tail hedge never routes keys INTO
        # the straggler it is racing around.
        suspect: set[str] = set()
        attempts: list[_Attempt] = []

        def submit(shard: str, skeys: list[BlockHash], kind: str) -> None:
            budget_s = gather_deadline - time.monotonic()
            timeout_s = min(self.cfg.fanout_timeout_s, max(0.001, budget_s))
            if key_chunk is not None:
                fut = self._executor.submit(
                    self._shard_rpc_batch, shard, skeys, key_chunk, pods,
                    timeout_s, deadline, kind == "hedge", epoch,
                )
            else:
                fut = self._executor.submit(
                    self._shard_rpc, shard, skeys, pods, timeout_s, deadline,
                    kind == "hedge", epoch,
                )
            attempts.append(_Attempt(
                shard=shard, keys=skeys, keyset=frozenset(skeys),
                future=fut, started=time.monotonic(), kind=kind,
            ))
            stats.rpcs += 1
            if kind != "hedge":
                self.hedge_budget.on_primary()

        def covered_elsewhere(key: BlockHash, exclude: _Attempt) -> bool:
            return any(
                a is not exclude and not a.settled and key in a.keyset
                for a in attempts
            )

        def cancel_covered_losers() -> None:
            # First response won: cancel in-flight attempts whose keys are
            # all resolved. cancel() only stops a not-yet-running future;
            # one mid-RPC completes harmlessly and still feeds the
            # breaker/latency trackers from its worker thread.
            for a in attempts:
                if a.settled or not a.keyset.issubset(resolved):
                    continue
                a.settled = True
                a.future.cancel()
                if a.kind == "hedge":
                    record_hedge(a.shard, "loss")
                    record_event(KIND_HEDGE, {
                        "shard": a.shard, "outcome": "loss",
                    })

        def next_owner(key: BlockHash) -> Optional[str]:
            cands = [
                s for s in ring.owners(key, rf) if s not in tried[key]
            ]
            if not cands:
                return None
            return next((s for s in cands if s not in suspect), cands[0])

        def reroute(failed_keys: list[BlockHash]) -> None:
            regroup: dict[str, list[BlockHash]] = {}
            for key in failed_keys:
                nxt = next_owner(key)
                if nxt is None:
                    dead.add(key)
                else:
                    tried[key].add(nxt)
                    regroup.setdefault(nxt, []).append(key)
            for shard, skeys in regroup.items():
                submit(shard, skeys, "primary")

        def settle(a: _Attempt) -> None:
            a.settled = True
            try:
                res = a.future.result(timeout=0)
            except Exception:
                failed_shards.add(a.shard)
                suspect.add(a.shard)
                if a.kind == "hedge":
                    record_hedge(a.shard, "failed")
                orphans = [
                    k for k in a.keys
                    if k not in resolved and k not in dead
                    and not covered_elsewhere(k, a)
                ]
                if orphans:
                    reroute(orphans)
                return
            self.hedge_latency.observe(
                a.shard, time.monotonic() - a.started
            )
            fresh = [k for k in a.keys if k not in resolved]
            resolved.update(fresh)
            for key, entries in res["hits"].items():
                merged.setdefault(key, entries)
            if res["degraded"]:
                stats.degraded = True
            # Cross-epoch response: the shard has moved to a newer
            # topology than this gather pinned. Its hits still count —
            # degraded-not-fatal — and the piggybacked epoch advances
            # the membership table so the NEXT score plans on the new
            # ring (the in-flight gather keeps its pinned snapshot).
            resp_epoch = int(res.get("epoch", 0) or 0)
            if epoch and resp_epoch > epoch:
                stats.degraded = True
                stats.cross_epoch += 1
                self.cross_epoch_responses += 1
                if self.membership is not None:
                    self.membership.observe_epoch(
                        resp_epoch, source=f"router:{a.shard}")
            if a.kind == "hedge" and fresh:
                stats.hedge_wins += 1
                record_hedge(a.shard, "win")
                record_event(KIND_HEDGE, {
                    "shard": a.shard, "outcome": "win",
                    "keys": len(fresh),
                })
            cancel_covered_losers()

        def maybe_hedge(a: _Attempt) -> None:
            a.hedged = True  # one hedge decision per attempt
            # Slow enough to hedge = suspect for the rest of the gather,
            # whether or not the budget grants the hedge.
            suspect.add(a.shard)
            if not self.hedge_budget.spend():
                record_hedge(a.shard, "denied")
                return
            regroup: dict[str, list[BlockHash]] = {}
            for key in a.keys:
                if key in resolved or key in dead:
                    continue
                nxt = next_owner(key)
                if nxt is not None:
                    tried[key].add(nxt)
                    regroup.setdefault(nxt, []).append(key)
            if not regroup:
                return
            for shard, skeys in regroup.items():
                submit(shard, skeys, "hedge")
                stats.hedges += 1
                record_hedge(shard, "issued")
                record_event(KIND_HEDGE, {
                    "shard": shard, "outcome": "issued",
                    "slow_shard": a.shard, "keys": len(skeys),
                })

        # Initial scatter: group keys by primary owner.
        groups: dict[str, list[BlockHash]] = {}
        for key, owner in zip(keys, plan):
            groups.setdefault(owner, []).append(key)
        for shard, skeys in groups.items():
            submit(shard, skeys, "primary")

        hedging = self.cfg.hedge_enabled and rf > 1
        while True:
            if all(k in resolved or k in dead for k in keys):
                break
            live = [a for a in attempts if not a.settled]
            if not live:
                dead.update(
                    k for k in keys if k not in resolved and k not in dead
                )
                break
            now = time.monotonic()
            if now >= gather_deadline:
                # Overall gather deadline: stop waiting. The straggler
                # RPCs finish (or time out) on their worker threads and
                # feed breakers/latency stats; their keys are served
                # degraded rather than late.
                for a in live:
                    a.settled = True
                    a.future.cancel()
                    late_shards.add(a.shard)
                dead.update(
                    k for k in keys if k not in resolved and k not in dead
                )
                stats.deadline_expired = True
                break
            wait_s = gather_deadline - now
            if hedging:
                for a in live:
                    if a.hedged or a.kind == "hedge":
                        continue
                    trigger = self.hedge_latency.value(a.shard)
                    if trigger is None:
                        continue  # cold estimate: never hedge blind
                    due_in = (a.started
                              + max(trigger, self.cfg.hedge_min_delay_s)
                              - now)
                    if due_in <= 0:
                        maybe_hedge(a)
                    else:
                        wait_s = min(wait_s, due_in)
                live = [a for a in attempts if not a.settled]
            done, _pending = wait(
                [a.future for a in live],
                timeout=max(0.0005, wait_s),
                return_when=FIRST_COMPLETED,
            )
            if done:
                for a in [x for x in attempts if not x.settled]:
                    if a.future.done():
                        settle(a)

        # A failed shard whose keys a replica fully served does NOT
        # degrade the result (scores are exact; the failure still shows
        # in breaker state and kvtpu_shard_rpcs_total). Only keys no
        # reachable owner could serve make scores a lower bound.
        if dead:
            unreachable = (failed_shards | late_shards) or set(
                plan[i] for i, k in enumerate(keys) if k in dead
            )
            stats.degraded = True
            stats.degraded_shards = sorted(
                set(stats.degraded_shards) | unreachable
            )
            record_shard_degraded_lookup(len(unreachable))
        return merged

    # -- scoring ----------------------------------------------------------

    def score(
        self,
        tokens: Sequence[int],
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
        role: str = "",
    ) -> RouterScore:
        """Scatter-gather GetPodScores: returns scores plus degradation
        detail (shard metadata mirrors the ScoreResponse wire fields).

        ``role="decode"`` adds transferred-prefix residency bonuses when
        a tracker is attached (``attach_residency``) — same semantics as
        the embedded indexer's role-aware scoring.
        """
        started = time.perf_counter()
        result = RouterScore()
        dl = current_deadline()
        if dl is not None:
            # Fail fast before any fan-out work: an already-expired
            # request must be shed by the caller, not served late.
            dl.check("cluster.router.score")
        # Pin the whole scatter-gather to ONE ring/epoch snapshot: an
        # epoch bump mid-score swaps self.ring for the next caller, but
        # this gather's plan, failovers, and hedges all resolve against
        # the topology it entered with.
        ring = self.ring
        epoch = self.membership.epoch if self.membership is not None else 0
        result.epoch = epoch
        with tracer().span(
            "llm_d.kv_cache.cluster.fanout",
            model=model_name,
            token_count=len(tokens),
            shard_count=len(ring.shards),
            role=role,
            process="router",
        ) as span:
            keys = self.token_processor.tokens_to_kv_block_keys(
                0, list(tokens), model_name
            )
            result.blocks = len(keys)
            if not keys:
                return result
            plan = self.plan(keys, ring=ring)
            merged: dict[BlockHash, list[PodEntry]] = {}
            chunk = self.cfg.fanout_chunk_blocks
            if chunk <= 0:
                chunk = len(keys)
            # Batched fan-out: one gather window covers fanoutBatchChunks
            # early-exit chunks with a single framed RPC per shard.
            batch = self.cfg.fanout_batch_chunks if self._batch_capable else 0
            window = chunk * batch if batch > 0 else chunk
            stop = False
            for start in range(0, len(keys), window):
                wkeys = keys[start:start + window]
                key_chunk = None
                if batch > 0 and len(wkeys) > chunk:
                    key_chunk = {
                        k: (start + i) // chunk for i, k in enumerate(wkeys)
                    }
                found = self._fanout_chunk(
                    wkeys, pod_identifiers, plan[start:start + window],
                    result, key_chunk=key_chunk, ring=ring, epoch=epoch,
                )
                # Chunk-order truncation: replay the per-chunk loop's
                # early-exit decisions over the window's merged map, so a
                # batched gather is byte-identical to the per-chunk wire.
                # Same soundness argument as Index.lookup_chunked: a
                # partial chunk proves the consecutive-from-0 run ended
                # inside it, so later chunks cannot change any score.
                for cstart in range(start, start + len(wkeys), chunk):
                    ckeys = keys[cstart:cstart + chunk]
                    cfound = {k: found[k] for k in ckeys if k in found}
                    if not cfound:
                        stop = True
                        break
                    merged.update(cfound)
                    if len(cfound) < len(ckeys):
                        stop = True
                        break
                if stop:
                    break
            if result.degraded_shards and (
                self.cfg.degraded_serve_mode == DEGRADED_SERVE_FAIL
            ):
                raise DegradedShardError(result.degraded_shards)
            result.hit_blocks = len(merged)
            result.scores = self.scorer.score(keys, merged)
            if role == "decode" and self.residency is not None:
                bonus = self.residency.bonus(
                    keys,
                    set(pod_identifiers) if pod_identifiers else None,
                )
                for pod, b in bonus.items():
                    result.scores[pod] = result.scores.get(pod, 0.0) + b
            span.set_attribute("block_count", len(keys))
            span.set_attribute("block_hit_count", len(merged))
            span.set_attribute("rpcs", result.rpcs)
            span.set_attribute("degraded_shards", len(result.degraded_shards))
            span.set_attribute("hedges", result.hedges)
        record_shard_fanout(time.perf_counter() - started)
        return result

    def get_pod_scores(
        self,
        tokens: Sequence[int],
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
    ) -> dict[str, float]:
        return self.score(tokens, model_name, pod_identifiers).scores

    def debug_view(self) -> dict:
        return {
            "ring": self.ring.describe(),
            "breakers": {s: b.state for s, b in self.breakers.items()},
            "plan_cache": {
                "hits": self.plan_hits,
                "misses": self.plan_misses,
                "size": len(self._plan_cache) if self._plan_cache else 0,
            },
            "hedging": {
                "enabled": self.cfg.hedge_enabled,
                "budget": self.hedge_budget.stats(),
                "latency_quantiles_ms": {
                    shard: round(v * 1e3, 3)
                    for shard, v in self.hedge_latency.snapshot().items()
                },
            },
            "data_plane": {
                "batch_capable": self._batch_capable,
                "batch_chunks": self.cfg.fanout_batch_chunks,
                "batch_rpcs": self.batch_rpcs,
                "batch_fallbacks": self.batch_fallbacks,
                "legacy_shards": sorted(self._legacy_shards),
            },
            "epoch": {
                "pinned": self.ring.epoch,
                "membership": (self.membership.epoch
                               if self.membership is not None else None),
                "bumps": self.epoch_bumps,
                "cross_epoch_responses": self.cross_epoch_responses,
            },
        }

    def close(self) -> None:
        self._executor.shutdown(wait=False)
        for client in self.clients.values():
            client.close()
