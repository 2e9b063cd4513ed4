"""Standalone indexer service: scoring over gRPC + event-plane wiring.

Port of ``llmd_kv_cache_tpu/services/indexer_service.py`` (counterpart of
reference ``examples/kv_cache_index_service``: gRPC
``IndexerService.GetPodScores``, ``api/indexerpb/indexer.proto:24-43``):
one process that runs the event pool and the ZMQ subscribers and serves
scoring RPCs to schedulers that aren't in-process (the embedded-library
path remains ``scoring.Indexer``).

Two wire surfaces on one server:

- ``indexer.v1.IndexerService/GetPodScores`` — the reference's protobuf
  contract, byte-compatible with llm-d's Go EPP (prompt in, tokenized
  server-side).
- ``kvtpu.indexer.IndexerService/GetPodScores`` (plus the shard surface:
  ``LookupBlocks``, ``LookupBlocksBatch``, ``ListPods``, ``GetPodDigest``,
  ``GetPodBlocks``) — the native msgpack-over-gRPC convention (token IDs
  in, no tokenizer needed; same convention as the tokenizer sidecar).

The wire classes pack and unpack with ``utils.msgpack_codec``, byte-equal
to the JAX package's ``msgpack.packb(..., use_bin_type=True)``, so the
methods of :class:`IndexerService` serve the msgpack wire in-process
without ``grpc`` or ``msgpack``. ``grpc`` is imported in :func:`serve`,
the clients' constructors, ``channel_pool.acquire`` and the retry
predicate; ``google.protobuf`` by the protobuf surface only. Both are
held on the CPU: the card's machine has neither.

With ``clusterConfig`` the service is one replica of a sharded fleet
(``cluster/``): a ``shardId`` puts a ``ShardFilterIndex`` on its ingest, a
``MembershipTable`` fences its event batches, scores and shard lookups
and stamps its epoch on every answer, and ``/debug/shard`` and
``/debug/membership`` serve their views.

With ``recoveryConfig.snapshotDir`` the service warm-restarts from its
newest snapshot and journal before intake starts, journals live events,
snapshots on a cadence, and answers ``degraded=True`` (and ``/healthz``
503) until the index's staleness clears the warm-up bound.
:meth:`IndexerService.drain` runs the deadline-bounded graceful drain, and
:meth:`~IndexerService.attach_digest_source` the anti-entropy reconciler
and the divergence auditor (``recovery/``). The fleet telemetry exports
(``fleetTelemetry``) wait for ROADMAP A.8.6.
"""

from __future__ import annotations

import time
from concurrent import futures
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..events.pool import Pool, PoolConfig
from ..events.subscriber_manager import SubscriberManager
from ..events.zmq_subscriber import ZMQSubscriber
from ..metrics.collector import record_shed, register_cache_ledger
from ..recovery.drain import DrainCoordinator
from ..recovery.manager import RecoveryManager
from ..recovery.reconcile import (
    AntiEntropyReconciler,
    DigestSource,
    DivergenceAuditor,
    digest_from_blocks,
    pod_blocks_from_state,
)
from ..resilience.deadline import (
    Deadline,
    DeadlineExceeded,
    current_deadline,
    deadline_metadata,
    deadline_scope,
    effective_timeout,
    extract_deadline,
)
from ..resilience.failpoints import FaultInjected, failpoints
from ..resilience.policy import RetryExhausted, RetryPolicy, call_with_retry
from ..resilience.shedding import (
    BROWNOUT,
    PRIORITY_NORMAL,
    SHED,
    CoDelShedder,
)
from ..scoring.indexer import Indexer, IndexerConfig
from ..telemetry.flight_recorder import KIND_SHED, attach_failpoint_listener
from ..telemetry.flight_recorder import record as record_event
from ..telemetry.tracing import current_traceparent, tracer
from ..utils.logging import get_logger
from ..utils.msgpack_codec import packb, unpackb
from ..utils.net import grpc_target
from . import channel_pool
from .admin import AdminServer, start_observability_servers
from .tokenizer.client import is_retryable
from .tokenizer.service import extract_traceparent

logger = get_logger("services.indexer")

SERVICE_NAME = "kvtpu.indexer.IndexerService"
PROTO_SERVICE_NAME = "indexer.v1.IndexerService"

# Error-mode fires at the entry of every outgoing scoring RPC (chaos:
# flaky indexer deployment). Injected faults retry like transport errors.
FP_INDEXER_RPC = "services.indexer.rpc"

# Server-side lookup hook (chaos: gray failures). Delay-mode arms a
# slow-not-dead shard: ``hit()`` fires both the generic name and a
# ``<name>.<shard_id>`` variant, so one shard of an in-process fleet can
# be slowed while its peers stay healthy.
FP_SHARD_LOOKUP = "services.indexer.lookup"

# Scoring sits on the scheduler hot path: one fast retry, then give up
# and let the picker fall back to round-robin.
DEFAULT_RPC_RETRY_POLICY = RetryPolicy(
    max_attempts=2, base_delay_s=0.05, max_delay_s=0.5, deadline_s=5.0
)

def _call_rpc(rpc, request, timeout: float, policy: RetryPolicy):
    """One unary scoring RPC under the retry policy. On exhaustion the
    last underlying error is re-raised so callers keep the grpc.RpcError
    contract (status code inspection, etc.). Ambient W3C trace context
    rides as ``traceparent`` metadata so the server span joins the
    caller's trace; the ambient request deadline rides the same way
    (``kvtpu-deadline-ms``) and caps the transport timeout — an expired
    deadline fails the call before any wire traffic."""
    tp = current_traceparent()
    md = (("traceparent", tp),) if tp else ()
    md = md + tuple(deadline_metadata())
    metadata = md or None
    dl = current_deadline()
    timeout = effective_timeout(timeout)

    def attempt():
        if dl is not None:
            dl.check("services.rpc")
        failpoints.hit(FP_INDEXER_RPC)
        return rpc(request, timeout=timeout, metadata=metadata)

    try:
        return call_with_retry(attempt, policy, retryable=is_retryable)
    except RetryExhausted as e:
        raise e.__cause__


def _pack_dict(d: dict) -> bytes:
    return packb(d)


def _unpack_dict(b: bytes) -> dict:
    return unpackb(b)


def _row_from_entry(e) -> list:
    """PodEntry → snapshot wire row ``[pod, tier, flags, group_idx]``
    (the dump_state/journal layout; cluster.remote.entry_from_row is the
    inverse)."""
    return [
        e.pod_identifier,
        e.device_tier,
        (1 if e.speculative else 0) | (2 if e.has_group else 0),
        e.group_idx,
    ]


@dataclass
class ScoreRequest:
    tokens: list[int]
    model_name: str
    pod_identifiers: list[str] = field(default_factory=list)
    # Shard metadata (cluster/): the sender's intended owner shard id for
    # a shard-targeted request, "" for an unsharded call. Tolerant like
    # ``traceparent``: old peers omit it, old servers ignore it.
    shard: str = ""
    # Target pod role for disaggregated serving (offload/handoff): ""
    # (role-agnostic, the legacy behavior), "prefill", or "decode".
    # "decode" requests additionally earn transferred-prefix residency
    # bonuses when the serving indexer tracks handoffs. Same tolerance
    # pattern as ``shard``.
    role: str = ""
    # End-to-end deadline: milliseconds of budget remaining at send time
    # (resilience.deadline — relative, so clock skew cannot bend it).
    # 0/absent = no deadline; old servers ignore it.
    deadline_ms: int = 0
    # Shedding priority (resilience.shedding.PRIORITY_*): 0 low, 1 normal
    # (the default — also what an old peer's absent field decodes to),
    # 2 critical (never shed).
    priority: int = 1
    # Sender's topology epoch (cluster.membership). 0/absent = an
    # unstamped (pre-epoch) peer, never fenced; a stamp older than the
    # server's epoch is rejected or flagged per ``fenceMode``, and a
    # newer stamp teaches the server the fleet moved on (piggyback
    # gossip). Same tolerance pattern as ``deadline_ms``.
    epoch: int = 0

    def to_bytes(self) -> bytes:
        return packb(
            {
                "tokens": self.tokens,
                "model_name": self.model_name,
                "pod_identifiers": self.pod_identifiers,
                "shard": self.shard,
                "role": self.role,
                "deadline_ms": self.deadline_ms,
                "priority": self.priority,
                "epoch": self.epoch,
            }
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "ScoreRequest":
        d = unpackb(b)
        try:
            deadline_ms = int(d.get("deadline_ms", 0) or 0)
        except (TypeError, ValueError):
            deadline_ms = 0
        try:
            priority = int(d.get("priority", 1))
        except (TypeError, ValueError):
            priority = 1
        try:
            epoch = int(d.get("epoch", 0) or 0)
        except (TypeError, ValueError):
            epoch = 0
        return cls(
            tokens=list(d.get("tokens", [])),
            model_name=d.get("model_name", ""),
            pod_identifiers=list(d.get("pod_identifiers", [])),
            shard=d.get("shard", "") or "",
            role=d.get("role", "") or "",
            deadline_ms=deadline_ms,
            priority=priority,
            epoch=epoch,
        )


@dataclass
class ScoreResponse:
    scores: dict[str, float] = field(default_factory=dict)
    error: str = ""
    # True while the serving index is still warming after a restart
    # (recovery.manager): scores are best-effort (snapshot + partial
    # replay) and routers should widen their fallback. Absent on the wire
    # from older servers, so decoding defaults to False.
    degraded: bool = False
    # W3C traceparent of the GetPodScores span that produced these scores.
    # A scheduler that routes on them hands it to the chosen engine's
    # ``enqueue(..., traceparent=...)`` so admission/prefill/decode spans
    # join the scorer's trace — one trace covers score→serve. Empty when
    # tracing is off; absent on the wire from older servers.
    traceparent: str = ""
    # Shard metadata (cluster/): the answering replica's shard id ("" for
    # an unsharded indexer) and the shards a router could not reach while
    # assembling these scores (scores are a lower bound when non-empty).
    # Both follow the ``traceparent`` tolerance pattern — absent on the
    # wire from older peers, ignored by them on receive.
    shard: str = ""
    degraded_shards: list[str] = field(default_factory=list)
    # Per-pod transferred-prefix residency bonus already folded into
    # ``scores`` — surfaced separately so a handoff coordinator can see
    # how much of a decode pod's score is in-flight/landed transfer state
    # vs indexed cache. Empty for role-agnostic requests and on the wire
    # from older servers (same tolerance pattern as ``shard``).
    residency: dict[str, float] = field(default_factory=dict)
    # Why ``degraded`` is set, when the server knows: "" (not degraded, or
    # an older server), "warmup", "brownout" (overload — residency fold-in
    # skipped), "shed" (overload — not scored), "deadline" (the request's
    # budget expired in-flight), "fenced" (the request carried a stale
    # topology epoch and ``fenceMode: reject`` refused it). Same
    # tolerance pattern as ``shard``.
    degraded_reason: str = ""
    # The answering server's topology epoch (cluster.membership) — the
    # piggyback half of epoch gossip: a caller seeing a higher epoch than
    # it pinned learns the fleet moved on without any new RPC surface.
    # 0/absent = a pre-epoch server. Same tolerance pattern as ``shard``.
    epoch: int = 0

    def to_bytes(self) -> bytes:
        return packb(
            {"scores": self.scores, "error": self.error,
             "degraded": self.degraded, "traceparent": self.traceparent,
             "shard": self.shard, "degraded_shards": self.degraded_shards,
             "residency": self.residency,
             "degraded_reason": self.degraded_reason,
             "epoch": self.epoch}
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "ScoreResponse":
        d = unpackb(b)
        try:
            epoch = int(d.get("epoch", 0) or 0)
        except (TypeError, ValueError):
            epoch = 0
        return cls(
            scores=dict(d.get("scores", {})),
            error=d.get("error", ""),
            degraded=bool(d.get("degraded", False)),
            traceparent=d.get("traceparent", "") or "",
            shard=d.get("shard", "") or "",
            degraded_shards=[str(s) for s in d.get("degraded_shards", [])],
            residency=dict(d.get("residency", {})),
            degraded_reason=d.get("degraded_reason", "") or "",
            epoch=epoch,
        )


@dataclass
class ScoreFeedback:
    """The prediction a request was routed on, carried to the engine.

    A scheduler that routes on a :class:`ScoreResponse` builds one of
    these (:meth:`from_response`) and hands it to the chosen engine's
    ``enqueue(..., feedback=...)``; the engine attaches it to the
    realized prefix outcome it records at prefill finish
    (telemetry/audit.py), closing the score→serve loop. Every field
    follows the ``ScoreResponse.residency`` tolerance pattern — absent
    on the wire from older peers, ignored by them on receive — so a
    mixed-version fleet degrades to "no calibration for that hop", never
    a decode error.
    """

    # W3C traceparent of the scoring span — the join key the collector
    # matches predictions to outcomes on.
    traceparent: str = ""
    # The pod the scheduler actually chose (not necessarily the top
    # score — affinity/load tie-breaks are the scheduler's business).
    chosen_pod: str = ""
    # The chosen pod's predicted prefix score, in block units
    # (tier-weighted, so fractional).
    predicted_blocks: float = 0.0
    # Prompt length in canonical blocks at score time.
    total_blocks: int = 0
    # The full per-pod score map — the routing-regret counterfactual
    # needs the losing pods' predictions too.
    scores: dict[str, float] = field(default_factory=dict)
    # Per-pod transferred-prefix residency bonus (ScoreResponse.residency).
    residency: dict[str, float] = field(default_factory=dict)
    # Index staleness (event lag) at score time, for staleness-attributed
    # calibration error.
    staleness_s: float = 0.0

    @classmethod
    def from_response(cls, resp: "ScoreResponse", chosen_pod: str,
                      total_blocks: int = 0,
                      staleness_s: float = 0.0) -> "ScoreFeedback":
        """Build feedback from the response a scheduler routed on."""
        return cls(
            traceparent=resp.traceparent,
            chosen_pod=chosen_pod,
            predicted_blocks=float(resp.scores.get(chosen_pod, 0.0)),
            total_blocks=total_blocks,
            scores=dict(resp.scores),
            residency=dict(resp.residency),
            staleness_s=staleness_s,
        )

    def to_bytes(self) -> bytes:
        return packb(
            {"traceparent": self.traceparent,
             "chosen_pod": self.chosen_pod,
             "predicted_blocks": self.predicted_blocks,
             "total_blocks": self.total_blocks,
             "scores": self.scores,
             "residency": self.residency,
             "staleness_s": self.staleness_s}
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "ScoreFeedback":
        d = unpackb(b)
        try:
            predicted = float(d.get("predicted_blocks", 0.0) or 0.0)
        except (TypeError, ValueError):
            predicted = 0.0
        try:
            staleness = float(d.get("staleness_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            staleness = 0.0
        return cls(
            traceparent=d.get("traceparent", "") or "",
            chosen_pod=d.get("chosen_pod", "") or "",
            predicted_blocks=predicted,
            total_blocks=int(d.get("total_blocks", 0) or 0),
            scores=dict(d.get("scores", {})),
            residency=dict(d.get("residency", {})),
            staleness_s=staleness,
        )


class IndexerService:
    """Assembles indexer + event pool + subscribers; serves GetPodScores."""

    def __init__(
        self,
        indexer_config: Optional[IndexerConfig] = None,
        pool_config: Optional[PoolConfig] = None,
        tokenize: Optional[Callable[[str, str], Sequence[int]]] = None,
    ):
        """``tokenize(prompt, model_name) -> token_ids`` backs the protobuf
        prompt-scoring surface (the reference tokenizes via its UDS
        tokenizer pool; wire ``TokenizationPool.tokenize`` here)."""
        self.indexer = Indexer(indexer_config)
        self.tokenize = tokenize
        self.pool_config = pool_config or PoolConfig()
        # Sharded control plane (cluster/): when this replica has a shard
        # identity, ingestion goes through a ShardFilterIndex so the full
        # broadcast event stream is filtered to the keys this shard owns.
        # Scoring/lookup still read the inner index directly (the filter
        # only gates writes).
        self.shard_index = None
        cc = self.indexer.config.cluster_config
        if cc is not None and cc.enabled and cc.shard_id:
            from ..cluster.sharded_index import ShardFilterIndex

            self.shard_index = ShardFilterIndex(
                self.indexer.kv_block_index,
                cc.build_ring(),
                cc.shard_id,
                replication_factor=cc.replication_factor,
            )
        # Epoch-fenced membership (cluster.membership): the pod's view of
        # the fleet topology epoch plus its own lease. Score/lookup
        # requests are fenced against it and the event pool consults it
        # before accepting writes; fenceMode decides reject vs flag.
        self.membership = None
        if cc is not None and cc.enabled:
            from ..cluster.membership import MembershipTable

            self.membership = MembershipTable.from_cluster_config(cc)
        self.pool = Pool(
            self.pool_config,
            self.shard_index or self.indexer.kv_block_index,
            self.indexer.token_processor,
        )
        if self.membership is not None:
            self.pool.attach_membership(self.membership)
        self.subscriber_manager = SubscriberManager(
            self.pool.add_task, topic_filter=self.pool_config.topic_filter
        )
        self._central_subscriber: Optional[ZMQSubscriber] = None
        self._observability_servers: list[AdminServer] = []
        # Hit/miss/evict attribution flows from the scorer into the same
        # ledger the event pool feeds store/evict events, giving one
        # per-pod cache-efficiency view (/debug/ledger).
        self.pool.ledger = self.indexer.ledger
        # Hybrid-aware scoring reads the pool's learned group catalog
        # (no-op for the default longest-prefix strategy).
        self.indexer.attach_group_catalog(self.pool.group_catalog)
        # Degraded-mode scoring: pods whose event stream went silent are
        # demoted, then dropped (resilience.liveness). None when the pool's
        # liveness knobs are disabled.
        if self.pool.liveness is not None:
            self.indexer.attach_liveness(self.pool.liveness)
        # Crash-tolerant state (recovery/): snapshots + journaled warm
        # restart + readiness gate, enabled by recoveryConfig.snapshotDir.
        self.recovery: Optional[RecoveryManager] = None
        rc = self.indexer.config.recovery_config
        if rc is not None and rc.enabled:
            self.recovery = RecoveryManager(
                rc, self.indexer.kv_block_index, self.pool
            )
        self._reconciler: Optional[AntiEntropyReconciler] = None
        # Always-on sampled divergence audit (recovery.reconcile.
        # DivergenceAuditor) — shares the reconciler's digest source but
        # never repairs, only measures (kvtpu_index_divergence_*).
        self._divergence_auditor: Optional[DivergenceAuditor] = None
        self._drain_coordinator: Optional[DrainCoordinator] = None
        # Adaptive overload shedding (resilience.shedding): serving delay
        # feeds a CoDel controller; under sustained overload low-priority
        # scoring sheds and normal-priority scoring browns out (residency
        # fold-in skipped, response flagged degraded). Disabled unless
        # shedTargetDelayS > 0.
        self.shedder: Optional[CoDelShedder] = None
        if self.indexer.config.shed_target_delay_s > 0:
            self.shedder = CoDelShedder(
                "indexer.score",
                target_delay_s=self.indexer.config.shed_target_delay_s,
                interval_s=self.indexer.config.shed_interval_s,
            )

    @property
    def shard_id(self) -> str:
        """This replica's shard identity; "" for an unsharded indexer."""
        cc = self.indexer.config.cluster_config
        return cc.shard_id if cc is not None else ""

    def _data_plane_debug(self) -> dict:
        """Native data-plane counters (``/debug/data_plane``, kvdiag):
        zero-copy ingest batches + shm-ring messages from the pool and
        the chunked native-scoring call/early-exit counters from the
        indexer, one flat view."""
        view = dict(self.pool.data_plane_debug())
        view.update(self.indexer.data_plane_debug())
        return view

    @property
    def process_name(self) -> str:
        """Span attribution identity: the shard id (JAX lets a configured
        fleet process identity win over it; fleet telemetry waits for
        A.8.6)."""
        return self.shard_id or "indexer"

    def attach_peer_digest_source(self) -> None:
        """Cross-replica anti-entropy: reconcile the locally-owned key
        range against the union of the other replicas' advertised views
        (cluster.remote.RemoteShardDigestSource). A restarted shard calls
        this after snapshot bootstrap so residual event loss converges."""
        cc = self.indexer.config.cluster_config
        if cc is None or not cc.enabled or not cc.shard_id:
            raise RuntimeError(
                "peer reconciliation needs clusterConfig.shardId"
            )
        from ..cluster.remote import RemoteShardDigestSource, ShardClient

        peers = [
            ShardClient(cc.address_of(sid), timeout_s=cc.fanout_timeout_s)
            for sid in cc.membership()
            if sid != cc.shard_id
        ]
        self.attach_digest_source(
            RemoteShardDigestSource(
                peers,
                cc.build_ring(),
                cc.shard_id,
                replication_factor=cc.replication_factor,
            )
        )

    def attach_digest_source(self, source: DigestSource) -> None:
        """Enable anti-entropy reconciliation against ``source`` (a pod's
        advertised truth, or a reference index via IndexDigestSource).
        Runs on the recoveryConfig.reconcileIntervalS cadence once the
        service starts; 0 keeps it manual (``reconcile_now``)."""
        rc = self.indexer.config.recovery_config
        interval = rc.reconcile_interval_s if rc is not None else 0.0
        self._reconciler = AntiEntropyReconciler(
            self.indexer.kv_block_index, source, interval_s=interval
        )
        # The continuous divergence auditor shares the same digest source
        # but is repair-free: it measures phantom/ghost block counts and
        # divergence age so the index_divergence SLI sees drift the
        # reconciler hasn't (or can't) repair yet.
        self._divergence_auditor = DivergenceAuditor(
            self.indexer.kv_block_index,
            source,
            interval_s=(rc.divergence_audit_interval_s
                        if rc is not None else 0.0),
            sample=(rc.divergence_audit_sample if rc is not None else 1.0),
        )

    def reconcile_now(self) -> dict:
        """One manual anti-entropy round (admin/testing aid)."""
        if self._reconciler is None:
            raise RuntimeError("no digest source attached (attach_digest_source)")
        return self._reconciler.reconcile_once()

    def audit_now(self) -> dict:
        """One manual divergence-audit round (admin/testing aid) —
        digest compare without repair, emitting the
        kvtpu_index_divergence_* families."""
        if self._divergence_auditor is None:
            raise RuntimeError("no digest source attached (attach_digest_source)")
        return self._divergence_auditor.audit_once()

    def start(self) -> None:
        """Start the event plane: workers plus, in centralized mode, a
        bound subscriber every engine connects to; then the admin and
        metrics endpoints the config asks for."""
        # Warm restart strictly precedes live intake so replayed journal
        # records are ordered ahead of (and never re-journaled with) live
        # traffic; the readiness gate then holds scores degraded until the
        # staleness estimate clears warmupStalenessBoundS.
        if self.recovery is not None:
            self.recovery.warm_restart()
        self.pool.start()
        if self.pool_config.zmq_endpoint:
            self._central_subscriber = ZMQSubscriber(
                self.pool_config.zmq_endpoint,
                self.pool_config.topic_filter,
                self.pool.add_task,
                bind=True,
            )
            self._central_subscriber.start()
        # Failpoint trips land in the flight recorder so chaos runs leave
        # a reconstructable decision trail.
        attach_failpoint_listener()
        providers = {
            "lag": self.pool.lag_stats,
            "ledger": self.indexer.ledger.snapshot,
            "data_plane": self._data_plane_debug,
        }
        # Ledger counters double as kvtpu_cache_ledger_* families on
        # /metrics (scrape-time snapshot — nothing added to hot paths).
        # JAX swallows any error here; the port lets it raise.
        register_cache_ledger(self.indexer.ledger.snapshot)
        if self.shard_index is not None:
            providers["shard"] = self.shard_index.debug_view
        if self.membership is not None:
            providers["membership"] = self.membership.debug_view
        if self.shedder is not None:
            providers["shed"] = self.shedder.stats
        health = None
        if self.recovery is not None:
            self.recovery.start()
            providers["recovery"] = self.recovery.health
            health = self.recovery.health
        if self._reconciler is not None and self._reconciler.interval_s > 0:
            self._reconciler.start()
        if (self._divergence_auditor is not None
                and self._divergence_auditor.interval_s > 0):
            self._divergence_auditor.start()
        if self._divergence_auditor is not None:
            providers["divergence_audit"] = self._divergence_auditor.debug_view
        self._observability_servers = start_observability_servers(
            self.indexer.config.metrics_port,
            self.indexer.config.admin_port,
            host=self.indexer.config.admin_host,
            providers=providers,
            health=health,
        )

    def stop(self) -> None:
        for server in self._observability_servers:
            server.stop()
        self._observability_servers = []
        if self._central_subscriber is not None:
            self._central_subscriber.stop()
        if self._reconciler is not None:
            self._reconciler.stop()
        if self._divergence_auditor is not None:
            self._divergence_auditor.stop()
        self.subscriber_manager.shutdown()
        if self.recovery is not None:
            # Final snapshot happens before the pool stops so lag_stats
            # still reflects the fully-ingested watermarks.
            self.pool.join()
            self.recovery.stop(final_snapshot=True)
        self.pool.shutdown()

    # -- graceful drain ---------------------------------------------------

    def drain(self, offload=None, on_complete: Optional[Callable[[], None]] = None) -> dict:
        """Run the deadline-bounded graceful drain (recovery.drain):
        stop intake, drain queues, flush ``offload`` (an OffloadHandlers,
        optional), final snapshot. Returns the step report."""
        rc = self.indexer.config.recovery_config
        deadline = rc.drain_deadline_s if rc is not None else 10.0
        coordinator = self._drain_coordinator
        if coordinator is None:
            stoppers = [self.subscriber_manager.shutdown]
            if self._central_subscriber is not None:
                stoppers.append(self._central_subscriber.stop)
            if self._reconciler is not None:
                stoppers.append(self._reconciler.stop)
            if self._divergence_auditor is not None:
                stoppers.append(self._divergence_auditor.stop)
            coordinator = self._drain_coordinator = DrainCoordinator(
                deadline_s=deadline,
                intake_stoppers=stoppers,
                pool=self.pool,
                offload=offload,
                manager=self.recovery,
                on_complete=on_complete,
            )
        return coordinator.drain()

    def install_drain_handler(self, offload=None,
                              on_complete: Optional[Callable[[], None]] = None) -> DrainCoordinator:
        """Install a SIGTERM handler running :meth:`drain`. Call from the
        main thread before serving."""
        rc = self.indexer.config.recovery_config
        deadline = rc.drain_deadline_s if rc is not None else 10.0
        stoppers = [self.subscriber_manager.shutdown]
        if self._central_subscriber is not None:
            stoppers.append(self._central_subscriber.stop)
        if self._reconciler is not None:
            stoppers.append(self._reconciler.stop)
        self._drain_coordinator = DrainCoordinator(
            deadline_s=deadline,
            intake_stoppers=stoppers,
            pool=self.pool,
            offload=offload,
            manager=self.recovery,
            on_complete=on_complete,
        )
        self._drain_coordinator.install()
        return self._drain_coordinator

    # -- RPC --

    def _epoch_stamp(self) -> int:
        """This pod's topology epoch for response piggybacking (0 when
        the membership plane is off — absent-field tolerant)."""
        return int(self.membership.epoch) if self.membership is not None else 0

    def _shed_response(self, reason: str, error: str = "") -> ScoreResponse:
        return ScoreResponse(
            error=error, degraded=True, degraded_reason=reason,
            traceparent=current_traceparent() or "", shard=self.shard_id,
            epoch=self._epoch_stamp(),
        )

    def _record_shed(self, site: str, outcome: str, priority: int) -> None:
        try:
            record_shed(site, outcome)
        except Exception:  # metrics must never break serving
            logger.debug("shed metrics failed", exc_info=True)
        record_event(KIND_SHED, {
            "site": site, "outcome": outcome, "priority": priority,
        })

    def get_pod_scores(self, req: ScoreRequest, context=None) -> ScoreResponse:
        # Server-side half of the W3C hop: parent under the scheduler's
        # traceparent metadata when present (ambient trace context then
        # flows into the score_tokens child span). The request deadline
        # (wire field first, gRPC metadata as fallback) becomes ambient
        # the same way, so every blocking site below consumes it.
        deadline = (Deadline.from_wire_ms(req.deadline_ms)
                    or extract_deadline(context))
        served_at = time.monotonic()
        with tracer().span(
            "llm_d.kv_cache.indexer.GetPodScores",
            parent_traceparent=extract_traceparent(context),
            model=req.model_name,
            tokens=len(req.tokens),
            role=req.role,
            process=self.process_name,
        ), deadline_scope(deadline) as dl:
            try:
                if dl is not None and dl.expired():
                    # Expired before any work: shed, never serve late.
                    self._record_shed("indexer.score", "deadline", req.priority)
                    return self._shed_response(
                        "deadline", error="deadline expired before scoring"
                    )
                if self.membership is not None:
                    # Epoch fence: learn a newer stamp, reject (or flag,
                    # per fenceMode) a stale one — a router still scoring
                    # against a retired ring plan must re-learn topology,
                    # not route on answers sliced for the old placement.
                    fence = self.membership.check_request(req.epoch, "score")
                    if not fence.allowed:
                        return self._shed_response(
                            "fenced",
                            error=f"stale topology epoch {req.epoch} "
                                  f"(fleet at {fence.epoch})",
                        )
                role = req.role
                brownout = False
                if self.shedder is not None:
                    decision = self.shedder.admit(req.priority)
                    if decision == SHED:
                        self._record_shed("indexer.score", SHED, req.priority)
                        return self._shed_response(
                            "shed", error="overload shed"
                        )
                    if decision == BROWNOUT:
                        # Brownout: serve the cheap role-agnostic score —
                        # residency fold-in skipped — flagged degraded.
                        self._record_shed("indexer.score", BROWNOUT, req.priority)
                        brownout = True
                        role = ""
                detail: dict = {}
                scores = self.indexer.score_tokens(
                    req.tokens,
                    req.model_name,
                    set(req.pod_identifiers) if req.pod_identifiers else None,
                    role=role,
                    detail=detail,
                )
                degraded = self.recovery is not None and not self.recovery.ready
                reason = "warmup" if degraded else ""
                if brownout:
                    degraded, reason = True, "brownout"
                if dl is not None and dl.expired():
                    # Finished past the budget: still answer (the work is
                    # done), but flagged — callers see it was late.
                    degraded, reason = True, "deadline"
                    self._record_shed("indexer.score", "late", req.priority)
                # Score→serve trace continuity: hand the scheduler this
                # span's traceparent so the chosen engine's spans join the
                # trace ("" when no tracer is active).
                return ScoreResponse(scores=scores, degraded=degraded,
                                     traceparent=current_traceparent() or "",
                                     shard=self.shard_id,
                                     residency=detail.get("residency", {}),
                                     degraded_reason=reason,
                                     epoch=self._epoch_stamp())
            except DeadlineExceeded as e:
                self._record_shed("indexer.score", "deadline", req.priority)
                return self._shed_response("deadline", error=str(e))
            except Exception as e:
                logger.exception("GetPodScores failed")
                return ScoreResponse(error=str(e))
            finally:
                if self.shedder is not None:
                    self.shedder.observe_delay(time.monotonic() - served_at)

    # -- shard surface --
    #
    # Raw dict-in/dict-out msgpack RPCs the scatter-gather router and
    # replica peers speak (cluster/). Lookup answers from the local index
    # only (the caller owns routing/merging); the repair trio exposes the
    # digest-first views of ``dump_state``.

    def lookup_blocks_rpc(self, req: dict, context=None) -> dict:
        # Gray-failure injection site: a delay-mode failpoint here turns
        # this replica into a slow-not-dead shard.
        failpoints.hit(FP_SHARD_LOOKUP)
        if self.shard_id:
            failpoints.hit(f"{FP_SHARD_LOOKUP}.{self.shard_id}")
        keys = [int(k) for k in req.get("keys", [])]
        pods = req.get("pods") or []
        deadline = Deadline.from_wire_ms(req.get("deadline_ms"))
        with tracer().span(
            "llm_d.kv_cache.indexer.LookupBlocks",
            parent_traceparent=extract_traceparent(context),
            keys=len(keys),
            process=self.process_name,
        ):
            if deadline is not None and deadline.expired():
                # The budget died in flight (or in the queue): answer
                # empty-but-flagged instead of doing work nobody can use.
                self._record_shed("indexer.lookup", "deadline",
                                  PRIORITY_NORMAL)
                return {"hits": [], "degraded": True,
                        "shard": self.shard_id,
                        "degraded_reason": "deadline",
                        "epoch": self._epoch_stamp()}
            if self.membership is not None:
                fence = self.membership.check_request(
                    int(req.get("epoch", 0) or 0), "shard.lookup")
                if not fence.allowed:
                    # Epoch-fenced: empty-but-flagged, carrying our newer
                    # epoch so the stale caller learns and re-plans.
                    return {"hits": [], "degraded": True,
                            "shard": self.shard_id,
                            "degraded_reason": "fenced",
                            "epoch": self._epoch_stamp()}
            hits: list = []
            if keys:
                found = self.indexer.kv_block_index.lookup(
                    keys, set(pods) if pods else None
                )
                hits = [
                    [int(k), [_row_from_entry(e) for e in entries]]
                    for k, entries in found.items()
                ]
            degraded = self.recovery is not None and not self.recovery.ready
            return {"hits": hits, "degraded": degraded,
                    "shard": self.shard_id, "epoch": self._epoch_stamp()}

    def lookup_blocks_batch_rpc(self, req: dict, context=None) -> dict:
        """Framed multi-chunk lookup: the batched fan-out data plane.

        ``{"chunks": [[keys...], ...], "pods": [...], "deadline_ms": int,
        "hedge": bool}`` in; ``{"chunks": [hits_list, ...], "cont":
        [0|1, ...], "degraded": bool, "shard": str}`` out, where
        ``chunks[i]`` is chunk *i*'s hit list in the LookupBlocks row
        layout and ``cont[i]`` says every requested key of chunk *i* was
        found on this shard. Chunks are answered in order and the scan
        stops at the first incomplete one — a key missing on its owning
        shard is a global miss, so later chunks cannot extend any
        consecutive-from-0 prefix. Tolerant both directions: a flat
        ``keys`` frame from an older peer is treated as one chunk, and
        newer response fields are ignored by older clients.
        """
        failpoints.hit(FP_SHARD_LOOKUP)
        if self.shard_id:
            failpoints.hit(f"{FP_SHARD_LOOKUP}.{self.shard_id}")
        raw_chunks = req.get("chunks") or []
        if not raw_chunks and req.get("keys"):
            raw_chunks = [req.get("keys")]
        pods = req.get("pods") or []
        deadline = Deadline.from_wire_ms(req.get("deadline_ms"))
        with tracer().span(
            "llm_d.kv_cache.indexer.LookupBlocksBatch",
            parent_traceparent=extract_traceparent(context),
            chunks=len(raw_chunks),
            process=self.process_name,
        ):
            if deadline is not None and deadline.expired():
                self._record_shed("indexer.lookup", "deadline",
                                  PRIORITY_NORMAL)
                return {"chunks": [], "cont": [], "degraded": True,
                        "shard": self.shard_id,
                        "degraded_reason": "deadline",
                        "epoch": self._epoch_stamp()}
            if self.membership is not None:
                fence = self.membership.check_request(
                    int(req.get("epoch", 0) or 0), "shard.lookup")
                if not fence.allowed:
                    return {"chunks": [], "cont": [], "degraded": True,
                            "shard": self.shard_id,
                            "degraded_reason": "fenced",
                            "epoch": self._epoch_stamp()}
            podset = set(pods) if pods else None
            out_chunks: list = []
            cont: list = []
            for ckeys in raw_chunks:
                keys = [int(k) for k in ckeys]
                found = (self.indexer.kv_block_index.lookup(keys, podset)
                         if keys else {})
                out_chunks.append([
                    [int(k), [_row_from_entry(e) for e in entries]]
                    for k, entries in found.items()
                ])
                complete = len(found) == len(keys)
                cont.append(1 if complete else 0)
                if not complete:
                    break
            degraded = self.recovery is not None and not self.recovery.ready
            return {"chunks": out_chunks, "cont": cont,
                    "degraded": degraded, "shard": self.shard_id,
                    "epoch": self._epoch_stamp()}

    def list_pods_rpc(self, req: dict, context=None) -> dict:
        # Every pod the index holds a block of (JAX: IndexDigestSource.pods).
        state = self.indexer.kv_block_index.dump_state() or {}
        return {
            "pods": sorted({row[0] for _rk, rows in state.get("entries", []) for row in rows}),
            "shard": self.shard_id,
        }

    def pod_digest_rpc(self, req: dict, context=None) -> dict:
        state = self.indexer.kv_block_index.dump_state()
        d = digest_from_blocks(pod_blocks_from_state(state, req.get("pod", "")))
        d["shard"] = self.shard_id
        return d

    def pod_blocks_rpc(self, req: dict, context=None) -> dict:
        state = self.indexer.kv_block_index.dump_state()
        blocks = pod_blocks_from_state(state, req.get("pod", ""))
        return {
            "blocks": [
                [int(k), [list(r) for r in sorted(rows)]]
                for k, rows in blocks.items()
            ],
            "shard": self.shard_id,
        }

    def get_pod_scores_pb(self, req, ctx):
        """Protobuf surface: prompt in, tokenize server-side, score.

        Mirrors the reference's service wrapper
        (``examples/kv_cache_index_service/server/server.go:42-65``): errors
        surface as gRPC status codes — the proto response has no error
        field. Scores are emitted highest-first for deterministic wires.
        """
        import grpc

        from .indexerpb import indexer_pb2

        if self.tokenize is None:
            ctx.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "prompt scoring needs a tokenizer; configure "
                "IndexerService(tokenize=...) or use the token-ID surface "
                f"({SERVICE_NAME})",
            )
        try:
            with tracer().span(
                "llm_d.kv_cache.indexer.GetPodScores",
                parent_traceparent=extract_traceparent(ctx),
                model=req.model_name,
                wire="protobuf",
                process=self.process_name,
            ):
                tokens = list(self.tokenize(req.prompt, req.model_name))
                scores = self.indexer.score_tokens(
                    tokens,
                    req.model_name,
                    set(req.pod_identifiers) if req.pod_identifiers else None,
                )
        except Exception as e:
            logger.exception("GetPodScores (pb) failed")
            ctx.abort(grpc.StatusCode.INTERNAL, str(e))
        resp = indexer_pb2.GetPodScoresResponse()
        for pod, score in sorted(scores.items(), key=lambda kv: (-kv[1], kv[0])):
            resp.scores.add(pod=pod, score=score)
        return resp


def serve(
    address: str,
    service: IndexerService,
    max_workers: int = 16,
):
    """Serve GetPodScores on ``address`` (host:port or unix:path), on both
    the msgpack (token IDs) and protobuf (prompt) wires; returns the
    started ``grpc.Server``."""
    import grpc

    from .indexerpb import indexer_pb2

    def _dict_handler(method):
        return grpc.unary_unary_rpc_method_handler(
            method,
            request_deserializer=_unpack_dict,
            response_serializer=_pack_dict,
        )

    handler = grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "GetPodScores": grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: service.get_pod_scores(req, ctx),
                request_deserializer=ScoreRequest.from_bytes,
                response_serializer=lambda r: r.to_bytes(),
            ),
            # Shard surface (cluster/): scatter-gather lookup + the
            # anti-entropy repair trio, all raw msgpack dicts.
            "LookupBlocks": _dict_handler(
                lambda req, ctx: service.lookup_blocks_rpc(req, ctx)
            ),
            "LookupBlocksBatch": _dict_handler(
                lambda req, ctx: service.lookup_blocks_batch_rpc(req, ctx)
            ),
            "ListPods": _dict_handler(
                lambda req, ctx: service.list_pods_rpc(req, ctx)
            ),
            "GetPodDigest": _dict_handler(
                lambda req, ctx: service.pod_digest_rpc(req, ctx)
            ),
            "GetPodBlocks": _dict_handler(
                lambda req, ctx: service.pod_blocks_rpc(req, ctx)
            ),
        },
    )
    pb_handler = grpc.method_handlers_generic_handler(
        PROTO_SERVICE_NAME,
        {
            "GetPodScores": grpc.unary_unary_rpc_method_handler(
                service.get_pod_scores_pb,
                request_deserializer=indexer_pb2.GetPodScoresRequest.FromString,
                response_serializer=indexer_pb2.GetPodScoresResponse.SerializeToString,
            )
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((handler, pb_handler))
    server.add_insecure_port(grpc_target(address))
    server.start()
    logger.info("indexer service on %s", address)
    return server


class IndexerServiceClient:
    """Scheduler-side client for GetPodScores."""

    def __init__(self, address: str, timeout_s: float = 5.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 membership=None):
        # Shared refcounted channel (services.channel_pool): constructing
        # many clients against the same indexer no longer pays per-client
        # TCP+HTTP/2 setup.
        self.address = address
        # Optional cluster.membership.MembershipTable: requests get
        # stamped with the caller's topology epoch and a newer epoch on
        # the response is learned (piggyback gossip).
        self.membership = membership
        self._channel = channel_pool.acquire(address)
        self._timeout = timeout_s
        self.retry_policy = retry_policy or DEFAULT_RPC_RETRY_POLICY
        self._get_pod_scores = self._channel.unary_unary(
            f"/{SERVICE_NAME}/GetPodScores",
            request_serializer=lambda r: r.to_bytes(),
            response_deserializer=ScoreResponse.from_bytes,
        )

    def get_pod_scores(
        self,
        tokens: list[int],
        model_name: str,
        pod_identifiers: Optional[list[str]] = None,
    ) -> dict[str, float]:
        return self.score(tokens, model_name, pod_identifiers).scores

    def score(
        self,
        tokens: list[int],
        model_name: str,
        pod_identifiers: Optional[list[str]] = None,
        role: str = "",
        priority: int = PRIORITY_NORMAL,
    ) -> ScoreResponse:
        """Full-response variant of :meth:`get_pod_scores`: carries the
        ``degraded`` flag and the scorer's ``traceparent`` (hand the
        latter to the chosen engine's ``enqueue`` for score→serve trace
        continuity). ``role`` targets disaggregated scoring ("decode"
        adds transferred-prefix residency bonuses on the server). The
        ambient deadline (resilience.deadline.deadline_scope) rides the
        request as ``deadline_ms``; ``priority`` feeds the server's
        overload shedder."""
        dl = current_deadline()
        resp = _call_rpc(
            self._get_pod_scores,
            ScoreRequest(
                tokens=list(tokens),
                model_name=model_name,
                pod_identifiers=list(pod_identifiers or []),
                role=role,
                deadline_ms=dl.to_wire_ms() if dl is not None else 0,
                priority=priority,
                epoch=(int(self.membership.epoch)
                       if self.membership is not None else 0),
            ),
            self._timeout,
            self.retry_policy,
        )
        if self.membership is not None and resp.epoch:
            self.membership.observe_epoch(resp.epoch,
                                          source=f"score:{self.address}")
        if resp.error:
            raise RuntimeError(f"GetPodScores failed: {resp.error}")
        return resp

    def close(self) -> None:
        channel_pool.release(self.address)


class IndexerPbClient:
    """Client for the reference protobuf wire (what a Go EPP speaks).

    Exercises the exact method path ``/indexer.v1.IndexerService/
    GetPodScores`` with protobuf-serialized messages, so a round trip here
    proves wire compatibility with clients generated from
    ``api/indexerpb/indexer.proto``.
    """

    def __init__(self, address: str, timeout_s: float = 5.0,
                 retry_policy: Optional[RetryPolicy] = None):
        from .indexerpb import indexer_pb2

        self._pb = indexer_pb2
        self.address = address
        self._channel = channel_pool.acquire(address)
        self._timeout = timeout_s
        self.retry_policy = retry_policy or DEFAULT_RPC_RETRY_POLICY
        self._get_pod_scores = self._channel.unary_unary(
            f"/{PROTO_SERVICE_NAME}/GetPodScores",
            request_serializer=indexer_pb2.GetPodScoresRequest.SerializeToString,
            response_deserializer=indexer_pb2.GetPodScoresResponse.FromString,
        )

    def get_pod_scores(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Optional[list[str]] = None,
    ) -> dict[str, float]:
        resp = _call_rpc(
            self._get_pod_scores,
            self._pb.GetPodScoresRequest(
                prompt=prompt,
                model_name=model_name,
                pod_identifiers=list(pod_identifiers or []),
            ),
            self._timeout,
            self.retry_policy,
        )
        return {s.pod: s.score for s in resp.scores}

    def close(self) -> None:
        channel_pool.release(self.address)
