"""Indexer orchestrator: tokens → block keys → index lookup → pod scores.

Port of ``llmd_kv_cache_tpu/scoring/indexer.py`` (counterpart of reference
``pkg/kvcache/indexer.go``): ``compute_block_keys`` and ``score_tokens``
over the index ``create_index`` builds (the native C++ index unless the
config names another backend), with hybrid-aware scoring
(``attach_group_catalog``), the residency bonus of role-aware decode
scoring (``attach_residency``), and the JAX indexer's observability: the
``llm_d.kv_cache.score_tokens`` span (whose ``traceparent`` a caller hands
to ``MiniEngine.enqueue`` for one trace from score to serve), the
score-latency histogram with trace-id exemplars, the prefix-cache delta
counters, the per-pod ``CacheEfficiencyLedger`` (which the event ``Pool``
shares for store/evict/clear attribution), a ``KIND_SCORE`` flight record
per decision, and the working-set and audit taps (``attach_workingset``,
``attach_audit``). With the longest-prefix strategy on an index that has
``score_chunked`` (the native one), the whole lookup, prefix scoring and
residency fold run in one C++ call, counted by ``data_plane_debug`` and the
native-score families. This is the scheduler hot path:
it answers "which pods hold the longest cached prefix for these tokens,
and how much of it" in a single in-process call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.extra_keys import BlockExtraFeatures
from ..core.keys import TIER_SHARED_STORAGE, BlockHash
from ..core.token_processor import ChunkedTokenDatabase, TokenProcessorConfig
from ..index.base import Index, IndexConfig, create_index
from ..metrics.collector import (
    bucket_histogram,
    record_native_score,
    record_prefix_cache_delta,
)
from ..resilience.deadline import current_deadline
from ..telemetry.flight_recorder import KIND_SCORE, flight_recorder
from ..telemetry.tracing import tracer
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .scorer import LONGEST_PREFIX_MATCH, KVBlockScorerConfig, create_scorer

logger = get_logger("indexer")


class CacheEfficiencyLedger:
    """Per-pod cache-efficiency attribution.

    Answers "which pods actually earn their cache footprint?" after the
    fact: per pod, how often it appeared in score results (and won), how
    much weighted prefix score it accumulated, and how many blocks the
    event stream stored/evicted on it. Misses are global per lookup —
    a block no pod holds cannot be attributed to any one of them.

    One small lock-guarded dict update per score call / ingest event;
    cheap enough to stay always-on.
    """

    def __init__(self):
        self._mu = new_lock()
        self._pods: dict[str, dict] = {}
        self.score_calls = 0
        self.lookup_blocks = 0
        self.lookup_hit_blocks = 0

    def _pod(self, pod: str) -> dict:
        st = self._pods.get(pod)
        if st is None:
            st = self._pods[pod] = {
                "appearances": 0,
                "wins": 0,
                "score_total": 0.0,
                "stored_blocks": 0,
                "evicted_blocks": 0,
                "clears": 0,
            }
        return st

    def record_score(
        self, scores: dict[str, float], total_blocks: int, hit_blocks: int
    ) -> None:
        winner = max(scores, key=scores.get) if scores else None
        with self._mu:
            self.score_calls += 1
            self.lookup_blocks += total_blocks
            self.lookup_hit_blocks += hit_blocks
            for pod, score in scores.items():
                st = self._pod(pod)
                st["appearances"] += 1
                st["score_total"] += score
            if winner is not None:
                self._pods[winner]["wins"] += 1

    def record_store(self, pod: str, blocks: int) -> None:
        with self._mu:
            self._pod(pod)["stored_blocks"] += blocks

    def record_evict(self, pod: str, blocks: int) -> None:
        with self._mu:
            self._pod(pod)["evicted_blocks"] += blocks

    def record_clear(self, pod: str) -> None:
        with self._mu:
            self._pod(pod)["clears"] += 1

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "score_calls": self.score_calls,
                "lookup_blocks": self.lookup_blocks,
                "lookup_hit_blocks": self.lookup_hit_blocks,
                "lookup_miss_blocks": self.lookup_blocks - self.lookup_hit_blocks,
                "pods": {pod: dict(st) for pod, st in self._pods.items()},
            }


# Config keys of the JAX indexer whose planes the port does not have yet,
# with the ROADMAP item that ports each: ``from_dict`` refuses them rather
# than ignore a plane the caller asked for.
_UNPORTED_KEYS = (
    ("fleetTelemetry", "fleet_telemetry", "A.8.6 (telemetry/fleet.py)"),
)


@dataclass
class IndexerConfig:
    """Top-level config (reference ``indexer.go:39-61``): nested configs with
    nil-tolerance — every field defaults sensibly when omitted."""

    token_processor_config: TokenProcessorConfig = field(default_factory=TokenProcessorConfig)
    # None: IndexConfig.default(), the native index.
    index_config: Optional[IndexConfig] = None
    scorer_config: KVBlockScorerConfig = field(default_factory=KVBlockScorerConfig)
    # Early-exit chunked lookup: score_tokens looks blocks up in chunks of
    # this many keys and stops at the first chunk that breaks the prefix
    # chain (0 disables — single full lookup / full native scan). Only
    # engaged for the LongestPrefix strategy; hybrid-aware scoring values
    # blocks at any position.
    lookup_chunk_size: int = 128
    # Observability endpoints (services.admin): 0 = disabled (default).
    # metrics_port serves /metrics + /healthz only; admin_port additionally
    # exposes the /debug/* surfaces (flight recorder, lag, ledger).
    metrics_port: int = 0
    admin_port: int = 0
    # Bind address for both endpoints; localhost by default because the
    # debug surface exposes pod names and score internals.
    admin_host: str = "127.0.0.1"
    # Crash-tolerant state (recovery/): None or snapshot_dir="" disables
    # snapshots, journaled warm restart, and the warmup readiness gate.
    recovery_config: Optional["RecoveryConfig"] = None
    # Adaptive overload shedding at the scoring service (resilience.
    # shedding.CoDelShedder): when serving delay stays above this target
    # for a full interval, low-priority requests shed and normal-priority
    # ones brown out (residency fold-in skipped, response flagged
    # degraded). 0 disables (the default).
    shed_target_delay_s: float = 0.0
    shed_interval_s: float = 0.1
    # Sharded control plane (cluster/): None disables. With shardId set,
    # a service built from this config ingests as one shard replica
    # (ShardFilterIndex); routers use the same config to fan out.
    cluster_config: Optional["ClusterConfig"] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "IndexerConfig":
        """The JAX indexer's config dict: token-processor, index, scorer,
        lookup, endpoint, shedding, recovery and cluster keys. A key of a
        plane not yet ported (fleet telemetry) raises
        ``NotImplementedError`` naming its ROADMAP item when it asks for
        that plane (a truthy value)."""
        if not d:
            return cls()
        for *keys, item in _UNPORTED_KEYS:
            for key in keys:
                if d.get(key):
                    raise NotImplementedError(
                        f"IndexerConfig key {key!r} needs a plane the port does not "
                        f"have yet (ROADMAP {item})")
        chunk = d.get("lookupChunkSize", d.get("lookup_chunk_size"))
        cfg = cls(
            token_processor_config=TokenProcessorConfig.from_dict(
                d.get("tokenProcessorConfig", d.get("token_processor_config"))
            ),
            scorer_config=KVBlockScorerConfig.from_dict(
                d.get("kvBlockScorerConfig", d.get("scorer_config"))
            ),
            lookup_chunk_size=128 if chunk is None else chunk,
            metrics_port=d.get("metricsPort", d.get("metrics_port", 0)) or 0,
            admin_port=d.get("adminPort", d.get("admin_port", 0)) or 0,
            admin_host=d.get("adminHost", d.get("admin_host", "127.0.0.1"))
            or "127.0.0.1",
            shed_target_delay_s=d.get(
                "shedTargetDelayS", d.get("shed_target_delay_s", 0.0)
            ) or 0.0,
            shed_interval_s=d.get(
                "shedIntervalS", d.get("shed_interval_s", 0.1)
            ) or 0.1,
        )
        recovery_dict = d.get("recoveryConfig", d.get("recovery_config"))
        if recovery_dict:
            from ..recovery.config import RecoveryConfig

            cfg.recovery_config = RecoveryConfig.from_dict(recovery_dict)
        cluster_dict = d.get("clusterConfig", d.get("cluster_config"))
        if cluster_dict:
            from ..cluster.config import ClusterConfig

            cfg.cluster_config = ClusterConfig.from_dict(cluster_dict)
        index_dict = d.get("kvBlockIndexConfig", d.get("index_config"))
        if index_dict:
            from ..index.cost_aware import CostAwareMemoryIndexConfig
            from ..index.in_memory import InMemoryIndexConfig

            # Valkey is wire-compatible with Redis (reference index.go:74-79
            # keeps a distinct config slot); fold it into the redis backend
            # with the valkey backend type.
            redis_cfg = index_dict.get("redisConfig")
            valkey_cfg = index_dict.get("valkeyConfig")
            if redis_cfg is None and valkey_cfg is not None:
                redis_cfg = dict(valkey_cfg)
                redis_cfg.setdefault("backendType", "valkey")

            native_dict = index_dict.get("nativeConfig")
            native_cfg = None
            if native_dict is not None:
                from ..index.native import NativeIndexConfig

                native_cfg = NativeIndexConfig.from_dict(native_dict)

            cfg.index_config = IndexConfig(
                in_memory_config=InMemoryIndexConfig.from_dict(index_dict.get("inMemoryConfig"))
                if index_dict.get("inMemoryConfig") is not None
                else None,
                cost_aware_memory_config=CostAwareMemoryIndexConfig.from_dict(
                    index_dict.get("costAwareMemoryConfig")
                )
                if index_dict.get("costAwareMemoryConfig") is not None
                else None,
                redis_config=redis_cfg,
                native_config=native_cfg,
                enable_metrics=index_dict.get("enableMetrics", False),
                enable_tracing=index_dict.get("enableTracing", False),
                metrics_logging_interval_s=index_dict.get("metricsLoggingInterval", 0.0),
            )
        return cfg


class Indexer:
    """KV-cache indexer: the library's main entry point."""

    def __init__(
        self,
        config: Optional[IndexerConfig] = None,
        index: Optional[Index] = None,
    ):
        self.config = config or IndexerConfig()
        self.token_processor = ChunkedTokenDatabase(self.config.token_processor_config)
        self.kv_block_index: Index = (
            index if index is not None else create_index(self.config.index_config)
        )
        self.scorer = create_scorer(self.config.scorer_config,
                                    block_size_tokens=self.token_processor.block_size)
        # Chunked native data plane (NativeIndex.score_chunked): early-exit
        # chunked lookup, tier-weighted prefix scoring and the residency
        # fold-in in ONE ctypes crossing. Only the LongestPrefix strategy
        # has a native twin; other strategies take the Python path.
        longest_prefix = self.scorer.strategy == LONGEST_PREFIX_MATCH
        self._native_score_chunked = (
            getattr(self.kv_block_index, "score_chunked", None)
            if longest_prefix else None
        )
        # Native data-plane counters (``data_plane_debug``). Plain int bumps
        # on the hot path — diagnostic reads tolerate the odd lost
        # increment, a lock per score call would not pay for itself.
        self._dp_native_calls = 0
        self._dp_chunks = 0
        self._dp_early_exits = 0
        # Early-exit is only sound for consecutive-from-0 prefix scoring.
        self._early_exit = self.config.lookup_chunk_size > 0 and longest_prefix
        self._tracer = tracer()
        # Score-path latency histogram, exemplar-linked to the request's
        # trace so a slow bucket points at a retained trace.
        self._score_latency = bucket_histogram(
            "kvcache_score_latency_seconds",
            "score_tokens wall time (keys to merged pod scores)",
            (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0),
        )
        # Last-published prefix-cache snapshot, so each score_tokens call
        # records only its delta into the counters.
        self._pc_hit_snapshot = 0
        self._pc_miss_snapshot = 0
        # Per-pod cache-efficiency attribution + score-decision flight
        # records; the event pool shares this ledger (``pool.ledger =
        # indexer.ledger``) so evict/store attribution and score
        # attribution land in one place.
        self.ledger = CacheEfficiencyLedger()
        self._recorder = flight_recorder()
        # Residency-aware decode-pod scoring (prefill/decode
        # disaggregation): None until attach_residency wires a
        # scoring.residency.ResidencyTracker.
        self.residency = None
        # Working-set analytics: None until attach_workingset wires a
        # telemetry.workingset.WorkingSetTracker into the lookup path.
        self.workingset = None
        # Ground-truth audit: None until attach_audit wires a
        # telemetry.audit.AuditLog into the score path.
        self.audit = None

    def prefix_cache_stats(self) -> Optional[dict]:
        """Token-processor prefix-cache counters (None when disabled)."""
        return self.token_processor.prefix_cache_stats()

    def _record_prefix_cache_metrics(self) -> None:
        stats = self.token_processor.prefix_cache_stats()
        if stats is None:
            return
        hit_d = stats["hit_blocks"] - self._pc_hit_snapshot
        miss_d = stats["miss_blocks"] - self._pc_miss_snapshot
        self._pc_hit_snapshot = stats["hit_blocks"]
        self._pc_miss_snapshot = stats["miss_blocks"]
        try:
            record_prefix_cache_delta(hit_d, miss_d)
        except Exception:  # metrics must never break scoring
            logger.debug("prefix-cache metrics failed", exc_info=True)

    def attach_group_catalog(self, group_catalog) -> None:
        """Wire the event pool's GroupCatalog into hybrid-aware scoring
        (no-op for the longest-prefix strategy)."""
        if hasattr(self.scorer, "group_catalog"):
            self.scorer.group_catalog = group_catalog

    def attach_residency(self, tracker) -> None:
        """Wire a scoring.residency.ResidencyTracker into role-aware
        scoring: ``score_tokens(..., role="decode")`` adds each decode
        pod's transferred-prefix residency bonus (landed blocks full
        weight, in-flight discounted) on top of the base prefix score.
        When the index exposes the cost-aware ``tier_discount`` hook, the
        bonus is additionally scaled by the transfer tier's observed restore
        latency — the discount engages ONLY through this path.
        """
        self.residency = tracker
        fn = getattr(self.kv_block_index, "tier_discount", None)
        if fn is not None and tracker.tier_discount_fn is None:
            tracker.tier_discount_fn = lambda: fn(TIER_SHARED_STORAGE)

    def attach_workingset(self, tracker) -> None:
        """Wire a telemetry.workingset.WorkingSetTracker into the score
        path: every lookup's block keys feed the global "index" reuse
        stream (the fleet MRC) and, with the per-key pod map, the
        cross-pod duplication estimator. Unsampled keys cost one dict hit
        each."""
        self.workingset = tracker

    def attach_audit(self, audit_log) -> None:
        """Wire a telemetry.audit.AuditLog into the score path: every
        score decision records its prediction (per-pod scores, residency
        bonuses, and — when the log's ``staleness_fn`` is wired — the
        index staleness at score time) for the join against the serving
        engine's realized outcome. One ring append per score call."""
        self.audit = audit_log

    def attach_liveness(self, liveness) -> None:
        """Wire the event pool's PodLivenessTracker into scoring: pods whose
        event stream went silent are demoted (stale index views overstate
        what the pod still holds) and eventually dropped, so routing decays
        toward the picker's round-robin fallback instead of pinning traffic
        on a corpse. Applied inside the scorers."""
        self.scorer.liveness = liveness

    def compute_block_keys(
        self,
        tokens: Sequence[int],
        model_name: str,
        extra_features: Optional[Sequence[Optional[BlockExtraFeatures]]] = None,
    ) -> list[BlockHash]:
        """Content-address tokens at the canonical block size
        (reference ``indexer.go:178-195``)."""
        return self.token_processor.tokens_to_kv_block_keys(
            0, tokens, model_name, extra_features
        )

    def score_tokens(
        self,
        tokens: Sequence[int],
        model_name: str,
        pod_identifiers: Optional[set[str]] = None,
        extra_features: Optional[Sequence[Optional[BlockExtraFeatures]]] = None,
        role: str = "",
        detail: Optional[dict] = None,
    ) -> dict[str, float]:
        """Score candidate pods for the given tokens
        (reference ``indexer.go:238-303``).

        Returns pod → tier-weighted consecutive-prefix score. Pods in
        ``pod_identifiers`` that hold nothing simply do not appear.

        ``role`` is the requesting scheduler's target pod role ("" =
        role-agnostic, the legacy behavior). For ``role="decode"`` with a
        residency tracker attached, each pod's transferred-prefix
        residency bonus is added on top; when ``detail`` is a dict, the
        per-pod bonus is written into ``detail["residency"]``.
        """
        t0 = time.perf_counter()
        trace_ref: list = [None]
        try:
            return self._score_tokens_traced(
                tokens, model_name, pod_identifiers, extra_features,
                role, detail, trace_ref,
            )
        finally:
            tp = trace_ref[0]
            self._score_latency.observe(
                time.perf_counter() - t0,
                trace_id=None if tp is None else tp[3:35],
            )

    def _score_tokens_traced(
        self,
        tokens: Sequence[int],
        model_name: str,
        pod_identifiers: Optional[set[str]],
        extra_features: Optional[Sequence[Optional[BlockExtraFeatures]]],
        role: str,
        detail: Optional[dict],
        trace_ref: list,
    ) -> dict[str, float]:
        with self._tracer.span(
            "llm_d.kv_cache.score_tokens",
            model=model_name,
            token_count=len(tokens),
            pod_count=len(pod_identifiers) if pod_identifiers else 0,
            role=role,
        ) as span:
            # RecordedSpan exposes .traceparent; the no-op/otel spans do
            # not — no exemplar in those modes.
            trace_ref[0] = getattr(span, "traceparent", None)
            block_keys, keys_arr = (
                self.token_processor.tokens_to_kv_block_keys_with_array(
                    0, tokens, model_name, extra_features))
            span.set_attribute("block_count", len(block_keys))
            self._record_prefix_cache_metrics()
            if not block_keys:
                return {}

            # End-to-end deadline: the index lookup is the one blocking
            # site on this path — check the ambient budget before paying
            # for it (no-op without a deadline_scope).
            dl = current_deadline()
            if dl is not None:
                dl.check("scoring.index_lookup")

            if self._native_score_chunked is not None:
                return self._score_native_chunked(
                    keys_arr if keys_arr is not None else block_keys,
                    block_keys, model_name, pod_identifiers, role, detail,
                    span,
                )

            if self._early_exit:
                key_to_pods = self.kv_block_index.lookup_chunked(
                    block_keys, pod_identifiers,
                    chunk_size=self.config.lookup_chunk_size,
                )
            else:
                key_to_pods = self.kv_block_index.lookup(block_keys, pod_identifiers)
            span.set_attribute("block_hit_count", len(key_to_pods))
            span.set_attribute("block_hit_ratio", len(key_to_pods) / len(block_keys))
            scores = self.scorer.score(block_keys, key_to_pods)
            scores = self._apply_residency(
                scores, block_keys, pod_identifiers, role, detail)
            self._record_score_decision(
                model_name, len(block_keys), len(key_to_pods), scores,
                traceparent=trace_ref[0],
                residency=None if detail is None else detail.get("residency"),
            )
            if self.workingset is not None:
                self.workingset.record_index_lookup(
                    block_keys, key_to_pods, hits=len(key_to_pods))
            return scores

    def _score_native_chunked(
        self,
        keys,
        block_keys: Sequence[BlockHash],
        model_name: str,
        pod_identifiers: Optional[set[str]],
        role: str,
        detail: Optional[dict],
        span,
    ) -> dict[str, float]:
        """Native chunked data plane: one C++ pass runs the early-exit
        chunked lookup AND the residency-bonus walk; Python only folds —
        liveness weighting applies to the base scores first, then the
        bonus lands on top, exactly like the unfused path."""
        apply_res = role == "decode" and self.residency is not None
        claims = (
            self.residency.claim_rows(block_keys, pod_identifiers)
            if apply_res else []
        )
        scores, hit_count, res_bonus, dp = self._native_score_chunked(
            keys, self.scorer.medium_weights, pod_identifiers,
            chunk_size=(
                self.config.lookup_chunk_size if self._early_exit else 0
            ),
            claims=claims,
            landed_weight=(
                self.residency.landed_weight if apply_res else 1.0
            ),
            in_flight_discount=(
                self.residency.in_flight_discount if apply_res else 0.5
            ),
            tier_discount=(
                self.residency.discount() if claims else 1.0
            ),
        )
        span.set_attribute("block_hit_count", hit_count)
        span.set_attribute("block_hit_ratio", hit_count / len(block_keys))
        span.set_attribute("native_chunks", dp["chunks"])
        self._dp_native_calls += 1
        self._dp_chunks += dp["chunks"]
        self._dp_early_exits += dp["early_exited"]
        try:
            record_native_score(dp["chunks"], dp["early_exited"])
        except Exception:  # metrics must never break scoring
            logger.debug("native-score metrics failed", exc_info=True)
        scores = self.scorer._apply_liveness(scores)
        if res_bonus:
            for pod, b in res_bonus.items():
                scores[pod] = scores.get(pod, 0.0) + b
        if apply_res and detail is not None:
            detail["residency"] = res_bonus
        self._record_score_decision(
            model_name, len(block_keys), hit_count, scores,
            traceparent=getattr(span, "traceparent", None),
            residency=res_bonus if apply_res else None,
        )
        if self.workingset is not None:
            # The fused C++ path returns no per-key pod map: the reuse
            # stream still gets every key, the duplication estimator rides
            # the Python path only.
            self.workingset.record_index_lookup(
                block_keys, None, hits=hit_count)
        return scores

    def data_plane_debug(self) -> dict:
        """Native score data-plane counters."""
        return {
            "native_score_calls": self._dp_native_calls,
            "native_score_chunks": self._dp_chunks,
            "native_score_early_exits": self._dp_early_exits,
        }

    def _apply_residency(
        self,
        scores: dict[str, float],
        block_keys: Sequence[BlockHash],
        pod_identifiers: Optional[set[str]],
        role: str,
        detail: Optional[dict],
    ) -> dict[str, float]:
        """Add transferred-prefix residency bonuses for decode-role scoring.

        No-op unless the request targets decode pods and a residency
        tracker is attached; block keys are the same canonical chunk keys
        the index uses, so the tracker's claims line up 1:1.
        """
        if role != "decode" or self.residency is None:
            return scores
        bonus = self.residency.bonus(block_keys, pod_identifiers)
        if bonus:
            scores = dict(scores)
            for pod, b in bonus.items():
                scores[pod] = scores.get(pod, 0.0) + b
        if detail is not None:
            detail["residency"] = bonus
        return scores

    def _record_score_decision(
        self,
        model_name: str,
        total_blocks: int,
        hit_blocks: int,
        scores: dict[str, float],
        traceparent: Optional[str] = None,
        residency: Optional[dict] = None,
    ) -> None:
        """Ledger + flight-recorder + audit attribution for one score call.

        Kept lean — one ledger lock, one ring store (plus one audit ring
        append when an AuditLog is attached); ``scores`` is handed to the
        recorder and the audit log by reference (diagnostic surfaces,
        treated as frozen).
        """
        self.ledger.record_score(scores, total_blocks, hit_blocks)
        self._recorder.record(
            KIND_SCORE,
            {
                "model": model_name,
                "blocks": total_blocks,
                "hits": hit_blocks,
                "scores": scores,
            },
        )
        if self.audit is not None:
            winner = max(scores, key=scores.get) if scores else None
            self.audit.record_prediction(
                traceparent, model_name, total_blocks,
                scores[winner] if winner is not None else 0.0,
                scores, residency,
            )
