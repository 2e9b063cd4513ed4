"""Indexer orchestrator: tokens → block keys → index lookup → pod scores.

Port of ``llmd_kv_cache_tpu/scoring/indexer.py`` (counterpart of reference
``pkg/kvcache/indexer.go``): ``compute_block_keys`` and ``score_tokens``
over the in-memory index, with hybrid-aware scoring
(``attach_group_catalog``), the residency bonus of role-aware decode
scoring (``attach_residency``), and the JAX indexer's observability: the
``llm_d.kv_cache.score_tokens`` span (whose ``traceparent`` a caller hands
to ``MiniEngine.enqueue`` for one trace from score to serve), the
score-latency histogram with trace-id exemplars, the prefix-cache delta
counters, the per-pod ``CacheEfficiencyLedger`` (which the event ``Pool``
shares for store/evict/clear attribution), a ``KIND_SCORE`` flight record
per decision, and the working-set and audit taps (``attach_workingset``,
``attach_audit``). The native fused scorer and its data-plane counters
wait for the native index (ROADMAP A.8). This is the scheduler hot path:
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
from ..index.base import Index
from ..index.in_memory import InMemoryIndex
from ..metrics.collector import bucket_histogram, record_prefix_cache_delta
from ..telemetry.flight_recorder import KIND_SCORE, flight_recorder
from ..telemetry.tracing import tracer
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .scorer import KVBlockScorerConfig, create_scorer

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


@dataclass
class IndexerConfig:
    """Top-level config (reference ``indexer.go:39-61``)."""

    token_processor_config: TokenProcessorConfig = field(default_factory=TokenProcessorConfig)
    scorer_config: KVBlockScorerConfig = field(default_factory=KVBlockScorerConfig)
    # Early-exit chunked lookup: score_tokens looks blocks up in chunks of
    # this many keys and stops at the first chunk that breaks the prefix
    # chain (0 disables — single full lookup).
    lookup_chunk_size: int = 128


class Indexer:
    """KV-cache indexer: the library's main entry point."""

    def __init__(
        self,
        config: Optional[IndexerConfig] = None,
        index: Optional[Index] = None,
    ):
        self.config = config or IndexerConfig()
        self.token_processor = ChunkedTokenDatabase(self.config.token_processor_config)
        self.kv_block_index: Index = index if index is not None else InMemoryIndex()
        self.scorer = create_scorer(self.config.scorer_config,
                                    block_size_tokens=self.token_processor.block_size)
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
        When the index exposes a ``tier_discount`` hook, the bonus is
        additionally scaled by the transfer tier's observed restore
        latency — the discount engages ONLY through this path (the port's
        ``InMemoryIndex`` has none).
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
            block_keys = self.compute_block_keys(tokens, model_name, extra_features)
            span.set_attribute("block_count", len(block_keys))
            self._record_prefix_cache_metrics()
            if not block_keys:
                return {}
            chunk = self.config.lookup_chunk_size
            if chunk > 0:
                key_to_pods = self.kv_block_index.lookup_chunked(
                    block_keys, pod_identifiers, chunk_size=chunk)
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
