"""Ground-truth audit plane: score-vs-reality calibration.

Copy of ``llmd_kv_cache_tpu/telemetry/audit.py``.

The indexer routes every prompt on a *predicted* residency view; nothing
before this module ever checked whether the prediction was true when the
request reached the engine. Two record streams close that loop:

- **predictions** — written by the scorer at score time (``Indexer.
  attach_audit``): the trace id, per-pod scores, residency bonuses, and
  the index staleness (event lag) at the moment of the decision.
- **outcomes** — written by the engine at prefill completion
  (``MiniEngine.attach_audit``): the realized prefix decomposition —
  blocks served straight from HBM, blocks restored from a lower tier,
  blocks recomputed — plus the :class:`ScoreFeedback` the request was
  routed on (``services.indexer_service.ScoreFeedback``).

Both land in a process-local :class:`AuditLog` ring exported over
``/debug/audit?since=SEQ`` with the same cursor semantics as
``/debug/spans`` (non-destructive per-puller cursor, drop counter). The
fleet :class:`~..services.telemetry_collector.TelemetryCollector` pulls
every target's ring and hands the records to an :class:`AuditJoiner`,
which joins predictions to outcomes per trace and emits:

- calibration curves (predicted vs realized hit blocks, exemplar-linked
  ``BucketHistogram`` families),
- per-pod mispredicted-block counters attributed by index staleness at
  score time (``stale`` vs ``fresh``),
- a **routing-regret** counterfactual: requests where another scored
  pod's *calibrated* prediction (its raw score scaled by that pod's
  realized/predicted EMA ratio) beat the chosen pod's realized hit.
  Other pods' realized residency is unobservable — the request only ran
  in one place — so regret is an estimate by construction; the EMA
  calibration keeps a consistently over-advertising pod from winning
  counterfactuals it would have lost (docs/observability.md, "Divergence
  triage").

Hot-path budget: one clock read + one atomic ring append per score
call (no lock — CPython's GIL makes ``deque.append`` and
``itertools.count`` atomic; the dict build and trace-id parse are
deferred to export time), gated < 1% of score p50 by
``bench.py --audit``.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Callable, Optional

from ..utils.lockdep import new_lock
from ..utils.logging import get_logger

logger = get_logger("telemetry.audit")

DEFAULT_CAPACITY = 2048
# The joiner holds unmatched predictions this long at most (bounded by
# count, too); a prediction whose request never reached an audited engine
# (old peer, shed, abort before prefill) must not leak.
DEFAULT_PENDING_LIMIT = 4096


def trace_id_of(traceparent: str) -> str:
    """32-hex trace id of a W3C traceparent ('' when absent/malformed)."""
    if not traceparent:
        return ""
    parts = traceparent.split("-")
    if len(parts) >= 2 and len(parts[1]) == 32:
        return parts[1]
    return ""


class AuditLog:
    """Fixed-capacity ring of prediction/outcome audit records.

    Same cursor shape as the span ring exporter: pullers read
    ``export_since(cursor)`` non-destructively and advance their own
    cursor from ``next_seq``; records older than the ring are counted in
    ``dropped`` so a slow puller knows what it missed. One ring serves
    any number of pullers.

    The write side is lock-free (the score hot path cannot afford a
    lock + eviction bookkeeping per call): sequence numbers come from an
    atomic ``itertools.count`` and the ring is a ``deque(maxlen=...)``
    whose append-with-evict is one atomic C call under the GIL. Drops
    are *derived* at export time (``max seq + 1 - retained``), so a
    contended writer never pays for drop accounting. Two benign races
    follow: a record whose append is preempted between seq issue and
    ring insert can land behind a faster writer (exports filter by seq,
    not position, so at worst one record is seen a pull late), and the
    derived drop count can transiently miscount in-flight appends.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 staleness_fn: Optional[Callable[[], float]] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = capacity
        self._seq = itertools.count()
        self._records: deque = deque(maxlen=capacity)
        # Export-side bookkeeping only (never touched by writers): the
        # kvtpu_audit_dropped_records_total delta emitted per export.
        self._mu = new_lock()
        self._reported_drops = 0
        # Index staleness at score time (events.pool.Pool.index_staleness_s
        # when service-wired); predictions stamp it so the collector can
        # attribute calibration error to event lag. The probe is cached
        # for _STALE_TTL_S: attribution only needs ~1 s resolution
        # (stale_threshold_s), and the pool probe is too expensive to pay
        # per score call.
        self.staleness_fn = staleness_fn
        self._stale_cache = 0.0
        self._stale_ts = -1.0

    _STALE_TTL_S = 0.05

    def _append(self, record) -> None:
        """Ring-append one record: an outcome dict, or a prediction
        tuple (hot path — inflated to a dict only at export). Atomic:
        the maxlen deque evicts the oldest entry in the same C call."""
        self._records.append((next(self._seq), record))

    def _snapshot(self) -> tuple:
        """(records copy, last issued seq, derived drop count).

        ``deque.copy`` is one C call (atomic under the GIL) — iterating
        the live deque while writers append would raise. Seqs are
        dense, so everything not retained was evicted.
        """
        snap = self._records.copy()
        if not snap:
            return snap, -1, 0
        last = max(seq for seq, _ in snap)
        return snap, last, max(last + 1 - len(snap), 0)

    @staticmethod
    def _inflate(seq: int, record) -> dict:
        """Export-time record shape (the deferred half of the hot path)."""
        if isinstance(record, dict):
            out = dict(record)
            out["seq"] = seq
            return out
        ts, traceparent, model, total, hit, scores, residency, stale = record
        return {
            "kind": "prediction",
            "ts": ts,
            "trace_id": trace_id_of(traceparent),
            "traceparent": traceparent,
            "model": model,
            "total_blocks": int(total),
            "hit_blocks": float(hit),
            "scores": scores,
            "residency": residency or {},
            "staleness_s": stale,
            "seq": seq,
        }

    def _flush_drop_metric(self, dropped: int) -> None:
        """Emit the kvtpu_audit_dropped_records_total delta since the
        last export — writers never pay for drop accounting, so the
        metric advances when a puller (or debug view) looks."""
        with self._mu:
            delta = dropped - self._reported_drops
            if delta <= 0:
                return
            self._reported_drops = dropped
        try:
            from ..metrics.collector import record_audit_dropped

            record_audit_dropped(delta)
        except Exception:  # pragma: no cover - metrics must never break audit  # lint: allow-swallow
            pass

    def record_prediction(
        self,
        traceparent: Optional[str],
        model: str,
        total_blocks: int,
        hit_blocks: float,
        scores: dict,
        residency: Optional[dict] = None,
    ) -> None:
        """One score decision, stamped with the index staleness *now*.

        ``hit_blocks`` is the winner's predicted prefix score in block
        units (tier-weighted, so fractional); ``scores`` is kept by
        reference — the score path treats the result dict as frozen once
        returned, same contract as the flight recorder.
        """
        ts = time.time()
        fn = self.staleness_fn
        if fn is None:
            staleness = 0.0
        elif ts - self._stale_ts >= self._STALE_TTL_S:
            try:
                staleness = float(fn() or 0.0)
            except Exception:  # staleness is enrichment, never score-fatal  # lint: allow-swallow
                staleness = 0.0
            self._stale_cache = staleness
            self._stale_ts = ts
        else:
            staleness = self._stale_cache
        # Predictions ride the score hot path, so the stored form is a
        # flat tuple: the dict build and trace-id parse are deferred to
        # export time (_inflate), keeping the per-score cost to one
        # timestamp + one atomic ring append (bench.py --audit gates it
        # <1% of score p50).
        self._records.append((next(self._seq), (
            ts, traceparent or "", model, total_blocks, hit_blocks,
            scores, residency, staleness)))

    def record_outcome(
        self,
        traceparent: Optional[str],
        request_id: str,
        pod: str,
        total_blocks: int,
        hbm_blocks: int,
        restored_blocks: int,
        recomputed_blocks: int,
        feedback=None,
    ) -> None:
        """The realized prefix outcome of one admitted request.

        ``feedback`` is the (duck-typed) ``ScoreFeedback`` the request
        was routed on, when the scheduler passed one to ``enqueue`` —
        its predicted scores ride along so the collector can join even
        when the prediction record itself was dropped from the scorer's
        ring.
        """
        realized = int(hbm_blocks) + int(restored_blocks)
        rec: dict = {
            "kind": "outcome",
            "ts": time.time(),
            "trace_id": trace_id_of(traceparent or ""),
            "traceparent": traceparent or "",
            "request_id": request_id,
            "pod": pod,
            "total_blocks": int(total_blocks),
            "hbm_blocks": int(hbm_blocks),
            "restored_blocks": int(restored_blocks),
            "recomputed_blocks": int(recomputed_blocks),
            "realized_blocks": realized,
        }
        if feedback is not None:
            rec["predicted_blocks"] = float(
                getattr(feedback, "predicted_blocks", 0.0) or 0.0)
            rec["scores"] = dict(getattr(feedback, "scores", {}) or {})
            rec["residency"] = dict(getattr(feedback, "residency", {}) or {})
            rec["staleness_s"] = float(
                getattr(feedback, "staleness_s", 0.0) or 0.0)
        self._append(rec)

    def export_since(self, since: int) -> dict:
        """Records with ``seq > since`` — the ``/debug/audit`` payload,
        cursor semantics identical to ``/debug/spans``."""
        snap, last, dropped = self._snapshot()
        self._flush_drop_metric(dropped)
        return {
            "records": [self._inflate(seq, r)
                        for seq, r in snap if seq > since],
            "next_seq": last,
            "dropped": dropped,
        }

    def debug_view(self) -> dict:
        snap, last, dropped = self._snapshot()
        self._flush_drop_metric(dropped)
        kinds: dict[str, int] = {}
        for _seq, r in snap:
            kind = r["kind"] if isinstance(r, dict) else "prediction"
            kinds[kind] = kinds.get(kind, 0) + 1
        return {
            "capacity": self._capacity,
            "retained": len(snap),
            "next_seq": last + 1,
            "dropped": dropped,
            "kinds": kinds,
        }


class _PodCalibration:
    """Per-pod running calibration state inside the joiner."""

    __slots__ = ("joins", "abs_error_blocks", "ratio_ema", "regrets",
                 "regret_blocks", "stale_mispredicted_blocks",
                 "fresh_mispredicted_blocks")

    def __init__(self):
        self.joins = 0
        self.abs_error_blocks = 0.0
        # realized/predicted EMA; 1.0 = perfectly calibrated. Only
        # observable for pods that actually served requests.
        self.ratio_ema = 1.0
        self.regrets = 0
        self.regret_blocks = 0.0
        self.stale_mispredicted_blocks = 0.0
        self.fresh_mispredicted_blocks = 0.0


class AuditJoiner:
    """Collector-side join of predictions to outcomes per trace.

    ``ingest(records)`` accepts one target's ``/debug/audit`` pull.
    Predictions park (bounded) until the matching outcome arrives from
    the serving engine's ring — usually a different target — then the
    pair is scored: calibration histograms, staleness-attributed
    mispredicted-block counters, and the routing-regret counterfactual.
    Outcomes that carry their own ``ScoreFeedback`` fields join even
    when the prediction record was never seen.
    """

    def __init__(
        self,
        stale_threshold_s: float = 1.0,
        regret_margin_blocks: float = 0.5,
        ema_alpha: float = 0.2,
        calibration_buckets: tuple = (0.5, 1, 2, 4, 8, 16, 32, 64, 128),
        pending_limit: int = DEFAULT_PENDING_LIMIT,
    ):
        self._mu = new_lock()
        self.stale_threshold_s = stale_threshold_s
        self.regret_margin_blocks = regret_margin_blocks
        self.ema_alpha = ema_alpha
        self._pending_limit = pending_limit
        # trace_id -> prediction record, insertion-ordered for eviction.
        self._pending: dict[str, dict] = {}
        self._pods: dict[str, _PodCalibration] = {}
        self.joined = 0
        self.unjoined_outcomes = 0
        self.abs_error_blocks = 0.0
        self.regrets = 0
        from ..metrics.collector import bucket_histogram

        self._predicted_hist = bucket_histogram(
            "kvtpu_audit_predicted_hit_blocks",
            "predicted prefix-hit length (blocks) of joined requests",
            calibration_buckets,
        )
        self._realized_hist = bucket_histogram(
            "kvtpu_audit_realized_hit_blocks",
            "realized prefix-hit length (blocks) of joined requests",
            calibration_buckets,
        )
        self._error_hist = bucket_histogram(
            "kvtpu_audit_calibration_error_blocks",
            "abs(predicted - realized) hit length (blocks) per joined request",
            calibration_buckets,
        )

    def _pod(self, pod: str) -> _PodCalibration:
        st = self._pods.get(pod)
        if st is None:
            st = self._pods[pod] = _PodCalibration()
        return st

    def ingest(self, records: list) -> int:
        """Feed one pull's records; returns the number of joins made."""
        joins = 0
        for rec in records or ():
            try:
                kind = rec.get("kind")
                if kind == "prediction":
                    self._ingest_prediction(rec)
                elif kind == "outcome":
                    joins += 1 if self._ingest_outcome(rec) else 0
            except Exception:  # one bad record must not poison the pull  # lint: allow-swallow
                logger.debug("audit join failed for record %r", rec,
                             exc_info=True)
        return joins

    def _ingest_prediction(self, rec: dict) -> None:
        tid = rec.get("trace_id") or ""
        if not tid:
            return
        with self._mu:
            self._pending[tid] = rec
            while len(self._pending) > self._pending_limit:
                self._pending.pop(next(iter(self._pending)))

    def _ingest_outcome(self, rec: dict) -> bool:
        tid = rec.get("trace_id") or ""
        with self._mu:
            pred = self._pending.pop(tid, None) if tid else None
        scores = dict(rec.get("scores") or {})
        staleness = rec.get("staleness_s")
        if pred is not None:
            scores = scores or dict(pred.get("scores") or {})
            if staleness is None:
                staleness = pred.get("staleness_s", 0.0)
        pod = rec.get("pod") or ""
        predicted = rec.get("predicted_blocks")
        if predicted is None:
            predicted = scores.get(pod) if pred is not None or scores else None
        if predicted is None:
            # No feedback and no parked prediction: nothing to calibrate
            # against (old peer, or the scorer ring dropped it).
            with self._mu:
                self.unjoined_outcomes += 1
            return False
        predicted = float(predicted)
        realized = float(rec.get("realized_blocks", 0))
        staleness = float(staleness or 0.0)
        tid_or_none = tid or None
        self._predicted_hist.observe(predicted, trace_id=tid_or_none)
        self._realized_hist.observe(realized, trace_id=tid_or_none)
        error = abs(predicted - realized)
        self._error_hist.observe(error, trace_id=tid_or_none)
        cause = "stale" if staleness > self.stale_threshold_s else "fresh"
        with self._mu:
            self.joined += 1
            self.abs_error_blocks += error
            st = self._pod(pod)
            st.joins += 1
            st.abs_error_blocks += error
            if cause == "stale":
                st.stale_mispredicted_blocks += error
            else:
                st.fresh_mispredicted_blocks += error
            if predicted > 0:
                a = self.ema_alpha
                st.ratio_ema += a * (realized / predicted - st.ratio_ema)
            regret_pod, regret_blocks = self._regret_locked(
                pod, realized, scores)
            if regret_pod is not None:
                self.regrets += 1
                st.regrets += 1
                st.regret_blocks += regret_blocks
        try:
            from ..metrics.collector import (record_audit_join,
                                             record_audit_regret)

            record_audit_join(pod, error, cause)
            if regret_pod is not None:
                record_audit_regret(pod, regret_blocks)
        except Exception:  # pragma: no cover - metrics never break the join  # lint: allow-swallow
            pass
        return True

    def _regret_locked(self, chosen: str, realized: float,
                       scores: dict) -> tuple[Optional[str], float]:
        """Best calibrated counterfactual among the losing pods, or None.

        A losing pod's estimated realized hit is its predicted score
        scaled by its own realized/predicted EMA (1.0 until observed) —
        an estimate, since the request only ran on ``chosen``.
        """
        best_pod, best_est = None, realized + self.regret_margin_blocks
        for pod, score in scores.items():
            if pod == chosen:
                continue
            st = self._pods.get(pod)
            est = float(score) * (st.ratio_ema if st is not None else 1.0)
            if est > best_est:
                best_pod, best_est = pod, est
        if best_pod is None:
            return None, 0.0
        return best_pod, best_est - realized

    def view(self) -> dict:
        """JSON-able calibration/regret summary (``/debug/audit`` provider
        on the collector, ``kvdiag --fleet`` audit section)."""
        with self._mu:
            joined = self.joined
            return {
                "joined": joined,
                "unjoined_outcomes": self.unjoined_outcomes,
                "pending_predictions": len(self._pending),
                "mean_abs_error_blocks": (
                    self.abs_error_blocks / joined if joined else 0.0),
                "regrets": self.regrets,
                "regret_rate": self.regrets / joined if joined else 0.0,
                "pods": {
                    pod: {
                        "joins": st.joins,
                        "mean_abs_error_blocks": (
                            st.abs_error_blocks / st.joins
                            if st.joins else 0.0),
                        "calibration_ratio": round(st.ratio_ema, 4),
                        "regrets": st.regrets,
                        "regret_blocks": round(st.regret_blocks, 3),
                        "stale_mispredicted_blocks": round(
                            st.stale_mispredicted_blocks, 3),
                        "fresh_mispredicted_blocks": round(
                            st.fresh_mispredicted_blocks, 3),
                    }
                    for pod, st in self._pods.items()
                },
            }
