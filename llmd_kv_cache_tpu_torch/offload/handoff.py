"""Prefill→decode KV handoff coordination over the offload plane.

Disaggregated serving splits a request across two pods: a **prefill pod**
runs chunked prefill and write-through-commits each chunk's full blocks to
the shared transfer tier (the existing CRC-checksummed offload data plane),
while a **decode pod** admits the same request with the deferred-restore
path polling those blocks in. This module is the small control plane
between them: per-request transfer state (blocks landed vs in flight),
chunk-completion streaming so the decode side can start restoring
layer-early blocks before the prefill tail finishes, the prefill→decode
pair picker, and the failure story — a prefill pod that dies mid-handoff
flips the state to ``failed`` and the decode pod falls back to local
prefill instead of losing the request.

The coordinator is engine-service-local state (one per cooperating pod
group, in-process for the bench and tests); cross-process deployments
publish :class:`~..events.model.TransferBlocksAvailableEvent` through the
``publish`` hook so remote decode pods learn availability over the event
plane.

Copy of ``llmd_kv_cache_tpu/offload/handoff.py``, its telemetry included:
the ``handoff.begin``, ``handoff.prefill_commit`` and ``handoff.complete``
spans under the request's traceparent, and the ``kvtpu_handoff_*`` metric
families (transfer-queue and in-flight gauges, chunk and request outcomes,
handoff latency).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..utils.lockdep import new_lock
from ..events.model import TransferBlocksAvailableEvent
from ..telemetry.tracing import tracer
from ..utils.logging import get_logger

logger = get_logger("offload.handoff")

# Engine roles (EngineConfig.role / ScoreRequest.role). "" on the wire
# means an unspecified role (legacy peers) and scores like "both".
ROLE_BOTH = "both"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


@dataclass
class HandoffState:
    """One request's prefill→decode transfer ledger."""

    request_id: str
    prefill_pod: str
    decode_pod: str
    # Full prompt blocks the transfer can ever cover (the partial tail and
    # the last prompt token are always recomputed on the decode pod).
    total_blocks: int
    started: float = 0.0
    landed_blocks: int = 0
    in_flight_blocks: int = 0
    in_flight_jobs: int = 0
    # Prefill pod has issued its last chunk's store (no more blocks will
    # be queued; some may still be in flight).
    prefill_finished: bool = False
    # Every queued store has settled and no more are coming. ``failed``
    # additionally means the prefill pod died / aborted mid-handoff and
    # the decode side must re-prefill the remainder itself.
    done: bool = False
    failed: bool = False
    finished: Optional[float] = None
    traceparent: Optional[str] = None
    # Topology epoch the handoff was paired under (cluster.membership);
    # 0 = pre-epoch caller. A pairing planned under a retired topology is
    # suspect — the decode pod may no longer own the transferred range.
    epoch: int = 0


class HandoffCoordinator:
    """Tracks prefill→decode transfers and streams chunk completions.

    All methods are thread-safe (offload completions drain on engine
    threads). Metric updates and the optional ``publish``/``residency``
    hooks fire outside the lock.
    """

    def __init__(
        self,
        publish: Optional[Callable[[TransferBlocksAvailableEvent], None]] = None,
        residency=None,
    ):
        self._mu = new_lock()
        self._states: dict[str, HandoffState] = {}
        self.publish = publish
        # Optional scoring.residency.ResidencyTracker: transfer progress
        # feeds residency-aware decode-pod scoring.
        self.residency = residency
        self.completed = 0
        self.failed = 0
        self.last_latency_s: Optional[float] = None
        # Traffic-mix EMA (prefill-token fraction) + per-outcome counters:
        # the fleet controller's starvation signal. ``mix_alpha`` is the
        # EMA weight of one observation batch.
        self.mix_alpha = 0.2
        self._mix_fraction: Optional[float] = None
        self._mix_samples = 0
        self._outcomes: dict[str, int] = {}

    # -- pair picking ----------------------------------------------------

    @staticmethod
    def pick_pair(
        prefill_pods: Sequence[str],
        decode_pods: Sequence[str],
        prefill_scores: Optional[dict[str, float]] = None,
        decode_scores: Optional[dict[str, float]] = None,
    ) -> tuple[str, str]:
        """Pick the prefill→decode pair for one request.

        Highest score wins on each side (prefill: prefix-cache reuse;
        decode: residency-aware score from the indexer); ties and missing
        scores fall back to list order, so with no scores at all the
        first pod of each role serves — deterministic round-robin is the
        caller's job via list rotation.
        """
        if not prefill_pods or not decode_pods:
            raise ValueError("pick_pair needs at least one pod per role")
        ps = prefill_scores or {}
        ds = decode_scores or {}
        prefill = max(prefill_pods, key=lambda p: (ps.get(p, 0.0),
                                                   -prefill_pods.index(p)))
        decode = max(decode_pods, key=lambda p: (ds.get(p, 0.0),
                                                 -decode_pods.index(p)))
        return prefill, decode

    # -- lifecycle -------------------------------------------------------

    def begin(
        self,
        request_id: str,
        prefill_pod: str,
        decode_pod: str,
        total_blocks: int,
        traceparent: Optional[str] = None,
        epoch: int = 0,
    ) -> HandoffState:
        st = HandoffState(
            request_id=request_id,
            prefill_pod=prefill_pod,
            decode_pod=decode_pod,
            total_blocks=max(int(total_blocks), 0),
            started=time.monotonic(),
            traceparent=traceparent,
            epoch=int(epoch),
        )
        with self._mu:
            self._states[request_id] = st
        if traceparent is not None:
            with tracer().span(
                "llm_d.kv_cache.handoff.begin",
                parent_traceparent=traceparent,
                request_id=request_id,
                prefill_pod=prefill_pod,
                decode_pod=decode_pod,
                total_blocks=st.total_blocks,
                epoch=st.epoch,
                process=prefill_pod,
            ):
                pass  # event-style span: marks the pairing decision
        self._update_gauges()
        return st

    def on_chunk_start(self, request_id: str,
                       block_hashes: Sequence[int]) -> None:
        """A prefill chunk's store job entered the offload plane."""
        with self._mu:
            st = self._states.get(request_id)
            if st is None:
                return
            st.in_flight_blocks += len(block_hashes)
            st.in_flight_jobs += 1
        if self.residency is not None:
            self.residency.on_transfer_started(
                st.decode_pod, list(block_hashes))
        self._update_gauges()

    def on_chunk_landed(self, request_id: str,
                        block_hashes: Sequence[int],
                        shed: Sequence[int] = ()) -> None:
        """A chunk's blocks are durably on the transfer tier.

        ``shed`` lists blocks of the same store job the worker dropped
        under pressure — they never land, so their claims are released
        while the rest of the chunk counts as landed.
        """
        with self._mu:
            st = self._states.get(request_id)
            if st is None:
                return
            n = len(block_hashes)
            st.landed_blocks += n
            st.in_flight_blocks = max(st.in_flight_blocks - n - len(shed), 0)
            st.in_flight_jobs = max(st.in_flight_jobs - 1, 0)
            if st.prefill_finished and st.in_flight_jobs == 0:
                st.done = True
            tp = st.traceparent
            decode_pod = st.decode_pod
            prefill_pod = st.prefill_pod
            done = st.done
            landed = st.landed_blocks
            total = st.total_blocks
        self._record_chunk("landed")
        if self.residency is not None:
            self.residency.on_landed(decode_pod, list(block_hashes))
            if shed:
                self.residency.on_released(decode_pod, list(shed))
        if tp is not None:
            with tracer().span(
                "llm_d.kv_cache.handoff.prefill_commit",
                parent_traceparent=tp,
                request_id=request_id,
                blocks=len(block_hashes),
                landed_blocks=landed,
                total_blocks=total,
                process=prefill_pod,
            ):
                pass  # event-style span: one per landed chunk
        if self.publish is not None:
            self.publish(TransferBlocksAvailableEvent(
                request_id=request_id,
                block_hashes=list(block_hashes),
                decode_pod=decode_pod,
                done=done,
            ))
        self._update_gauges()

    def on_chunk_failed(self, request_id: str,
                        block_hashes: Sequence[int]) -> None:
        """A chunk's store failed or was shed: its blocks never land.

        Not terminal for the handoff — the decode pod recomputes from the
        first missing block once the transfer settles.
        """
        with self._mu:
            st = self._states.get(request_id)
            if st is None:
                return
            st.in_flight_blocks = max(
                st.in_flight_blocks - len(block_hashes), 0)
            st.in_flight_jobs = max(st.in_flight_jobs - 1, 0)
            if st.prefill_finished and st.in_flight_jobs == 0:
                st.done = True
            decode_pod = st.decode_pod
        self._record_chunk("failed")
        if self.residency is not None:
            self.residency.on_released(decode_pod, list(block_hashes))
        self._update_gauges()

    def prefill_finished(self, request_id: str) -> None:
        """The prefill pod issued its final chunk (stores may still be in
        flight); once they settle the transfer is ``done``."""
        with self._mu:
            st = self._states.get(request_id)
            if st is None:
                return
            st.prefill_finished = True
            if st.in_flight_jobs == 0:
                st.done = True
        self._update_gauges()

    def fail(self, request_id: str, reason: str = "") -> None:
        """Prefill pod died / aborted mid-handoff: the decode pod must
        re-prefill the un-transferred remainder (nothing already landed is
        wasted — landed blocks stay restorable and checksummed)."""
        with self._mu:
            st = self._states.get(request_id)
            if st is None or st.failed:
                return
            st.failed = True
            st.done = True
            st.in_flight_blocks = 0
            st.in_flight_jobs = 0
        logger.warning("handoff for %s failed mid-transfer%s", request_id,
                       f": {reason}" if reason else "")
        self._update_gauges()

    def decode_settled(self, request_id: str, outcome: str) -> None:
        """The decode pod stopped waiting on this transfer.

        ``outcome``: ``complete`` (every transferable block restored),
        ``fallback`` (peer failed → local re-prefill), ``timeout`` (gave
        up at the deadline), or ``failed``. Terminal: records the handoff
        latency histogram, emits the completion span, and releases the
        residency claim (the storage tier's own BlockStored advertisements
        cover the blocks from here on).
        """
        with self._mu:
            st = self._states.pop(request_id, None)
        if st is None:
            return
        st.finished = time.monotonic()
        latency = st.finished - st.started
        self.last_latency_s = latency
        if outcome == "complete":
            self.completed += 1
        else:
            self.failed += 1
        with self._mu:
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
        try:
            from ..metrics.collector import record_handoff_request

            record_handoff_request(outcome, latency)
        except Exception:  # pragma: no cover  # lint: allow-swallow
            pass
        if st.traceparent is not None:
            with tracer().span(
                "llm_d.kv_cache.handoff.complete",
                parent_traceparent=st.traceparent,
                request_id=request_id,
                outcome=outcome,
                landed_blocks=st.landed_blocks,
                total_blocks=st.total_blocks,
                process=st.decode_pod,
            ):
                pass  # event-style span: terminal handoff outcome
        if self.residency is not None:
            self.residency.release_pod_claims(st.decode_pod)
        self._update_gauges()

    # -- traffic mix / starvation ----------------------------------------

    def observe_mix(self, prefill_tokens: int, decode_tokens: int) -> None:
        """Fold one batch's prefill/decode token split into the mix EMA.

        The router (or engine service) calls this per admitted request or
        per batch; the EMA'd prefill fraction is what the fleet controller
        compares against the provisioned role split to spot a starved
        side.
        """
        total = max(prefill_tokens, 0) + max(decode_tokens, 0)
        if total <= 0:
            return
        frac = max(prefill_tokens, 0) / total
        with self._mu:
            if self._mix_fraction is None:
                self._mix_fraction = frac
            else:
                self._mix_fraction += self.mix_alpha * (frac - self._mix_fraction)
            self._mix_samples += 1

    def starvation(self) -> dict:
        """Residency/starvation view for the fleet controller + kvdiag.

        ``starved_side`` is a *hint* from transfer pressure alone:
        ``timeout``/``fallback`` outcomes mean decode pods gave up waiting
        on prefill output (prefill capacity starved); a deep transfer
        queue with healthy outcomes means decode pods are not draining
        restores (decode starved). The controller combines this with the
        mix-vs-provisioned imbalance before acting.
        """
        with self._mu:
            active = [st for st in self._states.values() if not st.done]
            in_flight = sum(st.in_flight_jobs for st in self._states.values())
            outcomes = dict(self._outcomes)
            mix = self._mix_fraction
            samples = self._mix_samples
        gave_up = outcomes.get("timeout", 0) + outcomes.get("fallback", 0) \
            + outcomes.get("failed", 0)
        settled = gave_up + outcomes.get("complete", 0)
        starved_side = None
        if settled and gave_up / settled > 0.1:
            starved_side = ROLE_PREFILL
        elif len(active) > 2 * max(in_flight, 1):
            starved_side = ROLE_DECODE
        return {
            "mix": {
                "prefill_fraction": None if mix is None else round(mix, 4),
                "samples": samples,
                "alpha": self.mix_alpha,
            },
            "outcomes": outcomes,
            "transfer_queue_depth": len(active),
            "in_flight_jobs": in_flight,
            "last_handoff_latency_s": self.last_latency_s,
            "starved_side": starved_side,
        }

    # -- introspection ---------------------------------------------------

    def state(self, request_id: str) -> Optional[HandoffState]:
        with self._mu:
            return self._states.get(request_id)

    def queue_depth(self) -> int:
        with self._mu:
            return sum(1 for st in self._states.values() if not st.done)

    def in_flight_jobs(self) -> int:
        with self._mu:
            return sum(st.in_flight_jobs for st in self._states.values())

    def debug(self) -> dict:
        """Snapshot for kvdiag's ``handoff`` section / admin providers."""
        with self._mu:
            active = [st for st in self._states.values() if not st.done]
            in_flight = sum(st.in_flight_jobs
                            for st in self._states.values())
        return {
            "transfer_queue_depth": len(active),
            "in_flight_jobs": in_flight,
            "completed": self.completed,
            "failed": self.failed,
            "last_handoff_latency_s": self.last_latency_s,
            "starvation": self.starvation(),
        }

    # -- internals -------------------------------------------------------

    def _record_chunk(self, outcome: str) -> None:
        try:
            from ..metrics.collector import record_handoff_chunk

            record_handoff_chunk(outcome)
        except Exception:  # pragma: no cover  # lint: allow-swallow
            pass

    def _update_gauges(self) -> None:
        try:
            from ..metrics.collector import record_handoff_gauges

            record_handoff_gauges(self.queue_depth(), self.in_flight_jobs())
        except Exception:  # pragma: no cover  # lint: allow-swallow
            pass
