"""Anti-entropy reconciliation: digest exchange + incremental repair.

The event stream is lossy (ZMQ PUB/SUB drops under backpressure, the
bounded shard queues drop-oldest under overload, and a restart loses
whatever was published while the process was down). Snapshots + journal
replay bound the loss; this module closes the residual gap the way
Dynamo-style systems do — by periodically comparing a cheap *digest* of
each pod's indexed blocks against the pod's advertised truth and
repairing only the divergent pods, incrementally.

A pod digest is order-independent::

    digest(pod) = XOR over blocks of fnv1a_64(cbor([request_key, row]))

where ``row`` is the snapshot row ``[pod, tier, flags, group_idx]``.
XOR-of-hashes makes the digest insensitive to iteration order and O(1)
to compare; matching digests skip the pod entirely, so steady-state
rounds touch no index state.

The truth side is abstracted behind :class:`DigestSource` — in tests and
single-host deployments an :class:`IndexDigestSource` wraps a live
reference index; a cluster deployment implements the protocol over the
pods' advertised state (events ``reconciler``/``subscriber_manager``
discovery).

Port of ``llmd_kv_cache_tpu/recovery/reconcile.py``: the same states give
the same digests, reports and repairs in both packages. Metrics are
recorded on the port's registry, called directly.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Protocol

from ..core.keys import KeyType, PodEntry
from ..metrics.collector import (
    record_divergence_audit,
    record_divergence_healed,
    record_reconcile,
)
from ..telemetry import flight_recorder, tracer
from ..telemetry.flight_recorder import KIND_AUDIT, KIND_RECOVERY
from ..utils.cbor import canonical_cbor_encode
from ..utils.fnv import fnv1a_64
from ..utils.logging import get_logger

logger = get_logger("recovery.reconcile")


def _row_hash(request_key: int, row: list) -> int:
    return fnv1a_64(canonical_cbor_encode([request_key, list(row)]))


def pod_blocks_from_state(state: Optional[dict], pod: str) -> dict:
    """``{request_key: {row_tuple, ...}}`` for one pod, from a
    ``dump_state()`` document."""
    out: dict = {}
    if not state:
        return out
    for request_key, rows in state.get("entries", []):
        mine = {tuple(r) for r in rows if r[0] == pod}
        if mine:
            out[request_key] = mine
    return out


def digest_from_blocks(blocks: dict) -> dict:
    """Order-independent ``{"count": n, "digest": x}`` over pod blocks."""
    digest = 0
    count = 0
    for request_key, rows in blocks.items():
        for row in rows:
            digest ^= _row_hash(request_key, list(row))
            count += 1
    return {"count": count, "digest": digest}


class DigestSource(Protocol):
    """A pod's advertised cache truth, digest-first."""

    def pods(self) -> list:
        """Pods this source can answer for."""

    def digest(self, pod: str) -> dict:
        """``{"count", "digest"}`` of the pod's advertised blocks."""

    def blocks(self, pod: str) -> dict:
        """Full ``{request_key: {row_tuple,...}}`` — only fetched when the
        digests already disagreed."""


class IndexDigestSource:
    """DigestSource over a live Index treated as ground truth (tests,
    in-process replicas)."""

    def __init__(self, index):
        self.index = index

    def _state(self) -> Optional[dict]:
        return self.index.dump_state()

    def pods(self) -> list:
        state = self._state()
        if not state:
            return []
        seen = set()
        for _rk, rows in state.get("entries", []):
            for row in rows:
                seen.add(row[0])
        return sorted(seen)

    def digest(self, pod: str) -> dict:
        return digest_from_blocks(pod_blocks_from_state(self._state(), pod))

    def blocks(self, pod: str) -> dict:
        return pod_blocks_from_state(self._state(), pod)


def _entry_from_row(row) -> PodEntry:
    pod, tier, flags, group_idx = row[0], row[1], int(row[2]), int(row[3])
    return PodEntry(
        pod_identifier=pod,
        device_tier=tier,
        speculative=bool(flags & 1),
        has_group=bool(flags & 2),
        group_idx=group_idx,
    )


class AntiEntropyReconciler:
    """Background digest exchange + repair loop.

    Modeled on :class:`~llmd_kv_cache_tpu.events.reconciler.PodReconciler`:
    an Event-stopped daemon thread running ``reconcile_once()`` every
    ``interval_s``. ``reconcile_once()`` is also callable directly
    (tests, admin-triggered repair).
    """

    def __init__(self, index, source: DigestSource, interval_s: float = 30.0):
        self.index = index
        self.source = source
        self.interval_s = interval_s
        self.runs = 0
        self.repaired_added = 0
        self.repaired_removed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one round -------------------------------------------------------

    def _repair_pod(self, pod: str, local: dict, remote: dict) -> tuple[int, int]:
        """Make the local index's view of ``pod`` match ``remote``."""
        added = 0
        removed = 0
        for request_key, rows in remote.items():
            missing = rows - local.get(request_key, set())
            if missing:
                entries = [_entry_from_row(r) for r in sorted(missing)]
                self.index.add(None, [request_key], entries)
                added += len(entries)
        for request_key, rows in local.items():
            extra = rows - remote.get(request_key, set())
            if extra:
                entries = [_entry_from_row(r) for r in sorted(extra)]
                self.index.evict(request_key, KeyType.REQUEST, entries)
                removed += len(entries)
        return added, removed

    def reconcile_once(self) -> dict:
        """One digest-exchange round; returns its stats."""
        self.runs += 1
        added = 0
        removed = 0
        divergent: list = []
        with tracer().span("llm_d.kv_cache.recovery.reconcile") as span:
            state = self.index.dump_state()
            pods = set(self.source.pods())
            # Pods only we know about still need checking (the source may
            # have cleared them entirely).
            if state:
                for _rk, rows in state.get("entries", []):
                    for row in rows:
                        pods.add(row[0])
            for pod in sorted(pods):
                local_blocks = pod_blocks_from_state(state, pod)
                if digest_from_blocks(local_blocks) == self.source.digest(pod):
                    continue
                divergent.append(pod)
                a, r = self._repair_pod(pod, local_blocks, self.source.blocks(pod))
                added += a
                removed += r
            span.set_attribute("pods_checked", len(pods))
            span.set_attribute("divergent", len(divergent))
            span.set_attribute("repaired_added", added)
            span.set_attribute("repaired_removed", removed)
        self.repaired_added += added
        self.repaired_removed += removed
        stats = {
            "pods_checked": len(pods),
            "divergent": divergent,
            "repaired_added": added,
            "repaired_removed": removed,
        }
        if divergent:
            logger.info(
                "anti-entropy repaired %d pods (+%d/-%d entries): %s",
                len(divergent), added, removed, divergent,
            )
            flight_recorder().record(KIND_RECOVERY, {"op": "reconcile", **stats})
        record_reconcile(added, removed)
        return stats

    # -- background loop -------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.reconcile_once()
                except Exception:
                    logger.exception("anti-entropy round failed; continuing")

        self._thread = threading.Thread(
            target=_loop, name="kvtpu-anti-entropy", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class DivergenceAuditor:
    """Always-on sampled divergence audit: digest compare, no repair.

    The reconciler above *fixes* divergence but only tells you about it
    after the fact (flight record + repair counters); by then the SLI
    question — "how long was routing running on a wrong view, and on
    which pod?" — is unanswerable. This auditor runs the same XOR-digest
    comparison continuously WITHOUT repairing, so divergence is a
    measured condition rather than a repair side effect:

    - per pod: **phantom** blocks (the index advertises them, the
      engine's truth lacks them — scores overshoot) and **ghost** blocks
      (the engine holds them unindexed — scores undershoot), exported as
      ``kvtpu_index_divergence_*`` gauges;
    - checked/divergent counters per round, the feed for the
      ``index_divergence`` SLI burn windows in the fleet collector;
    - a divergence-age histogram observed when an episode heals (repair
      or natural event-stream convergence), plus a :data:`KIND_AUDIT`
      flight record at each divergence onset and heal.

    ``sample`` audits only that fraction of pods per round (rotating, so
    every pod is still covered within ``1/sample`` rounds) — the digest
    is cheap but ``dump_state()`` on a huge index is not free. Repair
    stays the reconciler's job; deployments typically run both off the
    same :class:`DigestSource`.
    """

    def __init__(self, index, source: DigestSource, interval_s: float = 10.0,
                 sample: float = 1.0, clock=time.time):
        self.index = index
        self.source = source
        self.interval_s = interval_s
        self.sample = min(max(sample, 0.0), 1.0) or 1.0
        self.rounds = 0
        self._clock = clock
        self._cursor = 0
        # pod -> episode-start ts, for the divergence-age histogram.
        self._since: dict[str, float] = {}
        # pod -> {"phantom": n, "ghost": n} as of its last audited round.
        self._last: dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _pods_this_round(self, pods: list) -> list:
        if not pods or self.sample >= 1.0:
            return pods
        n = max(1, int(len(pods) * self.sample))
        start = self._cursor % len(pods)
        self._cursor = (start + n) % len(pods)
        return [pods[(start + i) % len(pods)] for i in range(n)]

    def audit_once(self) -> dict:
        """One audit round; returns its stats (and never mutates the index)."""
        self.rounds += 1
        now = self._clock()
        divergent: dict[str, dict] = {}
        with tracer().span("llm_d.kv_cache.recovery.divergence_audit") as span:
            state = self.index.dump_state()
            pods = set(self.source.pods())
            if state:
                for _rk, rows in state.get("entries", []):
                    for row in rows:
                        pods.add(row[0])
            audited = self._pods_this_round(sorted(pods))
            for pod in audited:
                local = pod_blocks_from_state(state, pod)
                phantom = 0
                ghost = 0
                if digest_from_blocks(local) != self.source.digest(pod):
                    remote = self.source.blocks(pod)
                    for rk, rows in local.items():
                        phantom += len(rows - remote.get(rk, set()))
                    for rk, rows in remote.items():
                        ghost += len(rows - local.get(rk, set()))
                is_div = bool(phantom or ghost)
                if is_div:
                    divergent[pod] = {"phantom": phantom, "ghost": ghost}
                    if pod not in self._since:
                        self._since[pod] = now
                        flight_recorder().record(KIND_AUDIT, {
                            "op": "divergence_onset", "pod": pod,
                            "phantom": phantom, "ghost": ghost,
                        })
                elif pod in self._since:
                    age = max(now - self._since.pop(pod), 0.0)
                    flight_recorder().record(KIND_AUDIT, {
                        "op": "divergence_healed", "pod": pod,
                        "age_s": age,
                    })
                    record_divergence_healed(age)
                self._last[pod] = {"phantom": phantom, "ghost": ghost}
                record_divergence_audit(pod, is_div, phantom, ghost)
            span.set_attribute("pods_checked", len(audited))
            span.set_attribute("divergent", len(divergent))
        if divergent:
            logger.info("divergence audit: %d pod(s) divergent: %s",
                        len(divergent), sorted(divergent))
        return {
            "pods_checked": len(audited),
            "divergent": divergent,
        }

    def debug_view(self) -> dict:
        """JSON-able state for ``/debug/vars`` / kvdiag."""
        now = self._clock()
        return {
            "rounds": self.rounds,
            "interval_s": self.interval_s,
            "sample": self.sample,
            "divergent_now": {
                pod: {**self._last.get(pod, {}),
                      "age_s": round(max(now - since, 0.0), 3)}
                for pod, since in self._since.items()
            },
        }

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.audit_once()
                except Exception:
                    logger.exception("divergence audit round failed; continuing")

        self._thread = threading.Thread(
            target=_loop, name="kvtpu-divergence-audit", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
