"""Warm-restart orchestration and the readiness state machine.

One :class:`RecoveryManager` owns the crash-tolerance lifecycle of an
indexer process::

    cold --> loading --> replaying --> warming --> ready
                                          |          |
                                          +-- drain -+--> draining --> stopped

* **loading** — newest valid snapshot restored into the index (corrupt
  ones quarantined, see recovery.snapshot).
* **replaying** — journal records past the snapshot's per-pod sequence
  watermark re-ingested through the pool's normal parse path.
* **warming** — live subscriptions are up, but the index's staleness
  estimate (events.pool.index_staleness_s) is still above
  ``warmupStalenessBoundS``; score responses carry ``degraded=True`` so
  routers can widen their fallback.
* **ready** — staleness under the bound; normal serving.

The per-pod sequence watermark is seeded back into the pool so sequence-
gap detection spans the restart: the first live message after a gap the
journal didn't cover is counted as a gap (and anti-entropy repairs the
content).

Port of ``llmd_kv_cache_tpu/recovery/manager.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..metrics.collector import record_snapshot, record_warm_restart
from ..utils.lockdep import new_lock
from ..telemetry import flight_recorder, tracer
from ..telemetry.flight_recorder import KIND_RECOVERY
from ..utils.logging import get_logger
from .config import RecoveryConfig
from .journal import EventJournal
from .snapshot import SNAPSHOT_VERSION, SnapshotStore

logger = get_logger("recovery.manager")

STATE_COLD = "cold"
STATE_LOADING = "loading"
STATE_REPLAYING = "replaying"
STATE_WARMING = "warming"
STATE_READY = "ready"
STATE_DRAINING = "draining"
STATE_STOPPED = "stopped"

JOURNAL_NAME = "events.journal"


class RecoveryManager:
    """Snapshot timer + warm restart + readiness gate for one index/pool."""

    def __init__(
        self,
        cfg: RecoveryConfig,
        index,
        pool,
        store: Optional[SnapshotStore] = None,
        journal: Optional[EventJournal] = None,
    ):
        self.cfg = cfg
        self.index = index
        self.pool = pool
        self.store = store or SnapshotStore(cfg.snapshot_dir, keep=cfg.snapshot_keep)
        self.journal = journal or EventJournal(
            os.path.join(cfg.snapshot_dir, JOURNAL_NAME),
            sync_every=cfg.journal_sync_every,
        )
        self._mu = new_lock()
        self._state = STATE_COLD
        self._state_since = time.time()
        self.restored_entries = 0
        self.replayed_records = 0
        self.snapshots_written = 0
        self.loaded_snapshot: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sink = None

    # -- state machine ---------------------------------------------------

    @property
    def state(self) -> str:
        # WARMING->READY is pulled, not pushed: every observer of the
        # state (healthz, score path) re-evaluates the staleness gate.
        with self._mu:
            state = self._state
        if state == STATE_WARMING and self._warmed():
            self._transition(STATE_READY, expect=STATE_WARMING)
            return STATE_READY
        return state

    @property
    def ready(self) -> bool:
        return self.state == STATE_READY

    def _warmed(self) -> bool:
        return self.pool.index_staleness_s() <= self.cfg.warmup_staleness_bound_s

    def _transition(self, new: str, expect: Optional[str] = None) -> None:
        with self._mu:
            if expect is not None and self._state != expect:
                return
            old, self._state = self._state, new
            self._state_since = time.time()
        logger.info("recovery state %s -> %s", old, new)
        flight_recorder().record(
            KIND_RECOVERY, {"op": "state", "from": old, "to": new}
        )

    # -- warm restart ----------------------------------------------------

    def warm_restart(self) -> dict:
        """Load newest snapshot, replay the journal past its watermark,
        enter WARMING. Call before live subscriptions start; safe (and a
        fast no-op) on a genuinely cold start."""
        with tracer().span("llm_d.kv_cache.recovery.warm_restart") as span:
            self._transition(STATE_LOADING)
            pod_seqs: dict = {}
            snapshot_ts = 0.0
            loaded = self.store.load_newest()
            if loaded is not None:
                doc, path = loaded
                if doc.get("version") != SNAPSHOT_VERSION:
                    self.store.quarantine(
                        path, f"unsupported version {doc.get('version')!r}"
                    )
                else:
                    self.loaded_snapshot = path
                    pod_seqs = dict(doc.get("pod_seqs") or {})
                    snapshot_ts = float(doc.get("created_unix") or 0.0)
                    index_state = doc.get("index")
                    if index_state:
                        self.restored_entries = self.index.restore_state(index_state)
                    logger.info(
                        "restored %d entries from %s (pods=%d)",
                        self.restored_entries, path, len(pod_seqs),
                    )
            self._transition(STATE_REPLAYING)
            for rec in self.journal.replay(pod_seqs):
                self.pool.replay_record(rec.topic, rec.sequence, rec.payload)
                self.replayed_records += 1
            # Seed the pool's per-pod watermarks so (a) gap detection spans
            # the restart and (b) staleness reflects the snapshot's age
            # until live events catch up — which is exactly the warmup gate.
            if pod_seqs and snapshot_ts > 0:
                self.pool.seed_sequences(pod_seqs, snapshot_ts)
            if self.loaded_snapshot is None and self.replayed_records == 0:
                # Genuinely cold start: nothing to warm from, serve normally.
                self._transition(STATE_READY)
            else:
                self._transition(STATE_WARMING)
            span.set_attribute("restored_entries", self.restored_entries)
            span.set_attribute("replayed_records", self.replayed_records)
        record_warm_restart(self.restored_entries, self.replayed_records)
        summary = {
            "snapshot": self.loaded_snapshot,
            "restored_entries": self.restored_entries,
            "replayed_records": self.replayed_records,
            "state": self.state,
        }
        flight_recorder().record(KIND_RECOVERY, {"op": "warm_restart", **summary})
        return summary

    # -- snapshots -------------------------------------------------------

    def attach_journal(self) -> None:
        """Start journaling live ingestion. Call *after* warm_restart so
        replayed records are not re-journaled."""
        # Keep the exact bound-method object: a fresh `self.journal.append`
        # on every access would never compare identical at detach time.
        self._sink = self.journal.append
        self.pool.journal_sink = self._sink

    def snapshot_now(self, reason: str = "interval") -> Optional[str]:
        """Write one snapshot and rotate the journal. Returns the path, or
        None when the backend has no dumpable state (e.g. bare Redis)."""
        state = self.index.dump_state()
        if state is None:
            return None
        pod_seqs = {
            pod: st.get("last_seq", -1)
            for pod, st in self.pool.lag_stats().get("pods", {}).items()
        }
        doc = {
            "version": SNAPSHOT_VERSION,
            "created_unix": time.time(),
            "reason": reason,
            "pod_seqs": pod_seqs,
            "index": state,
        }
        try:
            path = self.store.save(doc)
        except Exception:
            logger.exception("snapshot write failed")
            record_snapshot("failed", 0, 0.0)
            return None
        self.snapshots_written += 1
        # The snapshot watermark supersedes the journal prefix.
        self.journal.rotate()
        return path

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Attach the journal and start the periodic snapshot thread."""
        self.attach_journal()
        if self.cfg.snapshot_interval_s <= 0:
            return
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.cfg.snapshot_interval_s):
                try:
                    self.snapshot_now("interval")
                except Exception:
                    logger.exception("periodic snapshot failed; continuing")

        self._thread = threading.Thread(
            target=_loop, name="kvtpu-snapshotter", daemon=True
        )
        self._thread.start()

    def stop(self, final_snapshot: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._sink is not None and getattr(self.pool, "journal_sink", None) is self._sink:
            self.pool.journal_sink = None
        if final_snapshot:
            try:
                self.snapshot_now("shutdown")
            except Exception:
                logger.exception("shutdown snapshot failed")
        self.journal.close()
        self._transition(STATE_STOPPED)

    # -- health ----------------------------------------------------------

    def health(self) -> dict:
        """Readiness payload for /healthz and the admin debug surface."""
        state = self.state
        with self._mu:
            since = self._state_since
        staleness = self.pool.index_staleness_s()
        return {
            "status": "ok" if state == STATE_READY else state,
            "state": state,
            "state_age_s": round(max(0.0, time.time() - since), 3),
            "staleness_s": round(staleness, 3),
            "staleness_bound_s": self.cfg.warmup_staleness_bound_s,
            "restored_entries": self.restored_entries,
            "replayed_records": self.replayed_records,
            "snapshots_written": self.snapshots_written,
            "snapshots_quarantined": self.store.quarantined,
            "loaded_snapshot": self.loaded_snapshot,
        }
