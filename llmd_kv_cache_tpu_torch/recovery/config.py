"""Recovery subsystem configuration.

All knobs ride the usual camelCase/snake_case ``from_dict`` convention
(docs/configuration.md). ``snapshotDir`` is the master switch: empty
(the default) disables the whole subsystem — no snapshot timer, no
journal, no warmup gate — preserving the pre-recovery behavior exactly.

Port of ``llmd_kv_cache_tpu/recovery/config.py``: the same keys and
defaults.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class RecoveryConfig:
    # Directory for snapshots + the event journal; "" disables recovery.
    snapshot_dir: str = ""
    # Periodic snapshot cadence; <= 0 means only shutdown/drain snapshots.
    snapshot_interval_s: float = 30.0
    # Newest snapshots retained (older ones pruned after each save).
    snapshot_keep: int = 3
    # Warm restart serves degraded scores until the index-staleness
    # estimate (events.pool.index_staleness_s) drops below this bound.
    warmup_staleness_bound_s: float = 5.0
    # Graceful drain must finish (intake stop + queue drain + offload
    # flush + final snapshot) within this budget; whatever is left undone
    # at the deadline is abandoned (crash-only: the periodic snapshot
    # still bounds the loss).
    drain_deadline_s: float = 10.0
    # Anti-entropy digest-exchange cadence; <= 0 disables the loop (it
    # also needs a digest source wired in, see recovery.reconcile).
    reconcile_interval_s: float = 0.0
    # Continuous divergence-audit cadence (recovery.reconcile.
    # DivergenceAuditor — digest compare without repair, feeding the
    # kvtpu_index_divergence_* families and the index_divergence SLI);
    # <= 0 keeps it manual. Shares the reconciler's digest source.
    divergence_audit_interval_s: float = 0.0
    # Fraction of pods each divergence-audit round checks (rotating
    # coverage); 1.0 audits every pod every round.
    divergence_audit_sample: float = 1.0
    # Journal fsync cadence in records (1 = every append; higher trades
    # the crash-loss window for ingest throughput).
    journal_sync_every: int = 64

    @property
    def enabled(self) -> bool:
        return bool(self.snapshot_dir)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RecoveryConfig":
        if not d:
            return cls()
        return cls(
            snapshot_dir=d.get("snapshotDir", d.get("snapshot_dir", "")) or "",
            snapshot_interval_s=d.get(
                "snapshotIntervalS", d.get("snapshot_interval_s", 30.0)
            ),
            snapshot_keep=d.get("snapshotKeep", d.get("snapshot_keep", 3)) or 3,
            warmup_staleness_bound_s=d.get(
                "warmupStalenessBoundS", d.get("warmup_staleness_bound_s", 5.0)
            ),
            drain_deadline_s=d.get(
                "drainDeadlineS", d.get("drain_deadline_s", 10.0)
            ),
            reconcile_interval_s=d.get(
                "reconcileIntervalS", d.get("reconcile_interval_s", 0.0)
            ),
            divergence_audit_interval_s=d.get(
                "divergenceAuditIntervalS",
                d.get("divergence_audit_interval_s", 0.0)
            ),
            divergence_audit_sample=d.get(
                "divergenceAuditSample",
                d.get("divergence_audit_sample", 1.0)
            ),
            journal_sync_every=d.get(
                "journalSyncEvery", d.get("journal_sync_every", 64)
            ) or 64,
        )
