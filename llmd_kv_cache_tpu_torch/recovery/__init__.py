"""Crash-tolerant state: snapshots, journaled warm restart, anti-entropy
reconciliation, and graceful drain (port of ``llmd_kv_cache_tpu/recovery``;
docs/resilience.md, "Crash recovery & drain")."""

from .config import RecoveryConfig
from .drain import DrainCoordinator
from .journal import EventJournal, JournalRecord
from .manager import (
    RecoveryManager,
    STATE_COLD,
    STATE_DRAINING,
    STATE_LOADING,
    STATE_READY,
    STATE_REPLAYING,
    STATE_STOPPED,
    STATE_WARMING,
)
from .reconcile import (
    AntiEntropyReconciler,
    DigestSource,
    IndexDigestSource,
    digest_from_blocks,
    pod_blocks_from_state,
)
from .snapshot import SnapshotError, SnapshotStore, decode_snapshot, encode_snapshot

__all__ = [
    "AntiEntropyReconciler",
    "DigestSource",
    "DrainCoordinator",
    "EventJournal",
    "IndexDigestSource",
    "JournalRecord",
    "RecoveryConfig",
    "RecoveryManager",
    "SnapshotError",
    "SnapshotStore",
    "STATE_COLD",
    "STATE_DRAINING",
    "STATE_LOADING",
    "STATE_READY",
    "STATE_REPLAYING",
    "STATE_STOPPED",
    "STATE_WARMING",
    "decode_snapshot",
    "digest_from_blocks",
    "encode_snapshot",
    "pod_blocks_from_state",
]
