"""Scheduler-side offload manager.

Port of ``llmd_kv_cache_tpu/offload/manager.py``, the counterpart of
reference ``llmd_fs_backend/manager.py``: decides which blocks to store/load
against the shared file store. Stateless by design — ``lookup`` is file
existence (touching atime as a recency signal for the evictor), stores are
idempotent, and eviction is delegated entirely to the storage-side evictor.
The JAX manager's ``complete_store`` and ``complete_load_failure`` publish
storage-tier BlockStored/BlockRemoved events; the port has no storage event
publisher yet (ROADMAP A.8), so here they only mark where it will go. The
working-set tap is the JAX manager's: lookups feed the storage-tier reuse
stream, completed stores the written-never-read ledger.
"""

from __future__ import annotations

import logging
from typing import Sequence

from .file_mapper import FileMapper
from .native import file_exists

logger = logging.getLogger(__name__)


class SharedStorageOffloadManager:
    """Tracks nothing; the filesystem is the source of truth."""

    def __init__(self, mapper: FileMapper):
        self.mapper = mapper
        # Optional working-set tap (telemetry.workingset): lookups feed
        # the storage-tier reuse stream, completed stores the
        # written-never-read ledger. Wired by engine.attach_workingset.
        self.workingset = None
        mapper.write_run_config()

    def lookup(self, block_hashes: Sequence[int], group_idx: int = 0) -> int:
        """Longest stored prefix: count of leading blocks present on disk.

        Touches atime on hits so the evictor sees them as recently used
        (reference ``manager.py:100-105``).
        """
        hits = 0
        for h in block_hashes:
            if not file_exists(self.mapper.block_path(h, group_idx), touch_atime=True):
                break
            hits += 1
        if self.workingset is not None and group_idx == 0:
            self.workingset.record_offload_read(block_hashes, hits=hits)
        return hits

    def prepare_store(
        self, block_hashes: Sequence[int], group_idx: int = 0
    ) -> list[int]:
        """Filter to blocks not yet stored (stores are idempotent, but
        skipping known files avoids pointless device→host traffic)."""
        return [
            h for h in block_hashes
            if not file_exists(self.mapper.block_path(h, group_idx))
        ]

    def complete_store(self, block_hashes: Sequence[int]) -> None:
        """Blocks landed on the store (the JAX manager publishes their
        storage-tier BlockStored event here)."""
        if self.workingset is not None and block_hashes:
            self.workingset.record_offload_write(block_hashes)

    def complete_load(self, block_hashes: Sequence[int]) -> None:
        """Loads don't change global state (files remain)."""

    def complete_load_failure(self, corrupt_hashes: Sequence[int]) -> None:
        """Blocks whose files failed checksum verification.

        The worker has already quarantined the files (renamed out of the
        content-addressed namespace), so ``lookup`` misses immediately (the
        JAX manager also publishes their BlockRemoved here).
        """
        if corrupt_hashes:
            logger.warning(
                "de-advertising %d corrupt block(s): %s",
                len(corrupt_hashes),
                ", ".join(f"{h:#x}" for h in list(corrupt_hashes)[:8]),
            )
