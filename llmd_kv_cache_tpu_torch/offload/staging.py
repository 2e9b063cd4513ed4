"""Recycled host staging buffers for the offload data plane.

Port of ``llmd_kv_cache_tpu/offload/staging.py``. A load job's file reads
land in slots of this pool, and the H2D copy of the restore reads them
there. For pools on the card the slots are **pinned** ``torch.uint8``
tensors (page-locked, so the copy is a DMA that does not stage through a
driver bounce buffer: the role of the reference's ``cudaHostAlloc``
staging); kvio reads into their numpy views. For pools on the CPU they are
plain tensors. Slots are allocated once and recycled, extending on
shortfall instead of failing (reference ``_StagedBackend``,
``llmd_nixl/staged_backend.py:25-106``). Each allocation, the first one
and every extension, is one buffer cut into slots: page-locking costs a
call per buffer, so a slot a call would make a 256-block restore's first
extension pay hundreds of them.

Stores do not stage through a pinned pool: the gather already lands in a
pinned buffer (``CUDABlockCopier.gather_many_to_host``), which the native
writer reads directly, or, with the CRC footer, in a recycled unpinned
buffer of the worker's that holds payload and footer together.
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

logger = logging.getLogger(__name__)


def host_buffer(nbytes: int, pinned: bool) -> tuple[torch.Tensor, np.ndarray]:
    """A ``torch.uint8`` host tensor of ``nbytes`` (page-locked when
    ``pinned``) and its numpy view; the view keeps the tensor alive."""
    t = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
    return t, t.numpy()


class HostStagingPool:
    """Fixed-size-slot buffer pool with extend-on-shortfall.

    ``acquire(n)`` returns a length-``n`` uint8 numpy view of a free slot
    (n ≤ slot_bytes) and ``release`` returns the slot. Thread-safe: the I/O
    pool's completions release concurrently with the engine thread
    acquiring. ``pinned`` says whether slots are page-locked (pools on the
    card need it).
    """

    def __init__(self, slot_bytes: int, slots: int, pinned: bool = False):
        self.slot_bytes = int(slot_bytes)
        self.pinned = pinned
        self._lock = threading.Lock()
        self._free: list[np.ndarray] = self._new_slots(slots)
        self._total = slots
        # Slots handed out, by start address: release() recovers the slot
        # from the view acquire() returned.
        self._out: dict[int, np.ndarray] = {}

    def _new_slots(self, n: int) -> list[np.ndarray]:
        """``n`` slots cut from one new buffer (each slot keeps it alive)."""
        arena = host_buffer(n * self.slot_bytes, self.pinned)[1]
        return [arena[i * self.slot_bytes:(i + 1) * self.slot_bytes] for i in range(n)]

    @property
    def total_slots(self) -> int:
        return self._total

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    def acquire(self, nbytes: int) -> np.ndarray:
        """A length-``nbytes`` uint8 view of a free slot.

        Oversize requests get a transient buffer (pinned like the slots):
        correct, just unrecycled; ``release`` no-ops on it."""
        if nbytes > self.slot_bytes:
            logger.debug("staging request %d B > slot %d B; transient buffer",
                         nbytes, self.slot_bytes)
            return host_buffer(nbytes, self.pinned)[1]
        with self._lock:
            if not self._free:
                # Extend instead of failing: a burst beyond the sizing
                # heuristic is a workload fact, not an error.
                added = max(self._total, 1)
                logger.info("staging pool exhausted: extending by %d slots "
                            "(%d -> %d)", added, self._total, self._total + added)
                self._free.extend(self._new_slots(added))
                self._total += added
            slot = self._free.pop()
            self._out[slot.ctypes.data] = slot
            return slot[:nbytes]

    def release(self, view: np.ndarray) -> None:
        """Return the slot backing ``view`` (idempotent per acquire)."""
        with self._lock:
            slot = self._out.pop(view.ctypes.data, None)
            if slot is not None:
                self._free.append(slot)


def pool_size_for(io_threads: int) -> int:
    """Slots for every I/O thread to keep several reads in flight
    (reference ``staged_backend.py:44-47``'s thread term); the pool extends
    on shortfall, so it is not sized to the cache."""
    return max(io_threads * 8, 16)
