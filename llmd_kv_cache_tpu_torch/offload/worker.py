"""Worker-side offload handlers: device ↔ storage transfer execution.

Port of ``llmd_kv_cache_tpu/offload/worker.py``, the counterpart of
reference ``llmd_fs_backend/worker.py`` + the C++ ``StorageOffloadEngine``
job lifecycle (``storage_offload.cpp``): async store/load jobs over groups of
KV pages, completion polling, retries, quarantine of corrupt files,
cancellation, per-job throughput accounting. The device↔host leg is the
copier (``cuda_copier``: side stream, pinned host buffers); the host↔file
leg is the native I/O pool (``native``). File bytes are the JAX package's.

Each settled job leaves an ``llm_d.kv_cache.offload.job`` span, parented
under the trace that was current when the job was submitted, and a
``KIND_OFFLOAD`` flight record; each retry a ``KIND_RETRY`` record, as in
the JAX module. Differences from the JAX module: load footers are read
into small unpinned buffers (they never go to the device) instead of
whole staging slots; a
store's payload and footer are copied into recycled host buffers instead
of a fresh concatenation per file (first-touch page faults made that copy
the costliest part of a write-through); the I/O workers are pinned to the
card's NUMA node (``native.card_numa_node``).

Store: gather pages → host slab (D2H DMA) → queue atomic file write.
Load:  queue file read into a host buffer → on completion, H2D + scatter.
Loads are processed by read-preferring workers at high priority; writes
may be shed under sustained pressure (EMA limit), degrading to future
cache misses rather than latency.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..resilience.failpoints import FaultInjected, failpoints
from ..resilience.integrity import (
    IntegrityError,
    build_footer,
    footer_size,
    parse_footer,
    slot_crcs,
)
from ..resilience.policy import RetryPolicy
from ..telemetry import current_traceparent, flight_recorder, tracer
from ..telemetry.flight_recorder import KIND_OFFLOAD, KIND_RETRY
from .cuda_copier import CUDABlockCopier
from .file_mapper import FileMapper
from .native import (
    STATUS_CANCELLED,
    STATUS_IO_ERROR,
    STATUS_OK,
    STATUS_PENDING,
    NativeIOEngine,
    card_numa_node,
)
from .staging import HostStagingPool, pool_size_for

logger = logging.getLogger(__name__)

# Failpoints on the offload data plane:
#   - io_error pair: force a completed job's status to IO_ERROR, exercising
#     the retry/backoff path without touching the native pool;
#   - torn: corrupt the written payload AFTER its checksums are computed,
#     simulating a torn write / bitrot that only load-time verification
#     can catch.
FP_STORE_IO_ERROR = "offload.store.io_error"
FP_LOAD_IO_ERROR = "offload.load.io_error"
FP_STORE_TORN = "offload.store.torn"

QUARANTINE_SUFFIX = ".quarantine"


@dataclass
class TransferResult:
    job_id: int
    success: bool
    is_store: bool
    bytes_transferred: int = 0
    seconds: float = 0.0
    # Block hashes whose writes were shed by the EMA queue limit (stores
    # only): these blocks are NOT on disk and must not be advertised.
    shed_hashes: list = field(default_factory=list)
    # Loads: file keys whose checksum verification failed. The files have
    # been quarantined on disk; the caller must de-advertise the blocks.
    corrupt_hashes: list = field(default_factory=list)
    # Submission rounds the job took (1 = no retry).
    attempts: int = 1

    @property
    def shed_blocks(self) -> int:
        return len(self.shed_hashes)

    @property
    def throughput_gbps(self) -> float:
        if self.seconds <= 0:
            return 0.0
        return self.bytes_transferred / self.seconds / 1e9


@dataclass
class _StoreUnit:
    """One file write of a store job (payload with footer pre-appended)."""

    key: int
    buf: "np.ndarray"


@dataclass
class _LoadUnit:
    """One file's reads within a load job.

    ``payload`` covers file slots ``[slot_lo, slot_lo + covered)`` of a
    file with ``num_slots`` total slots; ``footer`` (when integrity is on)
    receives the checksum footer read from the file tail.
    """

    key: int
    payload: "np.ndarray"
    footer: Optional["np.ndarray"]
    slot_lo: int
    covered: int
    num_slots: int
    # (buffer_slice, page_ids) pairs to scatter once verified.
    scatters: list = field(default_factory=list)


@dataclass
class _PendingJob:
    job_id: int  # current native job id (changes across retries)
    report_id: int  # job id the caller polls/waits on (first native id)
    is_store: bool
    started: float
    nbytes: int
    attempt: int = 1
    shed_hashes: list = field(default_factory=list)
    # Keep host buffers alive until the native engine is done with them.
    buffers: list = field(default_factory=list)
    store_units: list = field(default_factory=list)
    load_units: list = field(default_factory=list)
    group_idx: int = 0  # cache group the job's pages belong to
    # An injected submission fault left part of the job unqueued; the job
    # must complete as failed even if every queued op succeeded.
    submit_failed: bool = False
    # The trace current at submission: the job's completion span joins it.
    traceparent: Optional[str] = None


@dataclass
class FileSpan:
    """One file's slice of a multi-block transfer.

    A file holds ``blocks_per_file`` logically-consecutive blocks in fixed
    slots; a span addresses the consecutive slots
    ``[head_offset, head_offset + len(blocks))`` of the file keyed by
    ``file_key``. ``blocks[i]`` is the page-id list of slot
    ``head_offset + i``.
    """

    file_key: int
    head_offset: int
    blocks: list


def map_blocks_to_file_spans(
    file_keys: Sequence[int],
    start_block_idx: int,
    blocks: Sequence[Sequence[int]],
    blocks_per_file: int,
) -> list[FileSpan]:
    """Split logically-consecutive blocks into per-file spans.

    Files are aligned at multiples of ``blocks_per_file`` in logical block
    space; a transfer may start AND/OR end mid-file (the reference's
    unaligned head/tail mapping, ``worker.py:187-255``). ``file_keys`` has
    one key per file the range [start_block_idx, +len(blocks)) intersects.
    """
    if not blocks:
        return []
    bpf = blocks_per_file
    end_block_idx = start_block_idx + len(blocks)
    start_file_idx = start_block_idx // bpf
    num_files = (end_block_idx - 1) // bpf + 1 - start_file_idx
    if len(file_keys) != num_files:
        raise ValueError(
            f"range [{start_block_idx}, {end_block_idx}) spans {num_files} "
            f"files of {bpf} blocks, got {len(file_keys)} keys"
        )
    spans = []
    consumed = 0
    for f_idx, key in enumerate(file_keys):
        file_lo = (start_file_idx + f_idx) * bpf
        slice_lo = max(start_block_idx, file_lo)
        slice_hi = min(end_block_idx, file_lo + bpf)
        spans.append(FileSpan(
            file_key=key,
            head_offset=slice_lo - file_lo,
            blocks=[list(b) for b in blocks[consumed:consumed + slice_hi - slice_lo]],
        ))
        consumed += slice_hi - slice_lo
    return spans



def check_span(span: FileSpan, blocks_per_file: int,
               pages_per_block: int) -> None:
    """Validate one span against the fixed file geometry (shared by the
    POSIX and object-store backends)."""
    if span.head_offset + len(span.blocks) > blocks_per_file:
        raise ValueError(
            f"span [{span.head_offset}, "
            f"{span.head_offset + len(span.blocks)}) exceeds "
            f"{blocks_per_file} slots")
    for b in span.blocks:
        if len(b) != pages_per_block:
            raise ValueError(
                f"block has {len(b)} pages, file layout expects "
                f"{pages_per_block}")


def validate_store_coverage(
    spans: Sequence[FileSpan], blocks_per_file: int, pages_per_block: int
) -> dict[int, list[FileSpan]]:
    """Group spans by file and enforce the durability rule: every touched
    file/object must be FULLY covered by its spans' union — lookup treats
    existence as "stored" and writes publish atomically, so a partially-
    provisioned file would serve holes as successful loads. Returns the
    per-file grouping."""
    by_file: dict[int, list[FileSpan]] = {}
    for span in spans:
        check_span(span, blocks_per_file, pages_per_block)
        by_file.setdefault(span.file_key, []).append(span)
    for file_key, file_spans in by_file.items():
        slots: list[int] = []
        for lo, hi in sorted((s.head_offset, s.head_offset + len(s.blocks))
                             for s in file_spans):
            slots.extend(range(lo, hi))
        if slots != list(range(blocks_per_file)):
            raise ValueError(
                f"store for file {file_key:#x} covers slots {slots}, "
                f"need all of 0..{blocks_per_file - 1} (files "
                "publish atomically; partial stores are not durable)")
    return by_file


def assemble_file_buffers(
    spans: Sequence[FileSpan], slabs: Sequence, expected_file_bytes: int
) -> dict[int, "np.ndarray"]:
    """Concatenate per-block slabs into one contiguous uint8 buffer per
    file, slots ordered by head offset. ``slabs`` aligns with the spans'
    flattened block lists (the gather output)."""
    file_parts: dict[int, list[tuple[int, list]]] = {}
    i = 0
    for span in spans:
        part = slabs[i:i + len(span.blocks)]
        i += len(span.blocks)
        file_parts.setdefault(span.file_key, []).append(
            (span.head_offset, part))
    out: dict[int, "np.ndarray"] = {}
    for file_key, parts in file_parts.items():
        flat = [
            np.ascontiguousarray(s).view(np.uint8).reshape(-1)
            for _off, ss in sorted(parts, key=lambda p: p[0])
            for s in ss
        ]
        buf = flat[0] if len(flat) == 1 else np.concatenate(flat)
        assert buf.nbytes == expected_file_bytes, (
            f"file {file_key:#x}: assembled {buf.nbytes} B, layout "
            f"expects {expected_file_bytes} B")
        out[file_key] = buf
    return out


class OffloadHandlers:
    """Bidirectional transfer engine for one worker (one device's caches)."""

    def __init__(
        self,
        copier: CUDABlockCopier,
        mapper: FileMapper,
        io_threads: int = 4,
        read_preferring_ratio: float = 0.75,
        max_write_queued_seconds: float = 10.0,
        numa_node: Optional[int] = None,
        staging_bytes: Optional[int] = None,
        direct_io: bool = False,
        blocks_per_file: int = 1,
        pages_per_block: int = 1,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.copier = copier
        # Copiers by cache group, as the worker addresses them: a hybrid
        # engine binds group 1 (its SWA pool) as copiers[1].
        self.copiers: dict[int, CUDABlockCopier] = {0: copier}
        self.mapper = mapper
        # Multi-block file geometry (reference spec.py:76-89): files hold
        # blocks_per_file consecutive blocks in fixed slots of
        # pages_per_block pages each.
        self.blocks_per_file = blocks_per_file
        self.pages_per_block = pages_per_block
        self.slot_bytes = copier.slab_nbytes(pages_per_block)
        self.file_bytes = self.slot_bytes * blocks_per_file
        # Recycled host destinations for load jobs (reference
        # _StagedBackend pool; see offload.staging), pinned for pools on
        # the card: a slot holds one file's payload.
        self.staging = HostStagingPool(
            slot_bytes=self.file_bytes, slots=pool_size_for(io_threads),
            pinned=copier.pinned_host_active)
        # Recycled destinations of payload + footer for stores (kvio only
        # reads them, so they are not pinned), returned when a job settles.
        self._store_buffers = HostStagingPool(
            slot_bytes=self.file_bytes + footer_size(blocks_per_file),
            slots=pool_size_for(io_threads))
        read_pref = max(1, int(io_threads * read_preferring_ratio))
        if staging_bytes is None:
            # Size each worker's pinned staging to one single-page slab,
            # floored at 1 MiB (the reference sizes per-thread staging to
            # the largest-group file, thread_pool.cpp:134-144; our files
            # hold one canonical block each).
            staging_bytes = max(copier.slab_nbytes(1), 1 << 20)
        self.io = NativeIOEngine(
            num_threads=io_threads,
            read_preferring_workers=read_pref,
            max_write_queued_seconds=max_write_queued_seconds,
            numa_node=(card_numa_node(copier.device) if numa_node is None
                       else numa_node),
            staging_bytes=staging_bytes,
            direct_io=direct_io,
        )
        self._pending: dict[int, _PendingJob] = {}
        self._lock = threading.Lock()
        # Integrity: when the mapper's format carries a CRC footer, stores
        # append it and loads verify it.
        self.integrity = getattr(mapper.cfg, "integrity", "none") == "crc32"
        # Transient I/O failures are retried with jittered backoff; the
        # default is deliberately short — offload is a cache, so a job that
        # keeps failing should fail fast and let the request path move on.
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=2, base_delay_s=0.05, max_delay_s=0.5
        )
        # Jobs awaiting resubmission: (due_monotonic, job). Flushed at the
        # top of get_finished; report_id maps to -1 while a job sits here.
        self._retry_q: list[tuple[float, _PendingJob]] = []
        self._by_report: dict[int, int] = {}

    def footer_bytes(self, num_slots: Optional[int] = None) -> int:
        """On-disk footer overhead per file (0 when integrity is off)."""
        if not self.integrity:
            return 0
        return footer_size(self.blocks_per_file if num_slots is None else num_slots)

    def _with_footer(self, payload: "np.ndarray", num_slots: int) -> "np.ndarray":
        """Append the CRC footer to a file payload (one host copy, into a
        recycled store buffer: release it with ``_release_buffers``).

        The native writer needs one contiguous buffer for the atomic
        tmp+rename write, so payload and footer go into one buffer; the
        ``offload.store.torn`` failpoint corrupts a payload byte *after*
        checksumming to stage a torn-write for load-time verification.
        """
        flat = payload.view(np.uint8).reshape(-1)
        slot = flat.nbytes // num_slots
        crcs = slot_crcs([flat[i * slot:(i + 1) * slot] for i in range(num_slots)])
        footer = np.frombuffer(build_footer(crcs), np.uint8)
        buf = self._store_buffers.acquire(flat.nbytes + footer.nbytes)
        buf[:flat.nbytes] = flat
        buf[flat.nbytes:] = footer
        if failpoints.should_fire(FP_STORE_TORN):
            buf[flat.nbytes // 2] ^= 0xFF
            logger.warning("failpoint %s tore a store payload", FP_STORE_TORN)
        return buf

    # -- store path --

    def async_store_blocks(
        self,
        transfers: Sequence[tuple[int, Sequence[int]]],  # (block_hash, page_ids)
        group_idx: int = 0,
    ) -> int:
        """Start an async store job; returns the job id.

        Each (block_hash, page_ids) pair becomes one content-addressed
        file. The device-side gather + D2H happens here (synchronous with
        respect to the device stream, overlapped across files); file writes
        are queued on the native pool.
        """
        copier = self.copiers[group_idx]
        job_id = self.io.begin_job()
        job = _PendingJob(job_id=job_id, report_id=job_id, is_store=True,
                          started=time.perf_counter(), nbytes=0,
                          group_idx=group_idx,
                          traceparent=current_traceparent())
        suffix = uuid.uuid4().hex[:8]
        # One device program + one D2H transfer for the whole job.
        slabs = copier.gather_many_to_host(
            [list(page_ids) for _, page_ids in transfers]
        )
        for (block_hash, _page_ids), slab in zip(transfers, slabs):
            # Block-mode files hold exactly one block: one checksum slot.
            buf = self._with_footer(slab, 1) if self.integrity else slab
            try:
                queued = self.io.submit_write(
                    job_id,
                    self.mapper.block_path(block_hash, group_idx),
                    self.mapper.tmp_path(block_hash, group_idx, unique_suffix=suffix),
                    buf,
                )
            except FaultInjected:
                job.submit_failed = True
                job.store_units.append(_StoreUnit(key=block_hash, buf=buf))
                continue
            if queued:
                job.buffers.append(buf)
                job.store_units.append(_StoreUnit(key=block_hash, buf=buf))
                job.nbytes += slab.nbytes
            else:
                job.shed_hashes.append(block_hash)
                self._store_buffers.release(buf)
        self.io.seal_job(job_id)
        self._register(job)
        return job_id

    # -- load path --

    def async_load_blocks(
        self,
        transfers: Sequence[tuple[int, Sequence[int]]],
        group_idx: int = 0,
    ) -> int:
        """Start an async load job; returns the job id.

        File reads land in host buffers on the native pool (high
        priority); the H2D scatter happens when the caller polls
        ``get_finished`` and the job is complete.
        """
        copier = self.copiers[group_idx]
        job_id = self.io.begin_job()
        job = _PendingJob(job_id=job_id, report_id=job_id, is_store=False,
                          started=time.perf_counter(), nbytes=0,
                          group_idx=group_idx,
                          traceparent=current_traceparent())
        for block_hash, page_ids in transfers:
            buf = self.staging.acquire(copier.slab_nbytes(len(page_ids)))
            footer = np.empty(footer_size(1), np.uint8) if self.integrity else None
            unit = _LoadUnit(key=block_hash, payload=buf, footer=footer,
                             slot_lo=0, covered=1, num_slots=1,
                             scatters=[(buf, list(page_ids))])
            job.buffers.append(buf)
            job.load_units.append(unit)
            job.nbytes += buf.nbytes
            self._submit_load_unit(job, unit, group_idx)
        self.io.seal_job(job_id)
        self._register(job)
        return job_id

    def _submit_load_unit(self, job: _PendingJob, unit: _LoadUnit,
                          group_idx: int) -> None:
        """Queue one file's payload (+footer) reads on the current job."""
        path = self.mapper.block_path(unit.key, group_idx)
        slot_bytes = unit.payload.nbytes // unit.covered
        try:
            self.io.submit_read(
                job.job_id, path, unit.payload,
                offset=unit.slot_lo * slot_bytes,
            )
            if unit.footer is not None:
                self.io.submit_read(
                    job.job_id, path, unit.footer,
                    offset=unit.num_slots * slot_bytes,
                )
        except FaultInjected:
            job.submit_failed = True

    # -- multi-block file spans (unaligned head/tail) --

    def _check_span(self, span: FileSpan) -> None:
        check_span(span, self.blocks_per_file, self.pages_per_block)

    def async_store_spans(self, spans: Sequence[FileSpan],
                          group_idx: int = 0) -> int:
        """Store multi-block file spans; returns the job id.

        Every touched file must be FULLY covered (spans for one file may be
        split, but their union must be all ``blocks_per_file`` slots):
        lookup treats file existence as "stored", so a file must only ever
        appear atomically (tmp+rename) with every slot written — a
        partially-provisioned file would serve zeros for its holes as
        successful loads. Partial writes stay a load-side concept (head
        offsets); this mirrors the reference, where a file is one offload
        block and only complete offload blocks are stored.
        """
        validate_store_coverage(spans, self.blocks_per_file,
                                self.pages_per_block)

        copier = self.copiers[group_idx]
        file_bytes = copier.slab_nbytes(self.pages_per_block) * self.blocks_per_file
        job_id = self.io.begin_job()
        job = _PendingJob(job_id=job_id, report_id=job_id, is_store=True,
                          started=time.perf_counter(), nbytes=0,
                          group_idx=group_idx,
                          traceparent=current_traceparent())
        suffix = uuid.uuid4().hex[:8]
        # One device program per job: per-block gathers keep slots
        # independently addressable in the file (a fused multi-block gather
        # would interleave blocks by layer).
        all_slabs = copier.gather_many_to_host(
            [list(b) for span in spans for b in span.blocks]
        )
        for file_key, payload in assemble_file_buffers(
                spans, all_slabs, file_bytes).items():
            # Span-mode files checksum per slot so partial (head-offset)
            # loads can verify just the slots they read.
            buf = (self._with_footer(payload, self.blocks_per_file)
                   if self.integrity else payload)
            try:
                queued = self.io.submit_write(
                    job_id,
                    self.mapper.block_path(file_key, group_idx),
                    self.mapper.tmp_path(file_key, group_idx, unique_suffix=suffix),
                    buf,
                )
            except FaultInjected:
                job.submit_failed = True
                job.store_units.append(_StoreUnit(key=file_key, buf=buf))
                continue
            if queued:
                job.buffers.append(buf)
                job.store_units.append(_StoreUnit(key=file_key, buf=buf))
                job.nbytes += payload.nbytes
            else:
                job.shed_hashes.append(file_key)
                self._store_buffers.release(buf)
        self.io.seal_job(job_id)
        self._register(job)
        return job_id

    def async_load_spans(self, spans: Sequence[FileSpan],
                         group_idx: int = 0) -> int:
        """Load multi-block file spans (partial-file reads start at the
        span's head-offset byte); returns the job id."""
        for span in spans:
            self._check_span(span)
        copier = self.copiers[group_idx]
        slot_bytes = copier.slab_nbytes(self.pages_per_block)
        job_id = self.io.begin_job()
        job = _PendingJob(job_id=job_id, report_id=job_id, is_store=False,
                          started=time.perf_counter(), nbytes=0,
                          group_idx=group_idx,
                          traceparent=current_traceparent())
        for span in spans:
            buf = self.staging.acquire(len(span.blocks) * slot_bytes)
            footer = (np.empty(footer_size(self.blocks_per_file), np.uint8)
                      if self.integrity else None)
            unit = _LoadUnit(
                key=span.file_key, payload=buf, footer=footer,
                slot_lo=span.head_offset, covered=len(span.blocks),
                num_slots=self.blocks_per_file,
                scatters=[
                    (buf[k * slot_bytes:(k + 1) * slot_bytes], list(page_ids))
                    for k, page_ids in enumerate(span.blocks)
                ],
            )
            job.buffers.append(buf)
            job.load_units.append(unit)
            job.nbytes += buf.nbytes
            self._submit_load_unit(job, unit, group_idx)
        self.io.seal_job(job_id)
        self._register(job)
        return job_id

    # -- completion --

    def _register(self, job: _PendingJob) -> None:
        with self._lock:
            self._pending[job.job_id] = job
            self._by_report[job.report_id] = job.job_id

    def _quarantine(self, key: int, group_idx: int) -> None:
        """Move a checksum-failed file out of the content-addressed
        namespace so lookups stop advertising it; the evictor reclaims
        ``*.quarantine`` files on its age sweep."""
        path = self.mapper.block_path(key, group_idx)
        try:
            os.replace(path, path + QUARANTINE_SUFFIX)
            logger.error("quarantined corrupt offload file %s", path)
        except OSError as e:
            logger.warning("could not quarantine %s: %s", path, e)

    def _verify_load(self, job: _PendingJob) -> list[int]:
        """Checksum every read unit; quarantine and report corrupt files."""
        corrupt: list[int] = []
        for unit in job.load_units:
            if unit.footer is None:
                continue
            flat = unit.payload.view(np.uint8).reshape(-1)
            slot = flat.nbytes // unit.covered
            try:
                crcs = parse_footer(bytes(unit.footer), unit.num_slots)
                got = slot_crcs(
                    [flat[i * slot:(i + 1) * slot] for i in range(unit.covered)]
                )
                for i, crc in enumerate(got):
                    if crc != crcs[unit.slot_lo + i]:
                        raise IntegrityError(
                            f"slot {unit.slot_lo + i} crc mismatch: "
                            f"footer={crcs[unit.slot_lo + i]:#010x} data={crc:#010x}"
                        )
            except IntegrityError as e:
                logger.error("load of %#x failed verification: %s", unit.key, e)
                self._quarantine(unit.key, job.group_idx)
                corrupt.append(unit.key)
        return corrupt

    def _schedule_retry(self, job: _PendingJob) -> None:
        delay = self.retry_policy.delay(job.attempt - 1)
        flight_recorder().record(
            KIND_RETRY,
            {
                "subsystem": "offload",
                "job_id": job.report_id,
                "direction": "store" if job.is_store else "load",
                "attempt": job.attempt,
                "delay_s": delay,
            },
        )
        logger.warning(
            "job %d (%s) attempt %d failed; retrying in %.3fs",
            job.report_id, "store" if job.is_store else "load",
            job.attempt, delay,
        )
        with self._lock:
            self._retry_q.append((time.monotonic() + delay, job))
            self._by_report[job.report_id] = -1

    def _resubmit(self, job: _PendingJob) -> None:
        job.attempt += 1
        job.submit_failed = False
        job.job_id = self.io.begin_job()
        if job.is_store:
            suffix = uuid.uuid4().hex[:8]
            kept = []
            for unit in job.store_units:
                try:
                    queued = self.io.submit_write(
                        job.job_id,
                        self.mapper.block_path(unit.key, job.group_idx),
                        self.mapper.tmp_path(unit.key, job.group_idx,
                                             unique_suffix=suffix),
                        unit.buf,
                    )
                except FaultInjected:
                    job.submit_failed = True
                    kept.append(unit)
                    continue
                if queued:
                    kept.append(unit)
                else:
                    job.shed_hashes.append(unit.key)
                    self._store_buffers.release(unit.buf)
            job.store_units = kept
        else:
            for unit in job.load_units:
                self._submit_load_unit(job, unit, job.group_idx)
        self.io.seal_job(job.job_id)
        self._register(job)

    def _flush_retries(self) -> None:
        now = time.monotonic()
        with self._lock:
            due = [j for t, j in self._retry_q if t <= now]
            self._retry_q = [(t, j) for t, j in self._retry_q if t > now]
        for job in due:
            self._resubmit(job)

    def _release_job_buffers(self, job: _PendingJob) -> None:
        if job.is_store:
            self._release_buffers(job.buffers + [u.buf for u in job.store_units])
        else:
            self._release_buffers(job.buffers)

    def _release_buffers(self, bufs) -> None:
        """Return staging or store buffers to their pool (a no-op for any
        other buffer, and for one already returned)."""
        for buf in bufs:
            self.staging.release(buf)
            self._store_buffers.release(buf)

    def get_finished(self) -> list[TransferResult]:
        """Poll completed jobs; verify + apply load scatters; retry or
        report; release buffers."""
        self._flush_retries()
        results = []
        for job_id, status in self.io.poll_finished():
            with self._lock:
                job = self._pending.pop(job_id, None)
            if job is None:
                continue
            if status == STATUS_OK:
                fp = FP_STORE_IO_ERROR if job.is_store else FP_LOAD_IO_ERROR
                if job.submit_failed or failpoints.should_fire(fp):
                    status = STATUS_IO_ERROR
            success = status == STATUS_OK
            corrupt: list[int] = []
            if success and not job.is_store:
                corrupt = self._verify_load(job)
                success = not corrupt
            if success and not job.is_store:
                # The payload's words reinterpret as the pool's dtype in
                # the copier (numpy has no bf16 here).
                copier = self.copiers[job.group_idx]
                copier.scatter_many_from_host([
                    (
                        np.frombuffer(buf, dtype=copier.dtype).reshape(
                            copier.slab_shape(len(page_ids))
                        ),
                        page_ids,
                    )
                    for unit in job.load_units
                    for buf, page_ids in unit.scatters
                ])
            elif not success:
                logger.warning(
                    "%s job %d failed (status %d, attempt %d)",
                    "store" if job.is_store else "load",
                    job.report_id, status, job.attempt,
                )
            # Transient failures (IO error, injected fault) retry under the
            # policy; checksum corruption is deterministic and cancellation
            # is intentional — neither is worth a second attempt.
            if (not success and not corrupt and status == STATUS_IO_ERROR
                    and job.attempt < self.retry_policy.max_attempts):
                self._schedule_retry(job)
                continue
            # The writes have read, or the scatter (or abandonment) has
            # consumed, the host buffers: recycle them.
            self._release_job_buffers(job)
            with self._lock:
                self._by_report.pop(job.report_id, None)
            result = TransferResult(
                job_id=job.report_id,
                success=success,
                is_store=job.is_store,
                bytes_transferred=job.nbytes if success else 0,
                seconds=time.perf_counter() - job.started,
                shed_hashes=job.shed_hashes,
                corrupt_hashes=corrupt,
                attempts=job.attempt,
            )
            # Completion marker span joining the submitter's trace, plus a
            # flight record: "why did this block come back cold?" is
            # answerable after the fact from either surface.
            direction = "store" if job.is_store else "load"
            with tracer().span(
                "llm_d.kv_cache.offload.job",
                parent_traceparent=job.traceparent,
                direction=direction,
                job_id=job.report_id,
                success=success,
                attempts=job.attempt,
                bytes=result.bytes_transferred,
                seconds=result.seconds,
            ):
                pass
            flight_recorder().record(
                KIND_OFFLOAD,
                {
                    "job_id": job.report_id,
                    "direction": direction,
                    "success": success,
                    "bytes": result.bytes_transferred,
                    "seconds": result.seconds,
                    "attempts": job.attempt,
                    "shed": len(job.shed_hashes),
                    "corrupt": len(corrupt),
                },
            )
            results.append(result)
        return results

    def wait_job(self, job_id: int, timeout_s: float = 30.0) -> int:
        """Cancel-and-wait for preemption (request aborted mid-transfer).

        ``job_id`` is the id the submit call returned; retries run under
        fresh native ids, so resolve through the report map first.
        """
        with self._lock:
            native_id = self._by_report.get(job_id, job_id)
            if native_id == -1:
                # Parked in the retry queue: nothing in flight natively —
                # drop the pending retry and release its buffers.
                job = None
                for i, (_t, j) in enumerate(self._retry_q):
                    if j.report_id == job_id:
                        job = j
                        del self._retry_q[i]
                        break
                self._by_report.pop(job_id, None)
                if job is not None:
                    self._release_job_buffers(job)
                return STATUS_CANCELLED
        status = self.io.wait_job(native_id, timeout_s)
        if status != STATUS_PENDING:
            # Only release the host buffers once the native side has truly
            # drained: a timed-out job may still have an in-flight read
            # holding raw pointers into them.
            with self._lock:
                job = self._pending.pop(native_id, None)
                self._by_report.pop(job_id, None)
            if job is not None:
                self._release_job_buffers(job)
        else:
            logger.warning(
                "job %d still in flight after cancel timeout; parking buffers",
                job_id,
            )
        return status

    def flush(self, deadline_s: float = 10.0) -> bool:
        """Pump completions until no jobs are pending or queued for retry,
        or ``deadline_s`` elapses (graceful drain).

        Completed results reach their engine reports (and store checksums
        land on disk) instead of being abandoned by shutdown. Returns True
        when fully flushed inside the budget.
        """
        t_end = time.monotonic() + deadline_s
        while True:
            self.get_finished()
            with self._lock:
                idle = not self._pending and not self._retry_q
            if idle:
                return True
            if time.monotonic() >= t_end:
                with self._lock:
                    pending = len(self._pending)
                    queued = len(self._retry_q)
                logger.warning(
                    "offload flush deadline: %d in flight, %d retry-queued "
                    "abandoned", pending, queued,
                )
                return False
            time.sleep(0.005)

    def shutdown(self) -> None:
        self.io.close()
