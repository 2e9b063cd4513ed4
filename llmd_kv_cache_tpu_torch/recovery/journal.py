"""Append-only, checksummed per-pod event-sequence journal.

The journal sits between snapshots: every raw event message the pool
parses is appended here, and a warm restart replays the records whose
per-pod sequence is newer than the snapshot's ``pod_seqs`` watermark.
Snapshot + journal-suffix therefore reconstructs the index to within the
ZMQ messages lost while the process was down (which anti-entropy then
repairs).

Record framing (all little-endian)::

    +-----------+-----------+------------------------------+
    | u32 length| u32 crc32 | canonical CBOR               |
    | (of body) | (of body) | [pod_id, seq, topic, payload,|
    |           |           |  event_ts]                   |
    +-----------+-----------+------------------------------+

Appends are flushed per record and fsync'd every ``sync_every`` records,
so a crash loses at most ``sync_every`` events past the last sync — and
those are exactly what anti-entropy exists for. A torn tail (partial
record from a crash mid-append) is tolerated: replay stops at the first
record that fails length/CRC/decode checks, logging how many bytes were
abandoned.

Rotation (``rotate()``) happens after each successful snapshot: the
snapshot's watermark supersedes the journal prefix, so the file restarts
empty (published atomically, never truncated in place).

Port of ``llmd_kv_cache_tpu/recovery/journal.py``: the same records
write the same bytes in both packages, and each replays the other's
journal, stopping at the same torn tail.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional

from ..utils.lockdep import new_lock
from ..utils.atomic_io import atomic_write_bytes, fsync_dir
from ..utils.cbor import CBORDecodeError, canonical_cbor_decode, canonical_cbor_encode
from ..utils.logging import get_logger

logger = get_logger("recovery.journal")

_HEADER = struct.Struct("<II")  # body length, body crc32


class JournalRecord:
    """One replayable event message."""

    __slots__ = ("pod_id", "sequence", "topic", "payload", "event_ts")

    def __init__(self, pod_id: str, sequence: int, topic: str, payload: bytes,
                 event_ts: float):
        self.pod_id = pod_id
        self.sequence = sequence
        self.topic = topic
        self.payload = payload
        self.event_ts = event_ts


class EventJournal:
    """Crash-tolerant append log of raw event messages."""

    def __init__(self, path: str, sync_every: int = 64):
        self.path = path
        self.sync_every = max(1, sync_every)
        self._mu = new_lock()
        self._f = None
        self._since_sync = 0
        self.appended = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _file(self):
        if self._f is None:
            self._f = open(self.path, "ab")
        return self._f

    def append(self, pod_id: str, sequence: int, topic: str, payload: bytes,
               event_ts: float) -> None:
        """Append one record (thread-safe); flushes every call, fsyncs
        every ``sync_every`` records."""
        body = canonical_cbor_encode(
            [pod_id, sequence, topic, bytes(payload), float(event_ts)]
        )
        rec = _HEADER.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF) + body
        with self._mu:
            f = self._file()
            f.write(rec)
            f.flush()
            self.appended += 1
            self._since_sync += 1
            if self._since_sync >= self.sync_every:
                os.fsync(f.fileno())  # lint: allow-blocking (durability point: _since_sync must match on-disk state, so fsync stays under _mu; bounded by sync_every)
                self._since_sync = 0

    def sync(self) -> None:
        """Force an fsync of any unsynced appends."""
        with self._mu:
            if self._f is not None and self._since_sync:
                self._f.flush()
                os.fsync(self._f.fileno())  # lint: allow-blocking (explicit durability barrier; callers opt into the wait)
                self._since_sync = 0

    def rotate(self) -> None:
        """Restart the journal empty (after a snapshot superseded it).

        The empty file is published atomically so a crash mid-rotate
        leaves either the old journal (extra idempotent replays) or the
        new empty one — never a half-truncated file.
        """
        with self._mu:
            if self._f is not None:
                self._f.close()
                self._f = None
            atomic_write_bytes(self.path, b"")
            self._since_sync = 0

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                if self._since_sync:
                    self._f.flush()
                    os.fsync(self._f.fileno())  # lint: allow-blocking (final durability barrier on close; no concurrent appends after this)
                    self._since_sync = 0
                self._f.close()
                self._f = None
            fsync_dir(os.path.dirname(self.path) or ".")

    def replay(self, min_seqs: Optional[dict] = None) -> Iterator[JournalRecord]:
        """Yield records with ``sequence > min_seqs[pod_id]`` (all pods
        absent from ``min_seqs`` replay in full). Stops cleanly at a torn
        tail."""
        min_seqs = min_seqs or {}
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        pos = 0
        while pos + _HEADER.size <= len(data):
            length, want_crc = _HEADER.unpack_from(data, pos)
            body_start = pos + _HEADER.size
            body_end = body_start + length
            if body_end > len(data):
                logger.warning(
                    "journal %s: torn tail at offset %d (%d bytes abandoned)",
                    self.path, pos, len(data) - pos,
                )
                return
            body = data[body_start:body_end]
            if (zlib.crc32(body) & 0xFFFFFFFF) != want_crc:
                logger.warning(
                    "journal %s: crc mismatch at offset %d; stopping replay "
                    "(%d bytes abandoned)", self.path, pos, len(data) - pos,
                )
                return
            try:
                item = canonical_cbor_decode(body)
                pod_id, sequence, topic, payload, event_ts = item
            except (CBORDecodeError, ValueError, TypeError):
                logger.warning(
                    "journal %s: undecodable record at offset %d; stopping",
                    self.path, pos,
                )
                return
            pos = body_end
            if sequence > min_seqs.get(pod_id, -1):
                yield JournalRecord(pod_id, sequence, topic, payload, event_ts)
