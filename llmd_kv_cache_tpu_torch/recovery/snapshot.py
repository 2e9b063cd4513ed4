"""Versioned, checksummed index snapshots.

On-disk format of one ``index-<seq>.snap`` file::

    +--------------------+----------------------+------------------+
    | magic "KVTPUSNAP1\\n" | canonical CBOR doc  | CRC footer (1    |
    | (11 bytes)          | (the snapshot body)  | slot, integrity) |
    +--------------------+----------------------+------------------+

The CRC footer is the offload layer's checksum trailer
(``resilience/integrity.py``) with a single slot covering the CBOR body,
so snapshot verification shares code — and failure semantics — with
offload-file verification. Files are published durably
(``utils.atomic_io``: tmp + fsync + rename + dirsync) and named by a
monotonically increasing sequence so "newest" is unambiguous even when
mtimes are not.

A snapshot that fails verification (bad magic, CRC mismatch, CBOR decode
error, truncation) is *quarantined* — renamed to ``*.quarantine`` so it
stops being a load candidate but stays on disk for post-mortems — and
the next-newest snapshot is tried (docs/resilience.md runbook).

Port of ``llmd_kv_cache_tpu/recovery/snapshot.py``: the same document
writes the same bytes in both packages, and each reads the other's files.
"""

from __future__ import annotations

import os
import re
import time
import zlib
from typing import Optional

from ..metrics.collector import record_snapshot, record_snapshot_quarantine
from ..resilience.integrity import (
    IntegrityError,
    build_footer,
    footer_size,
    parse_footer,
)
from ..telemetry import flight_recorder, tracer
from ..telemetry.flight_recorder import KIND_RECOVERY
from ..utils.atomic_io import atomic_write_bytes
from ..utils.cbor import CBORDecodeError, canonical_cbor_decode, canonical_cbor_encode
from ..utils.logging import get_logger

logger = get_logger("recovery.snapshot")

SNAPSHOT_MAGIC = b"KVTPUSNAP1\n"
SNAPSHOT_VERSION = 1
QUARANTINE_SUFFIX = ".quarantine"

_NAME_RE = re.compile(r"^index-(\d{8})\.snap$")


class SnapshotError(Exception):
    """Snapshot file malformed or failed verification."""


def encode_snapshot(doc: dict) -> bytes:
    """Serialize a snapshot document to the on-disk byte format."""
    body = canonical_cbor_encode(doc)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return SNAPSHOT_MAGIC + body + build_footer([crc])


def decode_snapshot(blob: bytes) -> dict:
    """Parse + verify one snapshot blob; raise :class:`SnapshotError`."""
    if not blob.startswith(SNAPSHOT_MAGIC):
        raise SnapshotError("bad magic (not a snapshot, or truncated head)")
    tail = footer_size(1)
    if len(blob) < len(SNAPSHOT_MAGIC) + tail:
        raise SnapshotError("truncated snapshot (shorter than magic + footer)")
    body = blob[len(SNAPSHOT_MAGIC):-tail]
    try:
        (want,) = parse_footer(blob[-tail:], 1)
    except IntegrityError as e:
        raise SnapshotError(f"bad checksum footer: {e}") from e
    got = zlib.crc32(body) & 0xFFFFFFFF
    if got != want:
        raise SnapshotError(f"body crc mismatch: footer={want:#010x} data={got:#010x}")
    try:
        doc = canonical_cbor_decode(body)
    except CBORDecodeError as e:
        raise SnapshotError(f"undecodable snapshot body: {e}") from e
    if not isinstance(doc, dict):
        raise SnapshotError(f"snapshot body is {type(doc).__name__}, expected map")
    return doc


class SnapshotStore:
    """Directory of versioned snapshots with keep-N retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = max(1, keep)
        self.quarantined = 0
        os.makedirs(directory, exist_ok=True)

    def _sequences(self) -> list[tuple[int, str]]:
        """(seq, filename) of every valid-named snapshot, newest first."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            m = _NAME_RE.match(name)
            if m:
                out.append((int(m.group(1)), name))
        out.sort(reverse=True)
        return out

    def save(self, doc: dict) -> str:
        """Durably write ``doc`` as the next snapshot; returns its path."""
        start = time.perf_counter()
        existing = self._sequences()
        seq = (existing[0][0] + 1) if existing else 1
        path = os.path.join(self.directory, f"index-{seq:08d}.snap")
        blob = encode_snapshot(doc)
        with tracer().span(
            "llm_d.kv_cache.recovery.snapshot.save", seq=seq, bytes=len(blob)
        ):
            atomic_write_bytes(path, blob)
        self.prune()
        seconds = time.perf_counter() - start
        record_snapshot("written", len(blob), seconds)
        flight_recorder().record(
            KIND_RECOVERY,
            {"op": "snapshot", "seq": seq, "bytes": len(blob), "seconds": seconds},
        )
        logger.info("wrote snapshot %s (%d bytes, %.3fs)", path, len(blob), seconds)
        return path

    def quarantine(self, path: str, reason: str) -> None:
        """Rename a corrupt snapshot out of the load path, keep for triage."""
        self.quarantined += 1
        try:
            os.replace(path, path + QUARANTINE_SUFFIX)
            logger.error("quarantined corrupt snapshot %s: %s", path, reason)
        except OSError as e:
            logger.warning("could not quarantine %s: %s", path, e)
        record_snapshot_quarantine()
        flight_recorder().record(
            KIND_RECOVERY, {"op": "quarantine", "path": path, "reason": reason}
        )

    def load_newest(self) -> Optional[tuple[dict, str]]:
        """Load the newest snapshot that verifies; quarantine ones that
        don't. Returns ``(doc, path)`` or ``None`` when nothing loads."""
        for _seq, name in self._sequences():
            path = os.path.join(self.directory, name)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
                return decode_snapshot(blob), path
            except OSError as e:
                logger.warning("could not read snapshot %s: %s", path, e)
            except SnapshotError as e:
                self.quarantine(path, str(e))
        return None

    def prune(self) -> None:
        """Delete all but the newest ``keep`` snapshots."""
        for _seq, name in self._sequences()[self.keep:]:
            path = os.path.join(self.directory, name)
            try:
                os.unlink(path)
            except OSError as e:  # pragma: no cover - racing cleanup
                logger.debug("prune of %s failed: %s", path, e)
