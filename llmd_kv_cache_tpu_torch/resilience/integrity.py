"""Per-slot CRC32 footer for offload block files.

Copy of ``llmd_kv_cache_tpu/resilience/integrity.py``: the file bytes of
both packages depend on it, so it stays byte for byte the same format.

Layout (little-endian), appended after the raw KV payload:

    +----------------+--------------------------+
    | payload        | slot 0 | slot 1 | ...    |   <- existing format
    +----------------+--------------------------+
    | u32 crc32 per slot  (4 * num_slots bytes) |
    | magic "KVCK" | u16 version | u16 slots    |   <- 8-byte trailer
    +-------------------------------------------+

A *slot* is one contiguous cache-slice write (one layer's K or V run
for the block), matching the units ``assemble_file_buffers`` emits, so
a torn write is localised to the slot granularity.  The trailer lives
at the very end of the file so a reader only needs the file tail plus
the slot count it already knows from the mapper geometry.

The footer is covered by the offload fingerprint (``integrity`` field
of ``FileMapperConfig``), so files with and without footers never share
a directory.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

FOOTER_MAGIC = b"KVCK"
FOOTER_VERSION = 1
_TRAILER = struct.Struct("<4sHH")  # magic, version, slot count


class IntegrityError(Exception):
    """Checksum footer missing, malformed, or mismatched."""


def footer_size(num_slots: int) -> int:
    return 4 * num_slots + _TRAILER.size


def slot_crcs(buffers: Sequence) -> list[int]:
    """CRC32 of each slot buffer (accepts anything memoryview-able)."""
    return [zlib.crc32(memoryview(b).cast("B")) & 0xFFFFFFFF for b in buffers]


def build_footer(crcs: Sequence[int]) -> bytes:
    body = struct.pack(f"<{len(crcs)}I", *crcs)
    return body + _TRAILER.pack(FOOTER_MAGIC, FOOTER_VERSION, len(crcs))


def parse_footer(footer: bytes, expected_slots: int) -> list[int]:
    """Decode a footer blob; raise :class:`IntegrityError` on any defect."""
    if len(footer) != footer_size(expected_slots):
        raise IntegrityError(
            f"footer is {len(footer)} bytes, expected {footer_size(expected_slots)}"
        )
    magic, version, slots = _TRAILER.unpack_from(footer, 4 * expected_slots)
    if magic != FOOTER_MAGIC:
        raise IntegrityError(f"bad footer magic {magic!r}")
    if version != FOOTER_VERSION:
        raise IntegrityError(f"unsupported footer version {version}")
    if slots != expected_slots:
        raise IntegrityError(f"footer has {slots} slot(s), expected {expected_slots}")
    return list(struct.unpack_from(f"<{expected_slots}I", footer, 0))


def verify_slots(buffers: Sequence, footer: bytes) -> None:
    """Check every slot buffer against the footer; raise on first mismatch."""
    expected = parse_footer(footer, len(buffers))
    actual = slot_crcs(buffers)
    for i, (want, got) in enumerate(zip(expected, actual)):
        if want != got:
            raise IntegrityError(
                f"slot {i} crc mismatch: footer={want:#010x} data={got:#010x}"
            )
