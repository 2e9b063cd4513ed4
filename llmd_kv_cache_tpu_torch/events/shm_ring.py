"""Same-host shared-memory event ring (docs/architecture.md
"Native data plane").

Copy of ``llmd_kv_cache_tpu/events/shm_ring.py``: the file format, cursors
and skip marker are the same, so a ring written by one package reads in
the other.

An engine colocated with its indexer shard pays ZMQ serialize → kernel →
deserialize for every event batch even though both ends share RAM. This
ring is the opt-in bypass: a file-backed mmap (``/dev/shm`` when the
host has one) carrying length-prefixed records — normally packed
:mod:`.packed` frames — from one writer to one reader with no sockets
and no copies beyond the single ``memcpy`` into the ring.

Design constraints, deliberately minimal:

- **SPSC only.** One producer, one consumer. The header keeps two u64
  cursors (absolute byte offsets, monotonically increasing); the writer
  only advances ``write_pos``, the reader only advances ``read_pos``.
  On x86/ARM64 an aligned 8-byte store is atomic, and CPython's memory
  model adds no reordering the GIL doesn't already forbid — but there is
  NO cross-process fence beyond that, which is exactly the caveat: use
  one writer process and one reader process, period.
- **Records never wrap.** A record that doesn't fit before the ring's
  end writes a skip marker (length ``0xFFFFFFFF``) and restarts at
  offset 0, so a reader always sees each record contiguous — that is
  what lets the pool hand ``np.frombuffer`` views straight into the
  index without reassembly.
- **Full ring = drop at the writer.** ``write`` returns False instead
  of blocking; the event stream is soft state and anti-entropy repairs
  holes, same policy as the pool's drop-oldest queues.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Optional

MAGIC = b"KSHM"
VERSION = 1
HEADER_SIZE = 64
_HDR = struct.Struct("<4sIQ")  # magic, version, capacity
_U64 = struct.Struct("<Q")
_LEN = struct.Struct("<I")
_SKIP = 0xFFFFFFFF
_WRITE_POS_OFF = 16
_READ_POS_OFF = 24


def default_ring_dir() -> str:
    """``/dev/shm`` when the host mounts one (RAM-backed, the point of
    the exercise), else the system temp dir — still correct, just paged."""
    return "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"


class ShmRing:
    """One file-backed SPSC ring. ``create=True`` (writer side) sizes and
    initializes the file; the reader attaches to an existing one."""

    def __init__(self, path: str, capacity: int = 1 << 20,
                 create: bool = False):
        self.path = path
        if create:
            capacity = max(4096, int(capacity))
            with open(path, "wb") as f:
                f.truncate(HEADER_SIZE + capacity)
            self._file = open(path, "r+b")
            self._mm = mmap.mmap(self._file.fileno(),
                                 HEADER_SIZE + capacity)
            self._mm[:_HDR.size] = _HDR.pack(MAGIC, VERSION, capacity)
            self._set_u64(_WRITE_POS_OFF, 0)
            self._set_u64(_READ_POS_OFF, 0)
            self.capacity = capacity
        else:
            self._file = open(path, "r+b")
            self._mm = mmap.mmap(self._file.fileno(), 0)
            magic, version, cap = _HDR.unpack_from(self._mm, 0)
            if magic != MAGIC or version != VERSION:
                self._mm.close()
                self._file.close()
                raise ValueError(
                    f"{path} is not a v{VERSION} shm event ring"
                )
            self.capacity = int(cap)

    # -- cursor helpers ---------------------------------------------------

    def _get_u64(self, off: int) -> int:
        return _U64.unpack_from(self._mm, off)[0]

    def _set_u64(self, off: int, value: int) -> None:
        _U64.pack_into(self._mm, off, value)

    @property
    def write_pos(self) -> int:
        return self._get_u64(_WRITE_POS_OFF)

    @property
    def read_pos(self) -> int:
        return self._get_u64(_READ_POS_OFF)

    def __len__(self) -> int:
        """Unread bytes (records + framing) currently in the ring."""
        return self.write_pos - self.read_pos

    # -- writer side ------------------------------------------------------

    def write(self, record: bytes) -> bool:
        """Append one record; False when the ring lacks room (caller
        drops or falls back to the socket wire — never blocks)."""
        need = _LEN.size + len(record)
        if need > self.capacity - _LEN.size:
            return False  # can never fit, even empty
        wpos = self.write_pos
        rpos = self.read_pos
        woff = wpos % self.capacity
        # Keep records contiguous: pad to the ring start when the record
        # would straddle the end. The pad consumes ring space too.
        pad = 0
        if woff + need > self.capacity:
            pad = self.capacity - woff
        if wpos + pad + need - rpos > self.capacity:
            return False  # reader hasn't caught up
        if pad:
            if pad >= _LEN.size:
                _LEN.pack_into(self._mm, HEADER_SIZE + woff, _SKIP)
            wpos += pad
            woff = 0
        base = HEADER_SIZE + woff
        _LEN.pack_into(self._mm, base, len(record))
        self._mm[base + _LEN.size:base + need] = record
        # Publish after the payload is in place: the reader gates on
        # write_pos, so a torn record is never visible.
        self._set_u64(_WRITE_POS_OFF, wpos + need)
        return True

    # -- reader side ------------------------------------------------------

    def read(self) -> Optional[bytes]:
        """Pop one record, or None when the ring is empty. Returns a
        copy (``bytes``) so the slot can be reused immediately."""
        while True:
            rpos = self.read_pos
            if rpos >= self.write_pos:
                return None
            roff = rpos % self.capacity
            base = HEADER_SIZE + roff
            remaining = self.capacity - roff
            if remaining < _LEN.size:
                self._set_u64(_READ_POS_OFF, rpos + remaining)
                continue
            (length,) = _LEN.unpack_from(self._mm, base)
            if length == _SKIP:
                self._set_u64(_READ_POS_OFF, rpos + remaining)
                continue
            record = bytes(
                self._mm[base + _LEN.size:base + _LEN.size + length]
            )
            self._set_u64(_READ_POS_OFF, rpos + _LEN.size + length)
            return record

    def close(self) -> None:
        try:
            self._mm.close()
        finally:
            self._file.close()

    def unlink(self) -> None:
        """Remove the backing file (writer-side cleanup)."""
        try:
            os.unlink(self.path)
        except FileNotFoundError:  # lint: allow-swallow (already gone)
            pass
