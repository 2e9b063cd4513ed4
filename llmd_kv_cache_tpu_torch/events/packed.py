"""Packed zero-copy event frames (docs/architecture.md "Native data plane").

Copy of ``llmd_kv_cache_tpu/events/packed.py``: frames are byte-identical
between the two packages, both ways.

The msgpack event wire materializes one Python object per block hash and
per token before the pool can touch them — at fleet ingest rates the
decode alloc churn, not the index, dominates the worker profile. This
module defines the packed alternative: a fixed struct header plus raw
little-endian key/token arrays, decoded with ``np.frombuffer`` into
*views over the received buffer*. No per-element Python object is ever
created; the uint64 engine keys and uint32 tokens flow from the socket
buffer straight into the native hash chain and ``kvidx_add``.

Frame layout (little-endian, offsets in bytes)::

    0   4s  magic  b"KZC1"
    4   H   pod_id byte length
    6   H   model_name byte length
    8   I   engine block size (tokens per engine block; 0 = unknown)
    12  d   event batch timestamp (unix seconds, publisher clock)
    20  Q   parent engine hash (0 = chain root)
    28  I   n_engine_keys
    32  I   n_tokens
    36  ... pod_id bytes, model_name bytes, zero padding to an 8-byte
            boundary, engine_keys (n*u64), tokens (n*u32)

One frame is one BlockStored digest — the hot-path event shape; removal
and clear events stay on the msgpack wire (they are rare and cheap).
Consumers sniff the 4-byte magic, so packed and msgpack frames can share
one transport. The same frames ride the shared-memory ring
(:mod:`.shm_ring`) unchanged.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"KZC1"
_HEADER = struct.Struct("<4sHHIdQII")
HEADER_SIZE = _HEADER.size  # 36


def is_packed(payload: bytes) -> bool:
    """Cheap transport-side sniff: does this payload carry a packed frame?"""
    return len(payload) >= 4 and payload[:4] == MAGIC


def _pad8(n: int) -> int:
    return (n + 7) & ~7


@dataclass
class PackedBatch:
    """Decoded view of one packed frame.

    ``engine_keys``/``tokens`` are read-only numpy views over the frame
    buffer — hold the frame alive as long as they are in use (the pool
    consumes them within one worker iteration, so this never bites in
    practice).
    """

    pod_id: str
    model_name: str
    timestamp: float
    parent_hash: int
    block_size: int
    engine_keys: np.ndarray  # uint64 view
    tokens: np.ndarray  # uint32 view


def encode_packed_batch(
    pod_id: str,
    model_name: str,
    engine_keys,
    tokens,
    *,
    timestamp: float,
    parent_hash: int = 0,
    block_size: int = 0,
) -> bytes:
    """Assemble one frame (publisher side / tests / bench)."""
    pod_b = pod_id.encode("utf-8")
    model_b = model_name.encode("utf-8")
    ek = np.ascontiguousarray(
        np.asarray(engine_keys, dtype=np.uint64).ravel()
    )
    tok = np.ascontiguousarray(
        np.asarray(tokens, dtype=np.uint32).ravel()
    )
    strings_end = HEADER_SIZE + len(pod_b) + len(model_b)
    arrays_off = _pad8(strings_end)
    buf = bytearray(arrays_off + ek.nbytes + tok.nbytes)
    _HEADER.pack_into(
        buf, 0, MAGIC, len(pod_b), len(model_b), block_size,
        float(timestamp), int(parent_hash) & 0xFFFFFFFFFFFFFFFF,
        len(ek), len(tok),
    )
    buf[HEADER_SIZE:HEADER_SIZE + len(pod_b)] = pod_b
    buf[HEADER_SIZE + len(pod_b):strings_end] = model_b
    buf[arrays_off:arrays_off + ek.nbytes] = ek.tobytes()
    tok_off = arrays_off + ek.nbytes
    buf[tok_off:tok_off + tok.nbytes] = tok.tobytes()
    return bytes(buf)


def decode_packed_batch(payload: bytes) -> PackedBatch:
    """Decode one frame into buffer views. Raises ValueError on a
    malformed frame (bad magic, truncated arrays) — callers treat that
    like any other parse failure."""
    if len(payload) < HEADER_SIZE:
        raise ValueError("packed frame shorter than header")
    (magic, pod_len, model_len, block_size, ts, parent_hash,
     n_ek, n_tok) = _HEADER.unpack_from(payload, 0)
    if magic != MAGIC:
        raise ValueError(f"bad packed-frame magic {magic!r}")
    strings_end = HEADER_SIZE + pod_len + model_len
    arrays_off = _pad8(strings_end)
    need = arrays_off + n_ek * 8 + n_tok * 4
    if len(payload) < need:
        raise ValueError(
            f"truncated packed frame: {len(payload)} < {need} bytes"
        )
    pod_id = payload[HEADER_SIZE:HEADER_SIZE + pod_len].decode("utf-8")
    model_name = payload[HEADER_SIZE + pod_len:strings_end].decode("utf-8")
    engine_keys = np.frombuffer(payload, np.uint64, n_ek, arrays_off)
    tokens = np.frombuffer(payload, np.uint32, n_tok, arrays_off + n_ek * 8)
    return PackedBatch(
        pod_id=pod_id,
        model_name=model_name,
        timestamp=float(ts),
        parent_hash=int(parent_hash),
        block_size=int(block_size),
        engine_keys=engine_keys,
        tokens=tokens,
    )
