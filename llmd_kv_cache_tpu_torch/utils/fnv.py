"""FNV-1a hashing.

Copy of ``llmd_kv_cache_tpu/utils/fnv.py``. The 64-bit variant seeds and
chains the block-key hashes (reference:
``pkg/kvcache/kvblock/token_processor.go:114-118,155-157``); the 32-bit
variant shards event-pool queues by pod id (``pkg/kvevents/pool.go:161-173``).
"""

from __future__ import annotations

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_FNV32_OFFSET = 0x811C9DC5
_FNV32_PRIME = 0x01000193
_MASK64 = 0xFFFFFFFFFFFFFFFF
_MASK32 = 0xFFFFFFFF


def fnv1a_64(data: bytes, seed: int = _FNV64_OFFSET) -> int:
    """64-bit FNV-1a hash of ``data``."""
    h = seed
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _MASK64
    return h


def fnv1a_32(data: bytes, seed: int = _FNV32_OFFSET) -> int:
    """32-bit FNV-1a hash of ``data``."""
    h = seed
    for b in data:
        h = ((h ^ b) * _FNV32_PRIME) & _MASK32
    return h
