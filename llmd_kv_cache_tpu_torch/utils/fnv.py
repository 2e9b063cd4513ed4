"""FNV-1a hashing.

Copy of the 64-bit variant in ``llmd_kv_cache_tpu/utils/fnv.py``: it
seeds and chains the block-key hashes (reference:
``pkg/kvcache/kvblock/token_processor.go:114-118,155-157``).
"""

from __future__ import annotations

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_64(data: bytes, seed: int = _FNV64_OFFSET) -> int:
    """64-bit FNV-1a hash of ``data``."""
    h = seed
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _MASK64
    return h
