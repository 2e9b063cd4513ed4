"""Shared adapter helpers: topic parsing and hash normalization.

Copy of ``llmd_kv_cache_tpu/events/adapters/common.py`` (counterpart of
reference ``pkg/kvevents/engineadapter/common.go``).
"""

from __future__ import annotations

from typing import Any

_MASK64 = 0xFFFFFFFFFFFFFFFF


def parse_topic(topic: str) -> tuple[str, str]:
    """Parse ``kv@<pod-id>@<model>`` → (pod_id, model).

    The model segment may itself contain ``@`` (LoRA refs etc.), so split at
    most twice (``common.go:39-45``).
    """
    parts = topic.split("@", 2)
    if len(parts) < 3:
        return (parts[1] if len(parts) > 1 else "", "")
    return parts[1], parts[2]


def hash_to_uint64(raw: Any) -> int:
    """Normalize an engine hash value to uint64.

    Engines emit block hashes as unsigned ints, signed ints (Python's hash()
    can be negative), or raw bytes (sha256-style digests, of which the last
    8 bytes big-endian are taken) — ``common.go:50-71``.
    """
    if isinstance(raw, bool):
        raise TypeError("hash value cannot be a bool")
    if isinstance(raw, int):
        return raw & _MASK64
    if isinstance(raw, (bytes, bytearray)):
        if len(raw) == 0:
            raise ValueError("empty bytes hash")
        tail = bytes(raw[-8:])
        return int.from_bytes(tail, "big")
    raise TypeError(f"unsupported hash type: {type(raw)!r}")


def to_int(raw: Any) -> int:
    if isinstance(raw, bool) or not isinstance(raw, int):
        raise TypeError(f"unsupported numeric type: {type(raw)!r}")
    return raw


def field_at(fields: list, i: int) -> Any:
    """Positional access tolerant of omitted trailing fields."""
    return fields[i] if i < len(fields) else None
