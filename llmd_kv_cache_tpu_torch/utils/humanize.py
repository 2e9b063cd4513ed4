"""Human-readable byte sizes.

Copy of ``llmd_kv_cache_tpu/utils/humanize.py``.

The cost-aware index budget is configured as a string like ``"2GiB"``
(reference: ``pkg/kvcache/kvblock/cost_aware_memory.go:47-60``, which uses
go-humanize). Accepts both SI (kB/MB/GB, powers of 1000) and IEC
(KiB/MiB/GiB, powers of 1024) suffixes, case-insensitively, plus bare byte
counts.
"""

from __future__ import annotations

import re

_UNITS = {
    "": 1,
    "b": 1,
    "kb": 1000,
    "mb": 1000**2,
    "gb": 1000**3,
    "tb": 1000**4,
    "pb": 1000**5,
    "kib": 1024,
    "mib": 1024**2,
    "gib": 1024**3,
    "tib": 1024**4,
    "pib": 1024**5,
}

_SIZE_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([a-zA-Z]*)\s*$")


def parse_bytes(size: str | int | float) -> int:
    """Parse a human byte-size string (e.g. ``"2GiB"``, ``"500 MB"``) to bytes."""
    if isinstance(size, (int, float)):
        return int(size)
    m = _SIZE_RE.match(size)
    if not m:
        raise ValueError(f"cannot parse byte size: {size!r}")
    value, unit = m.groups()
    unit = unit.lower()
    if unit not in _UNITS:
        raise ValueError(f"unknown byte-size unit {unit!r} in {size!r}")
    return int(float(value) * _UNITS[unit])
