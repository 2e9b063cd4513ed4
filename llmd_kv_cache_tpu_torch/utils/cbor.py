"""Canonical CBOR encoding (RFC 7049 §3.9).

Copy of ``llmd_kv_cache_tpu/utils/cbor.py``, encoder and decoder (snapshots
and journals read with the decoder). The block-key hash chain hashes the
canonical-CBOR encoding of ``[parent, tokens, extra]`` (reference:
``pkg/kvcache/kvblock/token_processor.go:146-158``, which uses
``fxamacker/cbor`` ``CanonicalEncOptions``). Interop with engines that
compute block hashes the same way requires byte-exact encodings, so this
module implements the canonical subset needed by the hash payloads:

- unsigned/negative integers in shortest form (major types 0/1)
- byte strings (major 2) and UTF-8 text strings (major 3)
- definite-length arrays (major 4) and maps (major 5)
- ``False``/``True``/``None`` simple values (0xf4/0xf5/0xf6)
- float64 (major 7, ai 27) — canonical float shortening is intentionally
  not implemented; hash payloads never contain floats.

Map keys are sorted per RFC 7049 canonical ordering: shorter encoded key
first, then bytewise lexicographic. ``None`` encodes as null (0xf6), which
matches fxamacker's ``NilContainerAsNull`` treatment of nil Go slices.
"""

from __future__ import annotations

import struct
from typing import Any

_MAJOR_UINT = 0
_MAJOR_NEGINT = 1
_MAJOR_BYTES = 2
_MAJOR_TEXT = 3
_MAJOR_ARRAY = 4
_MAJOR_MAP = 5


def _encode_head(major: int, value: int) -> bytes:
    """Encode a major type + unsigned argument in shortest form."""
    mt = major << 5
    if value < 24:
        return bytes((mt | value,))
    if value <= 0xFF:
        return bytes((mt | 24, value))
    if value <= 0xFFFF:
        return bytes((mt | 25,)) + value.to_bytes(2, "big")
    if value <= 0xFFFFFFFF:
        return bytes((mt | 26,)) + value.to_bytes(4, "big")
    if value <= 0xFFFFFFFFFFFFFFFF:
        return bytes((mt | 27,)) + value.to_bytes(8, "big")
    raise ValueError(f"integer too large for CBOR head: {value}")


def _encode_item(obj: Any, out: list[bytes]) -> None:
    if obj is None:
        out.append(b"\xf6")
    elif obj is True:
        out.append(b"\xf5")
    elif obj is False:
        out.append(b"\xf4")
    elif isinstance(obj, int):
        if obj >= 0:
            out.append(_encode_head(_MAJOR_UINT, obj))
        else:
            out.append(_encode_head(_MAJOR_NEGINT, -1 - obj))
    elif isinstance(obj, bytes):
        out.append(_encode_head(_MAJOR_BYTES, len(obj)))
        out.append(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_encode_head(_MAJOR_TEXT, len(raw)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_encode_head(_MAJOR_ARRAY, len(obj)))
        for item in obj:
            _encode_item(item, out)
    elif isinstance(obj, dict):
        out.append(_encode_head(_MAJOR_MAP, len(obj)))
        pairs = []
        for k, v in obj.items():
            kparts: list[bytes] = []
            _encode_item(k, kparts)
            vparts: list[bytes] = []
            _encode_item(v, vparts)
            pairs.append((b"".join(kparts), b"".join(vparts)))
        # RFC 7049 canonical: shorter key first, then bytewise.
        pairs.sort(key=lambda kv: (len(kv[0]), kv[0]))
        for kenc, venc in pairs:
            out.append(kenc)
            out.append(venc)
    elif isinstance(obj, float):
        out.append(b"\xfb" + struct.pack(">d", obj))
    else:
        raise TypeError(f"cannot canonically CBOR-encode {type(obj)!r}")


def canonical_cbor_encode(obj: Any) -> bytes:
    """Encode ``obj`` as canonical CBOR bytes."""
    out: list[bytes] = []
    _encode_item(obj, out)
    return b"".join(out)


class CBORDecodeError(ValueError):
    """Malformed or out-of-subset CBOR input."""


def _decode_head(data: bytes, pos: int) -> tuple[int, int, int]:
    """Decode a head at ``pos``; returns (major, argument, next_pos)."""
    if pos >= len(data):
        raise CBORDecodeError("truncated CBOR: missing head")
    b = data[pos]
    major, ai = b >> 5, b & 0x1F
    pos += 1
    if ai < 24:
        return major, ai, pos
    if ai > 27:
        raise CBORDecodeError(f"unsupported additional info {ai}")
    n = 1 << (ai - 24)
    if pos + n > len(data):
        raise CBORDecodeError("truncated CBOR: short head argument")
    return major, int.from_bytes(data[pos:pos + n], "big"), pos + n


def _decode_item(data: bytes, pos: int) -> tuple[Any, int]:
    b = data[pos] if pos < len(data) else None
    if b == 0xF4:
        return False, pos + 1
    if b == 0xF5:
        return True, pos + 1
    if b == 0xF6:
        return None, pos + 1
    if b == 0xFB:
        if pos + 9 > len(data):
            raise CBORDecodeError("truncated CBOR: short float64")
        return struct.unpack(">d", data[pos + 1:pos + 9])[0], pos + 9
    major, arg, pos = _decode_head(data, pos)
    if major == _MAJOR_UINT:
        return arg, pos
    if major == _MAJOR_NEGINT:
        return -1 - arg, pos
    if major in (_MAJOR_BYTES, _MAJOR_TEXT):
        if pos + arg > len(data):
            raise CBORDecodeError("truncated CBOR: short string body")
        raw = data[pos:pos + arg]
        return (raw if major == _MAJOR_BYTES else raw.decode("utf-8")), pos + arg
    if major == _MAJOR_ARRAY:
        items = []
        for _ in range(arg):
            item, pos = _decode_item(data, pos)
            items.append(item)
        return items, pos
    if major == _MAJOR_MAP:
        out: dict = {}
        for _ in range(arg):
            k, pos = _decode_item(data, pos)
            v, pos = _decode_item(data, pos)
            out[k] = v
        return out, pos
    raise CBORDecodeError(f"unsupported major type {major}")


def canonical_cbor_decode(data: bytes) -> Any:
    """Decode bytes produced by :func:`canonical_cbor_encode`.

    Accepts exactly the encoder's subset (shortest-form ints, definite
    strings/arrays/maps, false/true/null, float64) and raises
    :class:`CBORDecodeError` on anything else, on truncation, and on
    trailing bytes — a decode-encode round trip is byte-identical, which
    is what lets snapshot checksums cover the semantic content.
    """
    obj, pos = _decode_item(data, 0)
    if pos != len(data):
        raise CBORDecodeError(f"{len(data) - pos} trailing byte(s) after CBOR item")
    return obj
