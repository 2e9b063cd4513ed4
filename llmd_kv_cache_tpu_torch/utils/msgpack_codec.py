"""MessagePack encoding and decoding for the KV-event wire.

The JAX package packs and unpacks event batches with the ``msgpack``
library (``events/publisher.py``, ``events/adapters/vllm.py``); the port
keeps this codec of its own, as it keeps ``utils/cbor.py`` and
``utils/safetensors.py``, so that its event plane runs where that library
is not installed. It covers the wire's types and agrees with the library
byte for byte:

- ``packb(obj)`` equals ``msgpack.packb(obj, use_bin_type=True)`` for
  ``None``, ``bool``, ``int`` (-2**63 .. 2**64-1, each in its shortest
  form), ``float`` (always float64), ``str`` (fixstr, str8/16/32),
  ``bytes``/``bytearray``/``memoryview`` (bin8/16/32), ``list`` and
  ``tuple`` (arrays) and ``dict`` (maps, in iteration order);
- ``unpackb(data)`` equals ``msgpack.unpackb(data, raw=False,
  strict_map_key=False)``: arrays decode to lists, maps to dicts, str to
  ``str`` (strict UTF-8), bin to ``bytes``, float32 and float64 to
  ``float``. It raises ``ValueError`` wherever the library raises one or a
  subclass of it: truncated input, trailing bytes, the reserved byte
  ``0xc1``, invalid UTF-8, and containers nested deeper than the library's
  1024 (decoding is iterative, so no Python recursion limit applies).
  An unhashable map key raises ``TypeError``, as in the library.

The one deliberate difference: an ext type (``0xc7``-``0xc9``,
``0xd4``-``0xd8``, the timestamp among them) raises ``ValueError`` here,
where the library returns an ``ExtType`` or ``Timestamp`` that the event
adapters then reject. No publisher of the event wire sends one.
"""

from __future__ import annotations

import struct
from typing import Any

# The library's unpacker stack: at most this many containers open at once.
MAX_DEPTH = 1024
# The library packer's default recursion limit.
_PACK_DEPTH = 511

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out += b"\xcc" + _B.pack(v)
        elif v < 0x10000:
            out += b"\xcd" + _H.pack(v)
        elif v < 0x100000000:
            out += b"\xce" + _I.pack(v)
        elif v < 0x10000000000000000:
            out += b"\xcf" + _Q.pack(v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -0x20:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + _b.pack(v)
    elif v >= -0x8000:
        out += b"\xd1" + _h.pack(v)
    elif v >= -0x80000000:
        out += b"\xd2" + _i.pack(v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix_tag: int, fix_max: int, tags: tuple, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the 8 (when
    ``tags[0]`` is set), 16 or 32-bit form."""
    if n < fix_max:
        out.append(fix_tag | n)
    elif tags[0] is not None and n < 0x100:
        out.append(tags[0])
        out.append(n)
    elif n < 0x10000:
        out.append(tags[1])
        out += _H.pack(n)
    elif n < 0x100000000:
        out.append(tags[2])
        out += _I.pack(n)
    else:
        raise ValueError(f"object too large to pack ({n})")


def _pack(obj: Any, out: bytearray, depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _d.pack(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), 0, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out, depth - 1)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out, depth - 1)
            _pack(v, out, depth - 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """Serialize ``obj`` as ``msgpack.packb(obj, use_bin_type=True)`` does."""
    out = bytearray()
    _pack(obj, out, _PACK_DEPTH)
    return bytes(out)


# --------------------------------------------------------------------------
# Unpacking
# --------------------------------------------------------------------------

# Fixed-width scalars: first byte → (struct, width).
_FIXED = {
    0xCA: _f, 0xCB: _d,
    0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
    0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q,
}
# Length-prefixed str / bin and container headers: first byte → struct.
_STR = {0xD9: _B, 0xDA: _H, 0xDB: _I}
_BIN = {0xC4: _B, 0xC5: _H, 0xC6: _I}
_ARRAY = {0xDC: _H, 0xDD: _I}
_MAP = {0xDE: _H, 0xDF: _I}
_EXT = frozenset((0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8))

_INCOMPLETE = "Unpack failed: incomplete input"


def unpackb(data) -> Any:
    """Deserialize one object, as ``msgpack.unpackb(data, raw=False,
    strict_map_key=False)`` does (ext types aside: see the module doc)."""
    buf = data if isinstance(data, bytes) else bytes(data)
    n = len(buf)
    pos = 0
    # Open containers: [container, items left, is_map, pending key, key set].
    stack: list[list] = []
    while True:
        if pos >= n:
            raise ValueError(_INCOMPLETE)
        b = buf[pos]
        pos += 1
        count = -1  # >= 0: a container header with this many entries
        is_map = False
        if b < 0x80:
            value = b
        elif b >= 0xE0:
            value = b - 0x100
        elif b < 0x90:
            count, is_map = b & 0x0F, True
        elif b < 0xA0:
            count = b & 0x0F
        elif b < 0xC0:
            end = pos + (b & 0x1F)
            if end > n:
                raise ValueError(_INCOMPLETE)
            value = buf[pos:end].decode("utf-8")
            pos = end
        elif b == 0xC0:
            value = None
        elif b == 0xC2:
            value = False
        elif b == 0xC3:
            value = True
        elif b in _FIXED:
            st = _FIXED[b]
            end = pos + st.size
            if end > n:
                raise ValueError(_INCOMPLETE)
            value = st.unpack_from(buf, pos)[0]
            pos = end
        elif b in _STR or b in _BIN:
            st = _STR.get(b) or _BIN[b]
            if pos + st.size > n:
                raise ValueError(_INCOMPLETE)
            length = st.unpack_from(buf, pos)[0]
            pos += st.size
            end = pos + length
            if end > n:
                raise ValueError(_INCOMPLETE)
            value = buf[pos:end].decode("utf-8") if b in _STR else buf[pos:end]
            pos = end
        elif b in _ARRAY or b in _MAP:
            st = _ARRAY.get(b) or _MAP[b]
            if pos + st.size > n:
                raise ValueError(_INCOMPLETE)
            count, is_map = st.unpack_from(buf, pos)[0], b in _MAP
            pos += st.size
        elif b in _EXT:
            raise ValueError(f"msgpack ext type (0x{b:02x}) is not supported")
        else:  # 0xc1: never used
            raise ValueError(f"reserved msgpack byte 0x{b:02x}")

        if count > 0:
            # Each entry takes at least one byte (two for a map's).
            if count * (2 if is_map else 1) > n - pos:
                raise ValueError(_INCOMPLETE)
            if len(stack) >= MAX_DEPTH:
                raise ValueError("msgpack nesting exceeds the unpacker's stack")
            stack.append([{} if is_map else [], count, is_map, None, False])
            continue
        if count == 0:
            value = {} if is_map else []

        # Deliver ``value`` to the open containers, closing full ones.
        while stack:
            top = stack[-1]
            if top[2]:
                if not top[4]:
                    top[3], top[4] = value, True
                    break
                top[0][top[3]] = value
                top[3], top[4] = None, False
            else:
                top[0].append(value)
            top[1] -= 1
            if top[1]:
                break
            stack.pop()
            value = top[0]
        else:
            if pos != n:
                raise ValueError("unpack(b) received extra data.")
            return value
