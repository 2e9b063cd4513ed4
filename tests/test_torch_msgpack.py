"""The port's in-repo MessagePack codec against the ``msgpack`` library.

``packb`` must be byte-identical to ``msgpack.packb(obj, use_bin_type=True)``
and ``unpackb`` equal to ``msgpack.unpackb(data, raw=False,
strict_map_key=False)`` on the event wire's types; every input the library
refuses with a ``ValueError`` the codec refuses with one too. Ext types are
the one deliberate difference (the codec raises at once).
"""

import math

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_kv_cache_tpu_torch.utils import msgpack_codec as codec

ref_pack = lambda obj: msgpack.packb(obj, use_bin_type=True)  # noqa: E731
ref_unpack = lambda b: msgpack.unpackb(b, raw=False, strict_map_key=False)  # noqa: E731

scalars = (
    st.none()
    | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.floats(allow_nan=False)
    | st.text(max_size=300)
    | st.binary(max_size=300)
)
keys = st.none() | st.booleans() | st.integers(-(2**63), 2**64 - 1) | st.text(max_size=40) | st.binary(max_size=20)
trees = st.recursive(
    scalars,
    lambda children: st.lists(children, max_size=20)
    | st.tuples(children, children)
    | st.dictionaries(keys, children, max_size=8),
    max_leaves=40,
)


def same(a, b) -> bool:
    """Equal as the library's objects, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    return a == b


@settings(max_examples=150, deadline=None)
@given(trees)
def test_tree_bytes_and_round_trip_equal_library(obj):
    packed = codec.packb(obj)
    assert packed == ref_pack(obj)
    assert same(codec.unpackb(packed), ref_unpack(packed))


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
    2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1,
    -(2**63), 0.0, -0.0, 1.5, 1e300, float("inf"), float("nan"), True, False, None,
])
def test_scalar_widths(value):
    packed = codec.packb(value)
    assert packed == ref_pack(value)
    assert same(codec.unpackb(packed), ref_unpack(packed))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_lengths_of_every_width(n):
    for obj in ("x" * n, b"y" * n, [1] * n, {i: None for i in range(n)}, "é" * (n // 2)):
        packed = codec.packb(obj)
        assert packed == ref_pack(obj)
        assert same(codec.unpackb(packed), ref_unpack(packed))


def test_event_batch_with_block_hashes_at_and_above_2_63():
    rng = np.random.default_rng(0)
    hashes = [int(h) for h in rng.integers(0, 2**64, 64, dtype=np.uint64)] + [2**63, 2**64 - 1]
    batch = [1.7e9 + 0.25, [["BlockStored", hashes, None, list(range(256)), 16, None, "tpu-hbm"],
                            ["BlockRemoved", hashes[:3]], ["AllBlocksCleared"]],
             3, "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01", 7]
    packed = codec.packb(batch)
    assert packed == ref_pack(batch)
    assert codec.unpackb(packed) == ref_unpack(packed)


def test_library_decodes_float32_and_str8_as_the_codec():
    for raw in (b"\xca\x3f\xc0\x00\x00", b"\xd9\x03abc", b"\xc4\x00", b"\x81\xc4\x01a\x01",
                b"\x81\xc0\x01", b"\x82\x01\x01\x01\x02", b"\x80", b"\x90"):
        assert same(codec.unpackb(raw), ref_unpack(raw))


def ref_raises_value_error(raw) -> bool:
    try:
        ref_unpack(raw)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("raw", [
    b"", b"\x92\x01", b"\xcd\x01", b"\xa5abc", b"\xda\x00", b"\xc4\x05ab",
    b"\xdd\xff\xff\xff\xff", b"\xdf\x00\x00\x00\x02\x01", b"\x81\x01",
    b"\x01\x02", b"\x90\x00",  # trailing bytes
    b"\xc1", b"\x91\xc1",  # the reserved byte
    b"\xa2\xff\xfe",  # invalid UTF-8
    b"\x91" * 1025 + b"\x01",  # deeper than the library's stack
])
def test_errors_are_value_errors_where_the_library_raises_one(raw):
    assert ref_raises_value_error(raw)
    with pytest.raises(ValueError):
        codec.unpackb(raw)


@pytest.mark.parametrize("depth", [1000, 1023, 1024])
def test_deep_nesting_within_the_library_stack(depth):
    raw = b"\x91" * depth + b"\x01"
    got = codec.unpackb(raw)
    assert got == ref_unpack(raw)
    assert codec.packb([]) == ref_pack([])


def test_unhashable_map_key_is_a_type_error_as_in_the_library():
    for raw in (b"\x81\x91\x01\x02", b"\x81\x80\x01"):
        with pytest.raises(TypeError):
            ref_unpack(raw)
        with pytest.raises(TypeError):
            codec.unpackb(raw)


@pytest.mark.parametrize("raw", [b"\xd4\x01\x02", b"\xd6\xff\x00\x00\x00\x01",
                                 b"\xc7\x01\x05\x00", b"\x92\x01\xd5\x01\x00\x00"])
def test_ext_types_raise_at_once(raw):
    ref_unpack(raw)  # the library returns an ExtType / Timestamp here
    with pytest.raises(ValueError):
        codec.unpackb(raw)


def test_random_bytes_fail_exactly_where_the_library_fails():
    """Seeded garbage (the adapter fuzz's shape): the codec accepts what the
    library decodes without ext types, equal, and refuses the rest with the
    library's exception class family."""
    rng = np.random.default_rng(0)
    for _ in range(3000):
        raw = bytes(rng.integers(0, 256, rng.integers(0, 64), dtype=np.uint8))
        try:
            want = ref_unpack(raw)
        except (ValueError, TypeError) as exc:
            with pytest.raises(ValueError if isinstance(exc, ValueError) else TypeError):
                codec.unpackb(raw)
            continue
        if _has_ext(want):
            with pytest.raises(ValueError):
                codec.unpackb(raw)
        else:
            assert same(codec.unpackb(raw), want)


def _has_ext(obj) -> bool:
    if isinstance(obj, (msgpack.ExtType, msgpack.Timestamp)):
        return True
    if isinstance(obj, list):
        return any(_has_ext(x) for x in obj)
    if isinstance(obj, dict):
        return any(_has_ext(k) or _has_ext(v) for k, v in obj.items())
    return False


def test_pack_refuses_what_the_library_refuses():
    for bad in (2**64, -(2**63) - 1):
        with pytest.raises(OverflowError):
            ref_pack(bad)
        with pytest.raises(OverflowError):
            codec.packb(bad)
    with pytest.raises(TypeError):
        codec.packb(object())
    deep: list = []
    for _ in range(600):
        deep = [deep]
    with pytest.raises(ValueError):
        ref_pack(deep)
    with pytest.raises(ValueError):
        codec.packb(deep)
