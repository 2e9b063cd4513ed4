"""The port's in-repo safetensors codec against the ``safetensors`` library.

Both directions, for every dtype the codec takes (BF16, F16, F32, F64, I64,
I32, I8, U8, BOOL): the library reads the port's files bit for bit, and the
port reads the library's. Empty and 0-d tensors, metadata and the header's
padding ride along. Malformed files raise ``SafetensorsError``: a truncated
file, trailing bytes, offsets with a hole, an overlap or a wrong span, a
header that is not UTF-8 JSON or whose length runs past the file, and a
dtype the codec does not read (named in the message: ``F8_E4M3``, the dtype
of DeepSeek-V3's ``weight_scale_inv``). Reading maps one tensor's bytes at a
time, so a fresh process that reads a file of many tensors grows by about
one of them.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

safetensors_torch = pytest.importorskip("safetensors.torch")

from llmd_kv_cache_tpu_torch.utils import safetensors as st  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I8": torch.int8,
          "U8": torch.uint8, "BOOL": torch.bool}


def tensor(dtype, shape, seed):
    """Seeded data of ``dtype`` (floats from a normal draw, ints over their
    range's low bits, bools from a coin)."""
    rng = np.random.default_rng(seed)
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, shape).astype(np.bool_))
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    lo = 0 if dtype == torch.uint8 else -100
    return torch.from_numpy(rng.integers(lo, 100, shape)).to(dtype)


def bits(t):
    """A tensor's bytes, for an exact comparison."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def tensors_of(dtype):
    return {"w": tensor(dtype, (3, 5), 0), "b": tensor(dtype, (7,), 1),
            "scalar": tensor(dtype, (), 2), "empty": tensor(dtype, (0, 4), 3),
            "cube": tensor(dtype, (2, 3, 4), 4)}


def assert_same(got, want):
    assert list(got) == list(want) or set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and tuple(got[k].shape) == tuple(want[k].shape), k
        assert bits(got[k]) == bits(want[k]), k


@pytest.mark.parametrize("name", DTYPES)
def test_library_reads_the_ports_files(tmp_path, name):
    ts = tensors_of(DTYPES[name])
    st.save_file(ts, str(tmp_path / "m.safetensors"), metadata={"format": "pt"})
    assert_same(safetensors_torch.load_file(str(tmp_path / "m.safetensors")), ts)
    from safetensors import safe_open

    with safe_open(str(tmp_path / "m.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt"}


@pytest.mark.parametrize("name", DTYPES)
def test_port_reads_the_librarys_files(tmp_path, name):
    ts = tensors_of(DTYPES[name])
    safetensors_torch.save_file(ts, str(tmp_path / "m.safetensors"), metadata={"k": "v"})
    assert_same(st.load_file(str(tmp_path / "m.safetensors")), ts)
    with st.SafetensorsFile(str(tmp_path / "m.safetensors")) as f:
        assert f.metadata == {"k": "v"}
        assert f.info("w") == (DTYPES[name], (3, 5))
        assert f.info("scalar") == (DTYPES[name], ())


def test_mixed_dtypes_both_ways_and_aligned(tmp_path):
    """Every dtype in one file: each tensor's bytes start at a multiple of
    its element size (wider dtypes first), and the header is padded to 8."""
    ts = {f"t{i}_{name}": tensor(dt, (i + 1, 3), i) for i, (name, dt) in
          enumerate(DTYPES.items())}
    st.save_file(ts, str(tmp_path / "p.safetensors"))
    assert_same(safetensors_torch.load_file(str(tmp_path / "p.safetensors")), ts)
    raw = (tmp_path / "p.safetensors").read_bytes()
    n = struct.unpack("<Q", raw[:8])[0]
    assert n % 8 == 0
    header = json.loads(raw[8:8 + n])
    for k, t in ts.items():
        assert header[k]["data_offsets"][0] % t.element_size() == 0, k
    safetensors_torch.save_file(ts, str(tmp_path / "l.safetensors"))
    assert_same(st.load_file(str(tmp_path / "l.safetensors")), ts)


def test_non_contiguous_and_device_arguments(tmp_path):
    """A transposed view is written as its values; ``get_tensor`` gives a
    tensor of its own on the asked device."""
    w = tensor(torch.bfloat16, (4, 6), 9)
    st.save_file({"wt": w.t()}, str(tmp_path / "t.safetensors"))
    with st.SafetensorsFile(str(tmp_path / "t.safetensors")) as f:
        got = f.get_tensor("wt", "cpu")
    assert torch.equal(got, w.t()) and got.is_contiguous()
    got[0, 0] = 7.0  # its own storage: the file is untouched
    assert torch.equal(st.load_file(str(tmp_path / "t.safetensors"))["wt"], w.t())
    assert st.load_file(str(tmp_path / "t.safetensors"), device="meta")["wt"].is_meta


def write_raw(path, header: dict, data: bytes, pad=True):
    blob = json.dumps(header).encode()
    if pad:
        blob += b" " * (-len(blob) % 8)
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + data)


def test_truncated_and_trailing_bytes_raise(tmp_path):
    safetensors_torch.save_file({"w": tensor(torch.float32, (8, 8), 0)},
                                str(tmp_path / "m.safetensors"))
    raw = (tmp_path / "m.safetensors").read_bytes()
    for n in (0, 5, 8, 20, len(raw) - 1):
        (tmp_path / "cut.safetensors").write_bytes(raw[:n])
        with pytest.raises(st.SafetensorsError):
            st.load_file(str(tmp_path / "cut.safetensors"))
    (tmp_path / "long.safetensors").write_bytes(raw + b"\0")
    with pytest.raises(st.SafetensorsError, match="trailing"):
        st.load_file(str(tmp_path / "long.safetensors"))


@pytest.mark.parametrize("offsets,match", [
    ([[0, 16], [20, 36]], "contiguous"),     # a hole
    ([[0, 16], [8, 24]], "contiguous"),      # an overlap
    ([[0, 16], [16, 28]], "spans"),          # a span that is not the shape's bytes
    ([[4, 20], [20, 36]], "contiguous"),     # data that does not start at 0
    ([[0, 16], [16, 40]], "spans"),          # past the end of the file
])
def test_bad_offsets_raise(tmp_path, offsets, match):
    header = {"a": {"dtype": "F32", "shape": [4], "data_offsets": offsets[0]},
              "b": {"dtype": "F32", "shape": [4], "data_offsets": offsets[1]}}
    write_raw(tmp_path / "bad.safetensors", header, bytes(32))
    with pytest.raises(st.SafetensorsError, match=match):
        st.load_file(str(tmp_path / "bad.safetensors"))


def test_bad_headers_raise(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(struct.pack("<Q", 4) + b"\xff\xfe{}")
    with pytest.raises(st.SafetensorsError, match="UTF-8 JSON"):
        st.load_file(str(bad))
    bad.write_bytes(struct.pack("<Q", 8) + b"not json")
    with pytest.raises(st.SafetensorsError, match="UTF-8 JSON"):
        st.load_file(str(bad))
    bad.write_bytes(struct.pack("<Q", 8) + b"[1, 2]  ")
    with pytest.raises(st.SafetensorsError, match="JSON object"):
        st.load_file(str(bad))
    bad.write_bytes(struct.pack("<Q", 1 << 40) + b"{}")
    with pytest.raises(st.SafetensorsError, match="header length"):
        st.load_file(str(bad))
    write_raw(bad, {"a": {"dtype": "F32", "shape": [-1], "data_offsets": [0, 4]}}, bytes(4))
    with pytest.raises(st.SafetensorsError, match="shape"):
        st.load_file(str(bad))
    write_raw(bad, {"a": {"dtype": "F32", "shape": [1]}}, bytes(4))
    with pytest.raises(st.SafetensorsError, match="malformed"):
        st.load_file(str(bad))


def test_unsupported_dtype_raises_naming_it(tmp_path):
    """An F8_E4M3 tensor (DeepSeek-V3's weight_scale_inv sits beside such
    weights) raises, naming the dtype and the tensor; the file's other
    tensors still read, and the writer refuses such a tensor."""
    safetensors_torch.save_file(
        {"model.layers.0.mlp.down_proj.weight": torch.zeros(4, 4).to(torch.float8_e4m3fn),
         "ok": torch.ones(3)}, str(tmp_path / "f8.safetensors"))
    with st.SafetensorsFile(str(tmp_path / "f8.safetensors")) as f:
        with pytest.raises(st.SafetensorsError, match="F8_E4M3.*not support|down_proj"):
            f.get_tensor("model.layers.0.mlp.down_proj.weight")
        assert torch.equal(f.get_tensor("ok"), torch.ones(3))
    with pytest.raises(st.SafetensorsError, match="F8_E4M3"):
        st.load_file(str(tmp_path / "f8.safetensors"))
    with pytest.raises(st.SafetensorsError, match="float8"):
        st.save_file({"x": torch.zeros(2).to(torch.float8_e4m3fn)},
                     str(tmp_path / "w.safetensors"))


def test_empty_file_and_no_tensors(tmp_path):
    (tmp_path / "zero.safetensors").write_bytes(b"")
    with pytest.raises(st.SafetensorsError, match="too short"):
        st.load_file(str(tmp_path / "zero.safetensors"))
    st.save_file({}, str(tmp_path / "none.safetensors"))
    assert st.load_file(str(tmp_path / "none.safetensors")) == {}
    assert safetensors_torch.load_file(str(tmp_path / "none.safetensors")) == {}


def test_index_of_a_sharded_checkpoint(tmp_path):
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": 8}, "weight_map": {"a": "m-1.safetensors",
                                                        "b": "m-2.safetensors"}}))
    assert dict(st.iter_index(str(tmp_path / "model.safetensors.index.json"))) == {
        "a": str(tmp_path / "m-1.safetensors"), "b": str(tmp_path / "m-2.safetensors")}
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(st.SafetensorsError, match="weight_map"):
        list(st.iter_index(str(tmp_path / "bad.json")))


READER = r"""
import resource, sys
import torch
from llmd_kv_cache_tpu_torch.utils import safetensors as st
path = sys.argv[1]
with st.SafetensorsFile(path) as f:
    base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for name in f.keys():
        t = f.get_tensor(name)
        del t
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - base
print(grown * 1024)
"""


def test_reading_holds_about_one_tensor(tmp_path):
    """A fresh process reads 8 tensors of 16 MiB one at a time: its peak RSS
    grows by well under 8 of them (each tensor's copy is freed and its map
    closed)."""
    one = 16 << 20
    st.save_file({f"t{i}": torch.full((one // 4,), float(i)) for i in range(8)},
                 str(tmp_path / "big.safetensors"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", READER, str(tmp_path / "big.safetensors")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    grown = int(out.stdout.split()[-1])
    assert grown < 3 * one, grown
