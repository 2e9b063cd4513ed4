"""An in-repo safetensors codec: read and write the format with torch alone.

The card's machine has no ``safetensors`` package, and the port may not come
to need one. A file is an 8-byte little-endian header length ``N``, ``N``
bytes of UTF-8 JSON (``{name: {"dtype", "shape", "data_offsets": [begin,
end]}, "__metadata__": {str: str}}``, padded with spaces to a multiple of 8),
then the tensors' bytes, contiguous, each ``[begin, end)`` relative to the
end of the header.

``SafetensorsFile`` reads a file's header and hands out one tensor at a
time: ``torch.frombuffer`` over an ``mmap`` of that tensor's bytes alone
(copy-on-write, so the buffer is writable and the file untouched), copied to
the caller's device, the map then closed. Reading a file of many gigabytes
holds about one tensor in host memory (a map of the whole file would keep
every page it touched resident where ``madvise`` cannot drop them).
``save_file`` writes tensors one at a time, and a tensor on the card reaches
the host in 64 MiB pieces, so writing holds little host memory either. Dtypes: ``BF16``, ``F16``,
``F32``, ``F64``, ``I64``, ``I32``, ``I8``, ``U8`` and ``BOOL``; any other
(``F8_E4M3``, ``I16``, ...) raises and names itself.

Checks on read: the header's length lies inside the file, the header is
UTF-8 JSON whose entries each have a known dtype, a shape of non-negative
ints and offsets whose span is the shape's bytes; the entries' spans are
contiguous from 0 with no hole or overlap, and the last ends at the end of
the file (a truncated file, or one with trailing bytes, raises).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Iterator, Mapping, Optional

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
# A header longer than this is not a safetensors header (the library's limit).
_MAX_HEADER = 100 * 1024 * 1024


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file, or a tensor this
    codec does not read."""


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def parse_header(path: str, file_size: int, head: bytes) -> tuple[dict, dict, int]:
    """``(entries, metadata, data_start)`` of a file whose first bytes are
    ``head`` (at least the 8-byte length and the header): each entry
    ``name -> (dtype name, shape, begin, end)``, in offset order."""
    if file_size < 8 or len(head) < 8:
        raise SafetensorsError(f"{path}: {file_size} bytes, too short for a header length")
    (n,) = struct.unpack("<Q", head[:8])
    if n > _MAX_HEADER or 8 + n > file_size:
        raise SafetensorsError(f"{path}: header length {n} does not fit a file of "
                               f"{file_size} bytes")
    try:
        header = json.loads(head[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise SafetensorsError(f"{path}: the header is not UTF-8 JSON ({exc})") from exc
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    entries = []
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = info["dtype"], list(info["shape"]), info["data_offsets"]
        except (KeyError, TypeError, ValueError) as exc:
            raise SafetensorsError(f"{path}: tensor {name!r} has a malformed entry "
                                   f"{info!r}") from exc
        if not all(isinstance(d, int) and d >= 0 for d in shape) or not all(
                isinstance(x, int) for x in (begin, end)):
            raise SafetensorsError(f"{path}: tensor {name!r} has shape {shape} and offsets "
                                   f"{[begin, end]}")
        entries.append((begin, end, name, dtype, shape))
    entries.sort(key=lambda e: (e[0], e[1]))
    data_start, expect = 8 + n, 0
    out = {}
    for begin, end, name, dtype, shape in entries:
        if begin != expect or end < begin:
            raise SafetensorsError(f"{path}: tensor {name!r} spans [{begin}, {end}) where the "
                                   f"data continues at {expect}: offsets must be contiguous")
        if dtype in DTYPES and end - begin != _numel(shape) * _itemsize(DTYPES[dtype]):
            raise SafetensorsError(f"{path}: tensor {name!r} ({dtype} {shape}) spans "
                                   f"{end - begin} bytes")
        out[name] = (dtype, tuple(shape), begin, end)
        expect = end
    if data_start + expect != file_size:
        raise SafetensorsError(
            f"{path}: the tensors end at byte {data_start + expect} of a {file_size}-byte "
            f"file ({'truncated' if data_start + expect > file_size else 'trailing bytes'})")
    return out, metadata, data_start


class SafetensorsFile:
    """One safetensors file, its header read; ``get_tensor(name, device)``
    maps that tensor's bytes alone (``mmap``), copies them to ``device`` (a
    tensor of its own) and unmaps them. Use it as a context manager, or
    call ``close()``."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._file = open(self.path, "rb")
        try:
            size = os.fstat(self._file.fileno()).st_size
            head = self._file.read(8)
            if len(head) == 8:
                n = struct.unpack("<Q", head)[0]
                head += self._file.read(min(n, _MAX_HEADER))
            self.entries, self.metadata, self._data = parse_header(self.path, size, head)
        except BaseException:
            self.close()
            raise

    def keys(self) -> list[str]:
        return list(self.entries)

    def info(self, name: str) -> tuple[torch.dtype, tuple]:
        """The tensor's torch dtype and shape, from the header (raises for a
        dtype this codec does not read)."""
        dtype, shape, _, _ = self.entries[name]
        if dtype not in DTYPES:
            raise SafetensorsError(
                f"{self.path}: tensor {name!r} has dtype {dtype}, which this reader does not "
                f"support (supported: {', '.join(DTYPES)})")
        return DTYPES[dtype], shape

    def get_tensor(self, name: str, device="cpu") -> torch.Tensor:
        dtype, shape = self.info(name)
        _, _, begin, end = self.entries[name]
        device = torch.device(device)
        if begin == end:
            return torch.empty(shape, dtype=dtype, device=device)
        start = self._data + begin
        base = start - start % mmap.ALLOCATIONGRANULARITY
        # Copy-on-write: frombuffer wants a writable buffer, and the file
        # stays untouched. The map is this tensor's alone, so the host
        # holds one tensor's pages at a time, whatever the file's size.
        with mmap.mmap(self._file.fileno(), self._data + end - base,
                       access=mmap.ACCESS_COPY, offset=base) as m:
            view = torch.frombuffer(m, dtype=dtype, count=_numel(shape),
                                    offset=start - base).reshape(shape)
            out = view.clone() if device.type == "cpu" else view.to(device)
            del view
        return out

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str, device="cpu") -> dict[str, torch.Tensor]:
    """Every tensor of ``path`` on ``device``, in offset order."""
    with SafetensorsFile(path) as f:
        return {name: f.get_tensor(name, device) for name in f.keys()}


# A tensor on another device reaches the host in pieces of this many bytes.
_CHUNK = 64 << 20


def _write_tensor(f, t: torch.Tensor) -> None:
    """Write a tensor's bytes; one on another device (the card) is copied to
    the host ``_CHUNK`` bytes at a time, so the host never holds it whole."""
    data = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if data.device.type == "cpu":
        f.write(data.numpy())
        return
    for i in range(0, data.numel(), _CHUNK):
        f.write(data[i:i + _CHUNK].cpu().numpy())


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (on any device; see ``_write_tensor``) to ``path``,
    the wider dtypes first (as the library orders them, so that
    every tensor's bytes are aligned to its element), the mapping's order
    within a width. ``metadata`` (str to str) becomes the header's
    ``__metadata__``."""
    order = sorted(tensors, key=lambda name: -tensors[name].element_size())
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise SafetensorsError(f"tensor {name!r} has dtype {t.dtype}, which this writer "
                                   f"does not support (supported: {', '.join(DTYPES)})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise SafetensorsError("metadata keys and values must be strings")
        header = {"__metadata__": dict(metadata), **header}
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            _write_tensor(f, tensors[name])


def iter_index(path: str) -> Iterator[tuple[str, str]]:
    """``(tensor name, file)`` pairs of a sharded checkpoint's index JSON
    (``model.safetensors.index.json``, ``pytorch_model.bin.index.json``):
    its ``weight_map``, each file joined to the index's directory."""
    with open(path, encoding="utf-8") as f:
        index = json.load(f)
    try:
        weight_map = index["weight_map"]
    except (KeyError, TypeError) as exc:
        raise SafetensorsError(f"{path}: no weight_map") from exc
    root = os.path.dirname(os.path.abspath(path))
    for name, file in weight_map.items():
        yield name, os.path.join(root, file)
