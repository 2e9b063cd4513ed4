"""ctypes binding for the native kvio engine (``csrc/kvio`` at the checkout
root).

Port of ``llmd_kv_cache_tpu/offload/native.py``. The C++ sources are the
JAX package's own and stay untouched; this package compiles them itself,
with the Makefile's flags, into ``build/kvio/<hash of sources and
flags>/libkvio.so`` at the checkout root, writing to a private name and
renaming (as ``ops/cuda_build.py`` does for the kernels), so concurrent
builders (test workers, the JAX package's ``make`` beside the sources)
never race on one file. It is built at first use, never at import. A failed
build raises: there is no Python writer to fall back to.

NUMA placement: kvio's own discovery looks only for the TPU's PCI vendor id.
:func:`card_numa_node` reads the CUDA card's node from its sysfs entry
instead, and the I/O workers are pinned there. All file I/O runs on the C++
pool threads, off the GIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

from ..resilience.failpoints import failpoints

# Failpoints at the native submission boundary: error-mode raises
# FaultInjected before the op reaches the C++ pool (the worker turns it into
# a failed, retryable job); delay-mode simulates a slow disk.
# ``file_exists`` is custom-mode: firing makes the probe report "missing",
# shrinking lookup prefixes.
FP_SUBMIT_WRITE = "offload.native.submit_write"
FP_SUBMIT_READ = "offload.native.submit_read"
FP_FILE_EXISTS = "offload.native.file_exists"

_ROOT = Path(__file__).resolve().parents[2]
CSRC = _ROOT / "csrc" / "kvio"
BUILD_ROOT = _ROOT / "build" / "kvio"
SOURCES = ("kvio.cpp", "kvio_numa.cpp")
HEADERS = ("kvio.hpp", "kvio_numa.hpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

STATUS_PENDING = -1
STATUS_OK = 0
STATUS_IO_ERROR = 1
STATUS_CANCELLED = 2

# kvio_create's numa_node: -1 runs kvio's own discovery (which honours
# KVIO_NUMA_NODE), -2 turns placement off.
NUMA_DISCOVER = -1
NUMA_OFF = -2


def build() -> Path:
    """Compile ``libkvio.so`` unless this source hash is built; its path."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((cxx, *CXX_FLAGS)).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libkvio.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building kvio failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) the kvio shared library."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i, u64, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_double
        lib.kvio_create.restype = p
        lib.kvio_create.argtypes = [i, i, d, i, u64, i]
        lib.kvio_destroy.argtypes = [p]
        lib.kvio_begin_job.restype = u64
        lib.kvio_begin_job.argtypes = [p]
        lib.kvio_seal_job.argtypes = [p, u64]
        lib.kvio_submit_write.restype = i
        lib.kvio_submit_write.argtypes = [p, u64, ctypes.c_char_p, ctypes.c_char_p,
                                          p, u64, i]
        lib.kvio_submit_read.restype = None
        lib.kvio_submit_read.argtypes = [p, u64, ctypes.c_char_p, p, u64, u64]
        lib.kvio_poll_finished.restype = i
        lib.kvio_poll_finished.argtypes = [p, ctypes.POINTER(u64),
                                           ctypes.POINTER(i), i]
        lib.kvio_wait_job.restype = i
        lib.kvio_wait_job.argtypes = [p, u64, d]
        lib.kvio_file_exists.restype = i
        lib.kvio_file_exists.argtypes = [ctypes.c_char_p, i]
        lib.kvio_numa_node.restype = i
        lib.kvio_numa_node.argtypes = [p]
        lib.kvio_worker_cpu.restype = i
        lib.kvio_worker_cpu.argtypes = [p, i]
        lib.kvio_pinned_staging_workers.restype = i
        lib.kvio_pinned_staging_workers.argtypes = [p]
        lib.kvio_direct_transfers.restype = u64
        lib.kvio_direct_transfers.argtypes = [p]
        _lib = lib
        return _lib


class NativeIOEngine:
    """Thin OO wrapper over the C ABI.

    Workers are pinned round-robin to the CPUs of ``numa_node``
    (:data:`NUMA_DISCOVER` runs kvio's discovery, :data:`NUMA_OFF` disables
    placement) and prefer that node for allocations. ``direct_io`` routes
    transfers >= 4 KiB through O_DIRECT via each worker's staging buffer.
    """

    def __init__(self, num_threads: int = 4, read_preferring_workers: int = 3,
                 max_write_queued_seconds: float = 10.0,
                 numa_node: int = NUMA_DISCOVER, staging_bytes: int = 4 << 20,
                 direct_io: bool = False):
        self._lib = load_library()
        self._handle = self._lib.kvio_create(
            num_threads, read_preferring_workers, max_write_queued_seconds,
            numa_node, staging_bytes, int(direct_io),
        )
        if not self._handle:
            raise RuntimeError("failed to create kvio engine")
        self.num_threads = num_threads

    def begin_job(self) -> int:
        return self._lib.kvio_begin_job(self._handle)

    def seal_job(self, job_id: int) -> None:
        self._lib.kvio_seal_job(self._handle, job_id)

    @staticmethod
    def _buffer_address(buffer, writable: bool) -> tuple[int, int]:
        """(address, nbytes) of a C-contiguous numpy array without copying.
        The caller keeps the array alive until the job completes."""
        import numpy as np

        if not isinstance(buffer, np.ndarray):
            raise TypeError(f"unsupported buffer type: {type(buffer)!r}")
        if writable and not buffer.flags.writeable:
            raise ValueError("read destination must be writable")
        if not buffer.flags.c_contiguous:
            raise ValueError("buffer must be C-contiguous")
        return buffer.ctypes.data, buffer.nbytes

    def submit_write(self, job_id: int, path: str, tmp_path: str,
                     buffer, skip_if_exists: bool = True) -> bool:
        """Queue an atomic (tmp + rename) write of ``buffer``. Returns False
        when the write is shed by the queue limit."""
        failpoints.hit(FP_SUBMIT_WRITE)
        address, nbytes = self._buffer_address(buffer, writable=False)
        return bool(self._lib.kvio_submit_write(
            self._handle, job_id, path.encode(), tmp_path.encode(),
            address, nbytes, int(skip_if_exists),
        ))

    def submit_read(self, job_id: int, path: str, buffer, offset: int = 0) -> None:
        failpoints.hit(FP_SUBMIT_READ)
        address, nbytes = self._buffer_address(buffer, writable=True)
        self._lib.kvio_submit_read(
            self._handle, job_id, path.encode(), address, nbytes, offset,
        )

    def poll_finished(self, max_items: int = 64) -> list[tuple[int, int]]:
        ids = (ctypes.c_uint64 * max_items)()
        statuses = (ctypes.c_int * max_items)()
        n = self._lib.kvio_poll_finished(self._handle, ids, statuses, max_items)
        return [(ids[i], statuses[i]) for i in range(n)]

    def wait_job(self, job_id: int, timeout_s: float = 30.0) -> int:
        return self._lib.kvio_wait_job(self._handle, job_id, timeout_s)

    def numa_node(self) -> int:
        """Resolved NUMA node (-1 when unknown or placement disabled)."""
        return self._lib.kvio_numa_node(self._handle)

    def worker_cpus(self) -> list[int]:
        return [self._lib.kvio_worker_cpu(self._handle, i)
                for i in range(self.num_threads)]

    def pinned_staging_workers(self) -> int:
        """Workers whose staging buffer mlock succeeded."""
        return self._lib.kvio_pinned_staging_workers(self._handle)

    def direct_transfers(self) -> int:
        """Transfers that took the O_DIRECT staged path (vs buffered
        fallback)."""
        return self._lib.kvio_direct_transfers(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.kvio_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - gc timing
        self.close()


def file_exists(path: str, touch_atime: bool = False) -> bool:
    if failpoints.should_fire(FP_FILE_EXISTS):
        return False
    return bool(load_library().kvio_file_exists(path.encode(), int(touch_atime)))


def card_pci_bus_id(index: int) -> str:
    """The CUDA card's PCI address as sysfs names it (``0000:19:00.0``):
    from the device properties where the installed torch carries the PCI
    fields, else from ``nvidia-smi``."""
    import torch

    props = torch.cuda.get_device_properties(index)
    bus = getattr(props, "pci_bus_id", None)
    dev = getattr(props, "pci_device_id", None)
    if bus is not None and dev is not None:
        return f"{getattr(props, 'pci_domain_id', 0):04x}:{bus:02x}:{dev:02x}.0"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True, check=True)
    # nvidia-smi prints an 8-digit domain ("00000000:19:00.0").
    return out.stdout.strip().lower()[-12:]


def card_numa_node(device) -> int:
    """The ``numa_node`` to create a kvio engine with for pools on
    ``device``: :data:`NUMA_DISCOVER` when ``KVIO_NUMA_NODE`` is set (kvio
    reads it), the CUDA card's node from its sysfs entry when it has one,
    else :data:`NUMA_OFF` (a CPU device, or a host with one node)."""
    if os.environ.get("KVIO_NUMA_NODE") is not None:
        return NUMA_DISCOVER
    if device.type != "cuda":
        return NUMA_OFF
    bus_id = card_pci_bus_id(device.index or 0)
    try:
        node = int(Path(f"/sys/bus/pci/devices/{bus_id}/numa_node").read_text())
    except (OSError, ValueError):
        return NUMA_OFF
    return node if node >= 0 else NUMA_OFF
