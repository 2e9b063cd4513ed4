"""Build and load the Hopper kernels in ``llmd_kv_cache_tpu_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` process per
source, all started together, and link into one shared library with a plain
C interface, which is loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library lands in ``build/kernels/<hash>/`` at the
checkout root, keyed by a hash of the sources, the headers and the flags,
and is built at first use — never at import, so the CPU-only tests import
every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("paged_attention.cu", "latent_attention.cu")
HEADERS = ("attention_common.cuh", "hopper_common.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless this source hash is already built.

    Returns the library path. The compiler's register/shared-memory report
    (``-Xptxas -v``) of every source is kept beside it as ``ptxas.log``.
    """
    out_dir = build_dir()
    lib_path = out_dir / "libllmd_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename: concurrent builders never load
    # a half-written library.
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src}.o"), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in SOURCES]
        logs = [(src, proc.communicate()[0], proc.returncode) for src, proc in procs]
        failed = [f"{src} ({rc}):\n{log}" for src, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = work / "lib.so"
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(work / f"{src}.o") for src in SOURCES)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        (out_dir / "ptxas.log").write_text("".join(log for _, log, _ in logs))
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # The GQA kernels' entry points over bf16 and over fp8 pools.
            for kv in ("bf16", "fp8"):
                for name, args in (
                        ("decode", [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f,
                                    i, p, p]),
                        ("prefill", [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]),
                        ("ragged", [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                    i, f, i, p, p])):
                    fn = getattr(lib, f"llmd_paged_{name}_{kv}")
                    fn.argtypes = args
                    fn.restype = i
            lib.llmd_ragged_tile_tokens.argtypes = [i]
            lib.llmd_ragged_tile_tokens.restype = i
            lib.llmd_ragged_decode_tokens.argtypes = [i]
            lib.llmd_ragged_decode_tokens.restype = i
            lib.llmd_ragged_tile_slots.argtypes = [i, i, i, i]
            lib.llmd_ragged_tile_slots.restype = i
            lib.llmd_decode_chunk_keys.argtypes = []
            lib.llmd_decode_chunk_keys.restype = i
            lib.llmd_decode_workspace_bytes.argtypes = [i, i, i, i]
            lib.llmd_decode_workspace_bytes.restype = ctypes.c_longlong
            lib.llmd_latent_decode_bf16.argtypes = [
                p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, p, p]
            lib.llmd_latent_decode_bf16.restype = i
            lib.llmd_latent_decode_chunk_keys.argtypes = []
            lib.llmd_latent_decode_chunk_keys.restype = i
            lib.llmd_latent_decode_ctas_per_sm.argtypes = []
            lib.llmd_latent_decode_ctas_per_sm.restype = i
            lib.llmd_latent_decode_workspace_bytes.argtypes = [i, i, i]
            lib.llmd_latent_decode_workspace_bytes.restype = ctypes.c_longlong
            lib.llmd_latent_prefill_bf16.argtypes = [
                p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, p, p]
            lib.llmd_latent_prefill_bf16.restype = i
            lib.llmd_latent_prefill_tile_tokens.argtypes = [i]
            lib.llmd_latent_prefill_tile_tokens.restype = i
            lib.llmd_latent_prefill_chunk_keys.argtypes = [i]
            lib.llmd_latent_prefill_chunk_keys.restype = i
            lib.llmd_latent_prefill_workspace_bytes.argtypes = [i, i, i, i, i]
            lib.llmd_latent_prefill_workspace_bytes.restype = ctypes.c_longlong
            lib.llmd_latent_ragged_bf16.argtypes = [
                p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, i, p, p]
            lib.llmd_latent_ragged_bf16.restype = i
            lib.llmd_latent_ragged_workspace_bytes.argtypes = [i, i, i, i, i]
            lib.llmd_latent_ragged_workspace_bytes.restype = ctypes.c_longlong
            _lib = lib
        return _lib
