"""Native (C++) index backend and hash-chain fast path.

Port of ``llmd_kv_cache_tpu/index/native.py``: ctypes bindings for
``csrc/kvindex`` at the checkout root, a two-level-LRU index and the
FNV-64a/canonical-CBOR block-hash chain, both GIL-free. The C++ source is
the JAX package's own and stays untouched; this package compiles it itself,
with the Makefile's flags, into ``build/kvindex/<hash of source and
flags>/libkvindex.so`` at the checkout root, writing to a private name and
renaming (as ``offload/native.py`` builds ``csrc/kvio``), so concurrent
builders never race on one file. It is built at first use, never at import,
and a failed build raises with the compiler's output.

``NativeIndex`` implements the same Index contract as the Python backends;
the hash fast path serves ``ChunkedTokenDatabase`` for text-only blocks
(multimodal-tainted blocks take the Python encoder).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..core.keys import BlockHash, KeyType, PodEntry
from ..utils.lockdep import new_lock
from .base import Index

_ROOT = Path(__file__).resolve().parents[2]
CSRC = _ROOT / "csrc" / "kvindex"
BUILD_ROOT = _ROOT / "build" / "kvindex"
SOURCE = "kvindex.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_build_lock = new_lock()
_lib: Optional[ctypes.CDLL] = None

_FLAG_SPECULATIVE = 1
_FLAG_HAS_GROUP = 2


def build() -> Path:
    """Compile ``libkvindex.so`` unless this source hash is built; its path."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256()
    h.update(SOURCE.encode())
    h.update((CSRC / SOURCE).read_bytes())
    h.update(" ".join((cxx, *CXX_FLAGS)).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libkvindex.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", tmp, str(CSRC / SOURCE)],
                capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(
                f"building kvindex failed: cannot run the compiler {cxx!r} "
                f"({e})") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building kvindex failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) the kvindex shared library."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)

        lib.kvhash_init.restype = ctypes.c_uint64
        lib.kvhash_init.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.kvhash_chain.restype = ctypes.c_int
        lib.kvhash_chain.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
            ctypes.c_int, u64p,
        ]
        lib.kvidx_create.restype = ctypes.c_void_p
        lib.kvidx_create.argtypes = [ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64]
        lib.kvidx_destroy.argtypes = [ctypes.c_void_p]
        lib.kvidx_intern.restype = ctypes.c_int32
        lib.kvidx_intern.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.kvidx_get_string.restype = ctypes.c_int
        lib.kvidx_get_string.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int
        ]
        lib.kvidx_add.argtypes = [
            ctypes.c_void_p, u64p, ctypes.c_int, u64p, ctypes.c_int,
            i32p, i32p, u8p, i32p, ctypes.c_int,
        ]
        lib.kvidx_lookup.restype = ctypes.c_int
        lib.kvidx_lookup.argtypes = [
            ctypes.c_void_p, u64p, ctypes.c_int, i32p, ctypes.c_int,
            i32p, i32p, ctypes.c_int,
        ]
        lib.kvidx_evict.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            i32p, i32p, u8p, i32p, ctypes.c_int,
        ]
        lib.kvidx_get_request_key.restype = ctypes.c_uint64
        lib.kvidx_get_request_key.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.kvidx_clear.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.kvidx_len.restype = ctypes.c_uint64
        lib.kvidx_len.argtypes = [ctypes.c_void_p]
        lib.kvidx_score.restype = ctypes.c_int
        lib.kvidx_score.argtypes = [
            ctypes.c_void_p, u64p, ctypes.c_int, i32p, ctypes.c_int,
            i32p, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            i32p, ctypes.POINTER(ctypes.c_double), ctypes.c_int, i32p,
        ]
        lib.kvidx_score_ex.restype = ctypes.c_int
        lib.kvidx_score_ex.argtypes = lib.kvidx_score.argtypes + [ctypes.c_int]
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.kvidx_score_chunked.restype = ctypes.c_int
        lib.kvidx_score_chunked.argtypes = [
            ctypes.c_void_p, u64p, ctypes.c_int,  # keys
            i32p, ctypes.c_int,                   # filter pods
            i32p, f64p, ctypes.c_int,             # tier weights
            ctypes.c_int,                         # chunk_size
            i32p, i32p, u8p, ctypes.c_int,        # residency claims
            ctypes.c_double, ctypes.c_double, ctypes.c_double,  # weights
            i32p, f64p, ctypes.c_int, i32p,       # out pods/scores/cap/hits
            i32p, i32p,                           # out chunks / early_exit
            i32p, f64p, ctypes.c_int, i32p,       # out residency
        ]
        lib.kvidx_map_len.restype = ctypes.c_uint64
        lib.kvidx_map_len.argtypes = [ctypes.c_void_p]
        lib.kvidx_dump.restype = ctypes.c_int
        lib.kvidx_dump.argtypes = [
            ctypes.c_void_p, u64p, i32p, ctypes.c_int, i32p, ctypes.c_int,
        ]
        lib.kvidx_dump_mappings.restype = ctypes.c_int
        lib.kvidx_dump_mappings.argtypes = [
            ctypes.c_void_p, u64p, i32p, ctypes.c_int, u64p, ctypes.c_int,
        ]
        lib.kvidx_set_mapping.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, u64p, ctypes.c_int,
        ]

        _lib = lib
        return _lib


_load_failed = False


def native_available() -> bool:
    """True when the native library loads; a failed build is cached so
    callers don't re-spawn the compiler per call. Nothing on the port's
    serving path uses this to fall back: ``IndexConfig.default`` and the
    token processor load the library and let a failed build raise."""
    global _load_failed
    if _load_failed:
        return False
    try:
        load_library()
        return True
    except Exception:
        _load_failed = True
        return False


# -- hash-chain fast path ---------------------------------------------------


def hash_init(seed: str, model: str) -> int:
    return load_library().kvhash_init(seed.encode(), model.encode())


def hash_chain(parent: int, tokens: Sequence[int], block_size: int) -> list[int]:
    """Chain-hash full text-only blocks natively."""
    return hash_chain_with_array(parent, tokens, block_size)[0]


def hash_chain_with_array(
    parent: int, tokens: Sequence[int], block_size: int
) -> tuple[list[int], np.ndarray]:
    """Chain-hash natively, returning the keys both as a list and as the
    ``uint64`` array the C++ call produced — callers that feed the keys
    straight back into ``NativeIndex.score`` (the fused score path) keep
    the array and skip a per-call ``asarray`` over thousands of keys."""
    lib = load_library()
    arr = np.asarray(tokens, np.uint32)
    n_blocks = len(arr) // block_size
    if n_blocks == 0:
        return [], np.empty(0, np.uint64)
    out = np.empty(n_blocks, np.uint64)
    n = lib.kvhash_chain(
        ctypes.c_uint64(parent & 0xFFFFFFFFFFFFFFFF),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(arr), block_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    out = out[:n]
    return [int(h) for h in out], out


# -- native index -----------------------------------------------------------


@dataclass
class NativeIndexConfig:
    size: int = 10**8
    pod_cache_size: int = 10
    mapping_size: int = 10**8

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "NativeIndexConfig":
        if not d:
            return cls()
        return cls(
            size=d.get("size", 10**8) or 10**8,
            pod_cache_size=d.get("podCacheSize", d.get("pod_cache_size", 10)) or 10,
            mapping_size=d.get("mappingSize", d.get("mapping_size", 10**8)) or 10**8,
        )


class NativeIndex(Index):
    """C++-backed Index implementation."""

    def __init__(self, cfg: Optional[NativeIndexConfig] = None):
        cfg = cfg or NativeIndexConfig()
        self._lib = load_library()
        self._handle = self._lib.kvidx_create(cfg.size, cfg.pod_cache_size,
                                              cfg.mapping_size)
        if not self._handle:
            raise RuntimeError("failed to create native index")
        # Mirror of the native intern table (id → string), filled lazily.
        self._interned: dict[str, int] = {}
        self._strings: dict[int, str] = {}
        self._intern_lock = new_lock()
        self._lookup_cap = 4096  # entries; grown on demand
        # PodEntry is frozen/immutable: memoize by packed tuple so lookups
        # reuse objects instead of re-materializing identical entries.
        self._entry_cache: dict[tuple[int, int, int, int], PodEntry] = {}

    def _intern(self, s: str) -> int:
        with self._intern_lock:
            sid = self._interned.get(s)
            if sid is None:
                sid = self._lib.kvidx_intern(self._handle, s.encode())
                self._interned[s] = sid
                self._strings[sid] = s
            return sid

    def _resolve(self, sid: int) -> str:
        s = self._strings.get(sid)
        if s is not None:
            return s
        buf = ctypes.create_string_buffer(512)
        n = self._lib.kvidx_get_string(self._handle, sid, buf, 512)
        s = buf.value.decode() if n >= 0 else ""
        with self._intern_lock:
            self._strings[sid] = s
        return s

    def _pack_entries(self, entries: Sequence[PodEntry]):
        n = len(entries)
        pods = np.empty(n, np.int32)
        tiers = np.empty(n, np.int32)
        flags = np.empty(n, np.uint8)
        groups = np.empty(n, np.int32)
        for i, e in enumerate(entries):
            pods[i] = self._intern(e.pod_identifier)
            tiers[i] = self._intern(e.device_tier)
            flags[i] = (_FLAG_SPECULATIVE if e.speculative else 0) | (
                _FLAG_HAS_GROUP if e.has_group else 0
            )
            groups[i] = e.group_idx
        return pods, tiers, flags, groups

    @staticmethod
    def _keys_array(keys: Sequence[BlockHash]) -> np.ndarray:
        try:
            return np.asarray(keys, np.uint64)
        except (OverflowError, TypeError, ValueError):
            return np.asarray([k & 0xFFFFFFFFFFFFFFFF for k in keys], np.uint64)

    # Zero-copy ingest marker (events.pool packed path): keys may arrive
    # as numpy uint64 views and flow to the C side without materializing
    # per-element Python ints.
    accepts_key_arrays = True

    def add(self, engine_keys, request_keys, entries) -> None:
        # len()-based emptiness: request_keys may be a numpy view, whose
        # truth value is ambiguous for more than one element.
        if request_keys is None or len(request_keys) == 0 or not entries:
            raise ValueError("no keys or entries provided for adding to index")
        rk = self._keys_array(request_keys)
        ek = (self._keys_array(engine_keys)
              if engine_keys is not None and len(engine_keys)
              else np.empty(0, np.uint64))
        pods, tiers, flags, groups = self._pack_entries(entries)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._lib.kvidx_add(
            self._handle,
            ek.ctypes.data_as(u64p), len(ek),
            rk.ctypes.data_as(u64p), len(rk),
            pods.ctypes.data_as(i32p), tiers.ctypes.data_as(i32p),
            flags.ctypes.data_as(u8p), groups.ctypes.data_as(i32p),
            len(entries),
        )

    def lookup(self, request_keys, pod_identifier_set=None):
        if not request_keys:
            raise ValueError("no request_keys provided for lookup")
        keys = self._keys_array(request_keys)
        if pod_identifier_set:
            filt = np.asarray(
                [self._intern(p) for p in pod_identifier_set], np.int32
            )
        else:
            filt = np.empty(0, np.int32)
        counts = np.zeros(len(keys), np.int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        while True:
            out = np.empty(self._lookup_cap * 4, np.int32)
            total = self._lib.kvidx_lookup(
                self._handle,
                keys.ctypes.data_as(u64p), len(keys),
                filt.ctypes.data_as(i32p), len(filt),
                counts.ctypes.data_as(i32p),
                out.ctypes.data_as(i32p), len(out),
            )
            if total >= 0:
                break
            self._lookup_cap *= 2

        result: dict[BlockHash, list[PodEntry]] = {}
        flat = out[: total * 4].tolist()
        entry_cache = self._entry_cache
        pos = 0
        for i, key in enumerate(request_keys):
            c = int(counts[i])
            if c == 0:
                continue
            entries = []
            for j in range(pos, pos + c):
                packed = tuple(flat[j * 4:j * 4 + 4])
                entry = entry_cache.get(packed)
                if entry is None:
                    pod, tier, fl, group = packed
                    entry = PodEntry(
                        pod_identifier=self._resolve(pod),
                        device_tier=self._resolve(tier),
                        speculative=bool(fl & _FLAG_SPECULATIVE),
                        has_group=bool(fl & _FLAG_HAS_GROUP),
                        group_idx=group,
                    )
                    entry_cache[packed] = entry
                entries.append(entry)
            result[key] = entries
            pos += c
        return result

    def evict(self, key, key_type, entries) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        self.evict_batch([key], key_type, entries)

    def evict_batch(self, keys, key_type, entries) -> None:
        """Evict many keys with one entry-packing/interning pass."""
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        pods, tiers, flags, groups = self._pack_entries(entries)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        is_engine = 1 if key_type is KeyType.ENGINE else 0
        for key in keys:
            self._lib.kvidx_evict(
                self._handle,
                ctypes.c_uint64(key & 0xFFFFFFFFFFFFFFFF),
                is_engine,
                pods.ctypes.data_as(i32p), tiers.ctypes.data_as(i32p),
                flags.ctypes.data_as(u8p), groups.ctypes.data_as(i32p),
                len(entries),
            )

    def score(
        self,
        request_keys: Sequence[BlockHash],
        medium_weights: dict[str, float],
        pod_identifier_set=None,
        early_exit: bool = False,
    ) -> tuple[dict[str, float], int]:
        """Fused lookup + longest-prefix tier-weighted scoring in C++.

        Exactly equivalent to ``LongestPrefixScorer.score`` over
        ``lookup`` (shared equivalence tests), without materializing any
        PodEntry objects. Returns ``(scores, hit_count)`` where hit_count
        is the Lookup-equivalent number of resident keys (telemetry).
        The scan also refreshes LRU recency like a lookup would.

        ``early_exit=True`` stops the C++ scan once the prefix chain broke:
        identical scores, but hit_count only covers the scanned prefix and
        post-gap blocks are not LRU-refreshed.
        """
        if len(request_keys) == 0:  # len() so ndarray keys are accepted
            return {}, 0
        keys = self._keys_array(request_keys)
        if pod_identifier_set:
            filt = np.asarray([self._intern(p) for p in pod_identifier_set], np.int32)
        else:
            filt = np.empty(0, np.int32)
        wt = np.asarray([self._intern(t) for t in medium_weights], np.int32)
        wv = np.asarray(list(medium_weights.values()), np.float64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        hits = np.zeros(1, np.int32)
        cap = 1024
        while True:
            out_pods = np.empty(cap, np.int32)
            out_scores = np.empty(cap, np.float64)
            n = self._lib.kvidx_score_ex(
                self._handle,
                keys.ctypes.data_as(u64p), len(keys),
                filt.ctypes.data_as(i32p), len(filt),
                wt.ctypes.data_as(i32p), wv.ctypes.data_as(f64p), len(wt),
                out_pods.ctypes.data_as(i32p), out_scores.ctypes.data_as(f64p),
                cap, hits.ctypes.data_as(i32p),
                1 if early_exit else 0,
            )
            if n >= 0:
                break
            cap = -n  # buffer too small: exact needed size reported
        return (
            {
                self._resolve(int(out_pods[i])): float(out_scores[i])
                for i in range(n)
            },
            int(hits[0]),
        )

    def score_chunked(
        self,
        request_keys: Sequence[BlockHash],
        medium_weights: dict[str, float],
        pod_identifier_set=None,
        chunk_size: int = 0,
        claims: Optional[Sequence[tuple[str, int, bool]]] = None,
        landed_weight: float = 1.0,
        in_flight_discount: float = 0.5,
        tier_discount: float = 1.0,
    ) -> tuple[dict[str, float], int, dict[str, float], dict[str, int]]:
        """Chunked fused scoring with residency fold-in: the whole score
        data plane — early-exit chunked lookup, tier-weighted prefix
        scoring, and the per-pod consecutive-from-0 residency walk — in
        ONE ctypes crossing and one native lock hold.

        ``chunk_size`` mirrors the Python ``lookup_chunked`` granularity:
        the scan stops at the first chunk boundary after the prefix chain
        broke (0 scans everything). ``claims`` are sparse
        ``(pod, key_index, landed)`` rows from
        :meth:`~..scoring.residency.ResidencyTracker.claim_rows`.

        Returns ``(scores, hit_count, residency_bonus, stats)`` where
        ``scores`` are the BASE prefix scores (bonus not folded in — the
        caller applies liveness weighting to the base first, exactly like
        the unfused path), ``residency_bonus`` is pod → bonus, and
        ``stats`` carries ``chunks`` scanned and ``early_exited``.
        """
        empty_stats = {"chunks": 0, "early_exited": 0}
        if len(request_keys) == 0:  # len() so ndarray keys are accepted
            return {}, 0, {}, empty_stats
        keys = self._keys_array(request_keys)
        if pod_identifier_set:
            filt = np.asarray(
                [self._intern(p) for p in pod_identifier_set], np.int32
            )
        else:
            filt = np.empty(0, np.int32)
        wt = np.asarray([self._intern(t) for t in medium_weights], np.int32)
        wv = np.asarray(list(medium_weights.values()), np.float64)

        n_claims = len(claims) if claims else 0
        claim_pods = np.empty(n_claims, np.int32)
        claim_idx = np.empty(n_claims, np.int32)
        claim_landed = np.empty(n_claims, np.uint8)
        res_cap = 0
        if n_claims:
            distinct: set[str] = set()
            for i, (pod, idx, landed) in enumerate(claims):
                claim_pods[i] = self._intern(pod)
                claim_idx[i] = idx
                claim_landed[i] = 1 if landed else 0
                distinct.add(pod)
            res_cap = len(distinct)
        res_pods = np.empty(max(res_cap, 1), np.int32)
        res_bonus = np.empty(max(res_cap, 1), np.float64)

        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        hits = np.zeros(1, np.int32)
        chunks = np.zeros(1, np.int32)
        early = np.zeros(1, np.int32)
        res_n = np.zeros(1, np.int32)
        cap = 1024
        while True:
            out_pods = np.empty(cap, np.int32)
            out_scores = np.empty(cap, np.float64)
            n = self._lib.kvidx_score_chunked(
                self._handle,
                keys.ctypes.data_as(u64p), len(keys),
                filt.ctypes.data_as(i32p), len(filt),
                wt.ctypes.data_as(i32p), wv.ctypes.data_as(f64p), len(wt),
                int(chunk_size),
                claim_pods.ctypes.data_as(i32p),
                claim_idx.ctypes.data_as(i32p),
                claim_landed.ctypes.data_as(u8p), n_claims,
                float(landed_weight), float(in_flight_discount),
                float(tier_discount),
                out_pods.ctypes.data_as(i32p),
                out_scores.ctypes.data_as(f64p), cap,
                hits.ctypes.data_as(i32p),
                chunks.ctypes.data_as(i32p),
                early.ctypes.data_as(i32p),
                res_pods.ctypes.data_as(i32p),
                res_bonus.ctypes.data_as(f64p), res_cap,
                res_n.ctypes.data_as(i32p),
            )
            if n >= 0:
                break
            cap = -n  # buffer too small: exact needed size reported
        return (
            {
                self._resolve(int(out_pods[i])): float(out_scores[i])
                for i in range(n)
            },
            int(hits[0]),
            {
                self._resolve(int(res_pods[i])): float(res_bonus[i])
                for i in range(int(res_n[0]))
            },
            {"chunks": int(chunks[0]), "early_exited": int(early[0])},
        )

    def get_request_key(self, engine_key):
        rk = self._lib.kvidx_get_request_key(
            self._handle, ctypes.c_uint64(engine_key & 0xFFFFFFFFFFFFFFFF)
        )
        return int(rk) if rk != 0 else None

    def clear(self, pod_identifier: str) -> None:
        self._lib.kvidx_clear(self._handle, self._intern(pod_identifier))

    # -- snapshot capability (recovery/) --

    def dump_state(self) -> dict:
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        key_cap = max(int(self._lib.kvidx_len(self._handle)), 1) + 64
        entry_cap = key_cap * 16
        while True:
            keys = np.empty(key_cap, np.uint64)
            counts = np.empty(key_cap, np.int32)
            packed = np.empty(entry_cap * 4, np.int32)
            nk = self._lib.kvidx_dump(
                self._handle,
                keys.ctypes.data_as(u64p), counts.ctypes.data_as(i32p), key_cap,
                packed.ctypes.data_as(i32p), entry_cap,
            )
            if nk >= 0:
                break
            # Concurrent growth between the len() sizing and the dump.
            key_cap *= 2
            entry_cap *= 2
        entries: list = []
        pos = 0
        flat = packed.tolist()
        for i in range(nk):
            c = int(counts[i])
            rows = [
                [
                    self._resolve(flat[j * 4]),
                    self._resolve(flat[j * 4 + 1]),
                    flat[j * 4 + 2],
                    flat[j * 4 + 3],
                ]
                for j in range(pos, pos + c)
            ]
            entries.append([int(keys[i]), rows])
            pos += c

        map_cap = max(int(self._lib.kvidx_map_len(self._handle)), 1) + 64
        rk_cap = map_cap * 8
        while True:
            eks = np.empty(map_cap, np.uint64)
            mcounts = np.empty(map_cap, np.int32)
            rks = np.empty(rk_cap, np.uint64)
            nm = self._lib.kvidx_dump_mappings(
                self._handle,
                eks.ctypes.data_as(u64p), mcounts.ctypes.data_as(i32p), map_cap,
                rks.ctypes.data_as(u64p), rk_cap,
            )
            if nm >= 0:
                break
            map_cap *= 2
            rk_cap *= 2
        mappings: list = []
        pos = 0
        for i in range(nm):
            c = int(mcounts[i])
            mappings.append(
                [int(eks[i]), [int(rk) for rk in rks[pos:pos + c]]]
            )
            pos += c
        return {"entries": entries, "mappings": mappings}

    def restore_state(self, state: dict) -> int:
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        # Group request keys sharing an identical entry set so each group
        # restores with one native call (the common case: thousands of
        # keys all held by the same pod+tier).
        groups: dict[tuple, list[int]] = {}
        for request_key, rows in state.get("entries", []):
            if rows:
                groups.setdefault(
                    tuple(tuple(r) for r in rows), []
                ).append(request_key)
        restored = 0
        empty_ek = np.empty(0, np.uint64)
        for rows, request_keys in groups.items():
            n = len(rows)
            pods = np.empty(n, np.int32)
            tiers = np.empty(n, np.int32)
            flags = np.empty(n, np.uint8)
            group_idx = np.empty(n, np.int32)
            for i, (pod, tier, fl, g) in enumerate(rows):
                pods[i] = self._intern(pod)
                tiers[i] = self._intern(tier)
                flags[i] = fl
                group_idx[i] = g
            rka = self._keys_array(request_keys)
            self._lib.kvidx_add(
                self._handle,
                empty_ek.ctypes.data_as(u64p), 0,
                rka.ctypes.data_as(u64p), len(rka),
                pods.ctypes.data_as(i32p), tiers.ctypes.data_as(i32p),
                flags.ctypes.data_as(u8p), group_idx.ctypes.data_as(i32p),
                n,
            )
            restored += n * len(request_keys)
        # Mappings restore through the dedicated call: kvidx_add with no
        # entries would create empty PodSlots, which Lookup treats as
        # broken prefix chains.
        for engine_key, rks in state.get("mappings", []):
            rka = self._keys_array(rks)
            self._lib.kvidx_set_mapping(
                self._handle,
                ctypes.c_uint64(engine_key & 0xFFFFFFFFFFFFFFFF),
                rka.ctypes.data_as(u64p), len(rka),
            )
        return restored

    def __len__(self) -> int:
        return int(self._lib.kvidx_len(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.kvidx_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:  # best-effort __del__ cleanup  # lint: allow-swallow
            pass
