"""Deterministic on-disk layout for offloaded KV blocks.

Copy of ``llmd_kv_cache_tpu/offload/file_mapper.py`` (the same paths,
fingerprints and ``config.json`` bytes, so both packages share one store),
with its own single-device :func:`mesh_fingerprint_fields`.

Counterpart of reference ``llmd_fs_backend/file_mapper.py``: content-
addressed ``.bin`` files under a model+config-fingerprinted directory so
cache state survives engine restarts and is shared only between
identically-configured deployments.

Layout:
``<root>/<safe_model>_<fp12>/config.json``          (shared metadata)
``<root>/<safe_model>_<fp12>_r<rank>/<hhh>/<hh>_g<group>/<block_hash16>.bin``

The fingerprint covers the model, dtype, KV geometry, engine id and the
**mesh axis world sizes** (tp/pp/dp/sp) — the TPU-native equivalent of the
reference's ``tp/pp/pcp/dcp`` fields (``file_mapper.py:63-74``): blocks
written by a TP=4 deployment must not be read by a TP=8 one.
``parallel_agnostic`` collapses the rank dimension for single-host caches.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Optional

from ..utils.atomic_io import atomic_write_bytes


def mesh_fingerprint_fields() -> dict[str, int]:
    """Mesh-axis world sizes for the fingerprint of a single-device engine:
    every axis 1, as the JAX package's ``parallel.mesh`` gives for no mesh.
    (Tensor- and pipeline-parallel serving are not ported.)"""
    return {"tp_size": 1, "pp_size": 1, "dp_size": 1, "sp_size": 1}


@dataclass
class FileMapperConfig:
    root: str
    model_name: str
    dtype: str = "bfloat16"
    page_size: int = 16
    kv_heads: int = 8
    head_dim: int = 128
    num_layers: int = 32
    pages_per_file: int = 1   # blocks (slots) per file
    pages_per_block: int = 1  # pages per slot — fixes the slot byte size
    # Hybrid attention geometry: per-group file contents depend on the
    # window size and the full/SWA layer split, so both enter the
    # fingerprint (when set) — a redeploy with a different window must not
    # resume from the old run's KV.
    sliding_window: Optional[int] = None
    swa_layers: tuple = ()
    # Streams per slab: 2 (K,V) for standard attention, 1 for MLA (the
    # latent IS the payload; there is no V stream).
    kv_streams: int = 2
    # StreamingLLM sinks: the sink mask changes deeper layers' KV for
    # positions past the window, so stores written with and without sinks
    # are byte-incompatible and must not share a directory.
    attention_sinks: int = 0
    # End-to-end integrity of the file payload: "crc32" appends a per-slot
    # CRC32 footer (resilience.integrity) verified on load; "none" writes
    # the bare payload. Fingerprinted: footer-bearing and bare files must
    # never share a directory, or readers would mis-size every load.
    integrity: str = "crc32"
    engine: str = "kvtpu"
    mesh_sizes: dict[str, int] = field(default_factory=mesh_fingerprint_fields)
    rank: int = 0
    parallel_agnostic: bool = False


class FileMapper:
    """Maps block hashes to file paths."""

    def __init__(self, cfg: FileMapperConfig):
        self.cfg = cfg
        self._fingerprint = self._compute_fingerprint()
        safe_model = "".join(
            c if c.isalnum() or c in "-_." else "_" for c in cfg.model_name
        )
        self._base = os.path.join(cfg.root, f"{safe_model}_{self._fingerprint}")
        if cfg.parallel_agnostic:
            self._rank_dir = self._base
        else:
            self._rank_dir = f"{self._base}_r{cfg.rank}"

    def _compute_fingerprint(self) -> str:
        c = self.cfg
        payload = {
            "model": c.model_name,
            "dtype": c.dtype,
            "page_size": c.page_size,
            "kv_heads": c.kv_heads,
            "head_dim": c.head_dim,
            "num_layers": c.num_layers,
            "pages_per_file": c.pages_per_file,
            # Slab byte order: [layers, 2, pages, kv_heads, page_size, hd]
            # (heads-major pages — the Mosaic-tileable cache layout). Keyed
            # so stores written under the older page_size-major layout
            # resolve to a different directory instead of mixing formats.
            "kv_layout": "nkpd",
            # Only when non-default: a (N,1) store's on-disk layout is
            # byte-identical to the pre-pages_per_block format, and existing
            # deployments must keep resolving to the same directory.
            **({"pages_per_block": c.pages_per_block}
               if c.pages_per_block != 1 else {}),
            **({"sliding_window": c.sliding_window,
                "swa_layers": sorted(c.swa_layers)}
               if c.sliding_window is not None else {}),
            # Only when non-default (MLA's single latent stream): existing
            # two-stream deployments keep resolving to the same directory.
            **({"kv_streams": c.kv_streams} if c.kv_streams != 2 else {}),
            **({"attention_sinks": c.attention_sinks}
               if c.attention_sinks else {}),
            # Only when enabled (the default): checksummed and bare formats
            # differ in file size, so they must hash apart; "none" keeps
            # resolving wherever pre-integrity deployments wrote.
            **({"integrity": c.integrity} if c.integrity != "none" else {}),
            "engine": c.engine,
            **({k: v for k, v in sorted(c.mesh_sizes.items())}
               if not c.parallel_agnostic else {}),
        }
        digest = hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()
        ).hexdigest()
        return digest[:12]

    @property
    def fingerprint(self) -> str:
        return self._fingerprint

    @property
    def base_dir(self) -> str:
        return self._rank_dir

    def config_path(self) -> str:
        return os.path.join(self._base, "config.json")

    def write_run_config(self) -> None:
        """Persist the run metadata next to the store (idempotent)."""
        os.makedirs(self._base, exist_ok=True)
        path = self.config_path()
        if os.path.exists(path):
            return
        c = self.cfg
        # Durable publish (atomic_io): a crash right after os.replace must
        # not leave a zero-length/partial config — loaders treat a corrupt
        # config.json as a foreign store and refuse to serve it.
        atomic_write_bytes(
            path,
            json.dumps(
                {
                    "model": c.model_name,
                    "dtype": c.dtype,
                    "page_size": c.page_size,
                    "kv_heads": c.kv_heads,
                    "head_dim": c.head_dim,
                    "num_layers": c.num_layers,
                    "pages_per_file": c.pages_per_file,
                    "pages_per_block": c.pages_per_block,
                    "kv_layout": "nkpd",
                    "kv_streams": c.kv_streams,
                    "attention_sinks": c.attention_sinks,
                    "integrity": c.integrity,
                    "engine": c.engine,
                    "mesh_sizes": c.mesh_sizes,
                    "fingerprint": self._fingerprint,
                },
                indent=2,
            ).encode("utf-8"),
        )

    def block_path(self, block_hash: int, group_idx: int = 0) -> str:
        """Path of the file holding a block (hash masked to 64 bits).

        Two-level hex bucketing keeps directory fanout bounded at scale
        (reference ``file_mapper.py:112-143``).
        """
        h = block_hash & 0xFFFFFFFFFFFFFFFF
        hex16 = f"{h:016x}"
        return os.path.join(
            self._rank_dir, hex16[:3], f"{hex16[3:5]}_g{group_idx}", f"{hex16}.bin"
        )

    def tmp_path(self, block_hash: int, group_idx: int = 0,
                 unique_suffix: Optional[str] = None) -> str:
        """Unique temp path beside the final file for atomic rename."""
        suffix = unique_suffix if unique_suffix is not None else str(os.getpid())
        return self.block_path(block_hash, group_idx) + f".tmp.{suffix}"

    @staticmethod
    def parse_block_path(path: str) -> Optional[tuple[int, int]]:
        """Reverse mapping for the evictor: path → (block_hash, group_idx)."""
        name = os.path.basename(path)
        if not name.endswith(".bin"):
            return None
        try:
            block_hash = int(name[:-4], 16)
        except ValueError:
            return None
        parent = os.path.basename(os.path.dirname(path))
        group_idx = 0
        if "_g" in parent:
            try:
                group_idx = int(parent.split("_g")[-1])
            except ValueError:
                group_idx = 0
        return block_hash, group_idx
