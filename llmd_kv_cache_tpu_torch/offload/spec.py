"""Offload spec: the engine-facing configuration plugin.

Port of ``llmd_kv_cache_tpu/offload/spec.py``, the counterpart of reference
``llmd_fs_backend/spec.py``: one object that an engine loads from its
connector config to get (a) the scheduler-side manager and (b) the
worker-side handlers, wired consistently from a single fingerprinted
layout. Its fingerprint fields are the JAX spec's for a single-device
engine, so both packages resolve one store to the same directory.

With ``events_endpoint`` set, the manager publishes the tier's tokenless
BlockStored / BlockRemoved events through a ``StorageEventPublisher``
(medium in the pod slot), as the JAX spec wires it. Not ported: meshes
(tensor- and pipeline-parallel serving).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..resilience.policy import RetryPolicy
from ..events.publisher import StorageEventPublisher
from .cuda_copier import CUDABlockCopier
from .file_mapper import FileMapper, FileMapperConfig, mesh_fingerprint_fields
from .manager import SharedStorageOffloadManager
from .worker import OffloadHandlers


@dataclass
class SharedStorageOffloadSpec:
    """Builds the manager/handlers pair for shared-storage offload."""

    root: str
    model_name: str
    page_size: int = 16
    num_layers: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    dtype: str = "bfloat16"
    io_threads: int = 4
    read_preferring_ratio: float = 0.75
    max_write_queued_seconds: float = 10.0
    # Multi-block file geometry (reference spec.py:76-89): consecutive
    # blocks per file (1 = one content-addressed file per block) and fixed
    # pages per block slot.
    blocks_per_file: int = 1
    pages_per_block: int = 1
    # Hybrid attention geometry (enters the store fingerprint: files
    # written under one window/layer-split must not be resumed by another).
    sliding_window: Optional[int] = None
    swa_layers: tuple = ()
    # 1 for MLA latent stores (use cfg.kv_cache_heads/kv_cache_head_dim
    # for kv_heads/head_dim then); 2 for standard K+V.
    kv_streams: int = 2
    # StreamingLLM sinks (enters the store fingerprint: sink and
    # sink-free KV of the same model are byte-incompatible).
    attention_sinks: int = 0
    # End-to-end payload integrity: "crc32" (default) appends the per-slot
    # checksum footer verified on load; "none" writes bare payloads.
    # Fingerprinted either way.
    integrity: str = "crc32"
    # Transient-failure retry: attempts per offload job (1 disables retry)
    # and the base backoff delay (jittered exponential, resilience.policy).
    retry_attempts: int = 2
    retry_base_delay_s: float = 0.05
    rank: int = 0
    parallel_agnostic: bool = False
    events_endpoint: Optional[str] = None
    # Backend selection: "posix" (native kvio file engine) or "object"
    # (S3-style store via offload.object_store). For "object",
    # ``object_store_client`` may inject any ObjectStoreClient; default is
    # the directory-backed client at ``root``.
    backend: str = "posix"
    object_store_client: Optional[object] = None

    @property
    def medium(self) -> str:
        """Canonical medium name for events and metrics (the JAX
        publisher's ``SHARED_STORAGE`` / ``OBJECT_STORE``)."""
        return "OBJECT_STORE" if self.backend == "object" else "SHARED_STORAGE"

    @classmethod
    def from_extra_config(cls, extra: dict) -> "SharedStorageOffloadSpec":
        """Build from a connector-style extra-config dict (camelCase or
        snake_case keys accepted)."""
        def get(*names, default=None):
            for n in names:
                if n in extra:
                    return extra[n]
            return default

        return cls(
            root=get("root", "sharedStorageRoot", default="/tmp/kvtpu-offload"),
            model_name=get("modelName", "model_name", default="unknown"),
            page_size=get("pageSize", "page_size", default=16),
            num_layers=get("numLayers", "num_layers", default=32),
            kv_heads=get("kvHeads", "kv_heads", default=8),
            head_dim=get("headDim", "head_dim", default=128),
            dtype=get("dtype", default="bfloat16"),
            io_threads=get("ioThreads", "io_threads", default=4),
            read_preferring_ratio=get(
                "readPreferringRatio", "read_preferring_ratio", default=0.75
            ),
            max_write_queued_seconds=get(
                "maxWriteQueuedSeconds", "max_write_queued_seconds", default=10.0
            ),
            blocks_per_file=get("blocksPerFile", "blocks_per_file", default=1),
            pages_per_block=get("pagesPerBlock", "pages_per_block", default=1),
            sliding_window=get("slidingWindow", "sliding_window"),
            swa_layers=tuple(get("swaLayers", "swa_layers", default=()) or ()),
            kv_streams=get("kvStreams", "kv_streams", default=2),
            attention_sinks=get("attentionSinks", "attention_sinks",
                                default=0),
            integrity=get("integrity", default="crc32"),
            retry_attempts=get("retryAttempts", "retry_attempts", default=2),
            retry_base_delay_s=get(
                "retryBaseDelaySeconds", "retry_base_delay_s", default=0.05
            ),
            rank=get("rank", default=0),
            parallel_agnostic=get(
                "parallelAgnostic", "parallel_agnostic", default=False
            ),
            events_endpoint=get("eventsEndpoint", "events_endpoint"),
            backend=get("backend", default="posix"),
        )

    def build_mapper(self) -> FileMapper:
        return FileMapper(
            FileMapperConfig(
                root=self.root,
                model_name=self.model_name,
                dtype=self.dtype,
                page_size=self.page_size,
                kv_heads=self.kv_heads,
                head_dim=self.head_dim,
                num_layers=self.num_layers,
                pages_per_file=self.blocks_per_file,
                pages_per_block=self.pages_per_block,
                sliding_window=self.sliding_window,
                swa_layers=tuple(self.swa_layers),
                kv_streams=self.kv_streams,
                attention_sinks=self.attention_sinks,
                integrity=self.integrity,
                mesh_sizes=mesh_fingerprint_fields(),
                rank=self.rank,
                parallel_agnostic=self.parallel_agnostic,
            )
        )

    def _object_pieces(self):
        from .object_store import FSObjectStoreClient, ObjectKeyMapper

        client = (self.object_store_client if self.object_store_client is not None
                  else FSObjectStoreClient(self.root))
        mapper = ObjectKeyMapper(
            prefix="kv",
            fingerprint=self.build_mapper().fingerprint,
            rank=self.rank,
            parallel_agnostic=self.parallel_agnostic,
        )
        return client, mapper

    def _publisher(self, medium: str) -> Optional[StorageEventPublisher]:
        if not self.events_endpoint:
            return None
        return StorageEventPublisher(
            self.events_endpoint, self.model_name, medium=medium, bind=False
        )

    def get_manager(self):
        """Scheduler-side (rank 0) manager with optional event publishing."""
        if self.backend == "object":
            from .object_store import ObjectStoreOffloadManager

            client, mapper = self._object_pieces()
            return ObjectStoreOffloadManager(
                client, mapper,
                event_publisher=self._publisher(self.medium),
                block_size_tokens=self.page_size,
            )
        return SharedStorageOffloadManager(
            self.build_mapper(),
            self._publisher(self.medium),
            block_size_tokens=self.page_size,
        )

    def get_handlers(self, k_cache: torch.Tensor, v_cache: torch.Tensor):
        """Worker-side handlers bound to this worker's cache pools."""
        copier = CUDABlockCopier(k_cache, v_cache)
        # The fingerprint/config.json must describe the bytes the copier
        # actually moves — a misdeclared spec (e.g. an MLA engine left at
        # the kv_streams=2 default) would silently write files under
        # metadata for a different layout. Heads are checked as an upper
        # bound only, as in the JAX spec (per-shard heads under tp).
        layers, _, kv_heads, page_size, head_dim = k_cache.shape
        if (self.kv_streams != copier.streams
                or head_dim != self.head_dim
                or page_size != self.page_size
                or layers > self.num_layers
                or kv_heads > self.kv_heads):
            raise ValueError(
                f"offload spec geometry (streams={self.kv_streams}, "
                f"kv_heads={self.kv_heads}, head_dim={self.head_dim}, "
                f"page_size={self.page_size}, layers={self.num_layers}) "
                f"does not match the bound cache "
                f"(streams={copier.streams}, kv_heads={kv_heads}, "
                f"head_dim={head_dim}, page_size={page_size}, "
                f"layers={layers}); MLA engines must set kv_streams=1 and "
                "size kv_heads/head_dim from cfg.kv_cache_heads/"
                "cfg.kv_cache_head_dim")
        if self.backend == "object":
            from .object_store import ObjectStoreOffloadHandlers

            client, mapper = self._object_pieces()
            return ObjectStoreOffloadHandlers(
                copier, client, mapper, io_threads=self.io_threads,
                blocks_per_file=self.blocks_per_file,
                pages_per_block=self.pages_per_block,
            )
        return OffloadHandlers(
            copier,
            self.build_mapper(),
            io_threads=self.io_threads,
            read_preferring_ratio=self.read_preferring_ratio,
            max_write_queued_seconds=self.max_write_queued_seconds,
            blocks_per_file=self.blocks_per_file,
            pages_per_block=self.pages_per_block,
            retry_policy=RetryPolicy(
                max_attempts=max(1, self.retry_attempts),
                base_delay_s=self.retry_base_delay_s,
                max_delay_s=max(0.5, self.retry_base_delay_s * 10),
            ),
        )
