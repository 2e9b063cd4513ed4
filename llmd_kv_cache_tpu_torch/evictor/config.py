"""Evictor configuration (env-var driven, like reference ``config.py:26-73``).

Copy of ``llmd_kv_cache_tpu/evictor/config.py``."""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class EvictorConfig:
    # Root of the offload store (the FileMapper root).
    store_root: str = "/mnt/kv-store"
    # Deletion turns ON when disk usage crosses this fraction...
    cleanup_threshold: float = 0.85
    # ...and OFF once usage falls below this fraction (hysteresis,
    # reference config.py:32-34).
    target_threshold: float = 0.70
    # Files accessed within this window are never deleted (seconds).
    min_idle_seconds: float = 3600.0
    # Crawler parallelism: the 16 hex buckets are partitioned across crawlers.
    num_crawlers: int = 2
    # Files deleted per batch (reference deleter.py batch of 100).
    delete_batch_size: int = 100
    # Disk-usage poll interval.
    poll_interval_s: float = 5.0
    # Empty bucket directories older than this are removed (folder cleaner).
    empty_dir_ttl_s: float = 600.0
    # ZMQ endpoint for storage BlockRemoved events (None disables).
    storage_events_endpoint: str | None = None
    # Model name used in the event topic.
    model_name: str = "unknown"

    @classmethod
    def from_env(cls, env: dict | None = None) -> "EvictorConfig":
        e = env if env is not None else os.environ
        return cls(
            store_root=e.get("KVTPU_EVICTOR_STORE_ROOT", "/mnt/kv-store"),
            cleanup_threshold=float(e.get("KVTPU_EVICTOR_CLEANUP_THRESHOLD", "0.85")),
            target_threshold=float(e.get("KVTPU_EVICTOR_TARGET_THRESHOLD", "0.70")),
            min_idle_seconds=float(e.get("KVTPU_EVICTOR_MIN_IDLE_SECONDS", "3600")),
            num_crawlers=int(e.get("KVTPU_EVICTOR_NUM_CRAWLERS", "2")),
            delete_batch_size=int(e.get("KVTPU_EVICTOR_DELETE_BATCH_SIZE", "100")),
            poll_interval_s=float(e.get("KVTPU_EVICTOR_POLL_INTERVAL_S", "5")),
            empty_dir_ttl_s=float(e.get("KVTPU_EVICTOR_EMPTY_DIR_TTL_S", "600")),
            storage_events_endpoint=e.get("KVTPU_EVICTOR_EVENTS_ENDPOINT"),
            model_name=e.get("KVTPU_EVICTOR_MODEL_NAME", "unknown"),
        )
