"""Storage-side disk-space manager for the offload store.

Port of ``llmd_kv_cache_tpu/evictor``: the same candidates in the same
order, and ``BlockRemoved`` payloads byte-equal to the JAX evictor's.

Counterpart of reference ``kv_connectors/pvc_evictor``: keeps the shared
KV store below a capacity threshold by deleting the least-recently-used
block files, publishing ``BlockRemoved`` storage events so the global
index stays consistent.
"""

from .config import EvictorConfig
from .evictor import Evictor

__all__ = ["EvictorConfig", "Evictor"]
