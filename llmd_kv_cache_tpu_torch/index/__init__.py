"""KV-block index backends.

Port of ``llmd_kv_cache_tpu/index`` (counterpart of the reference's index
layer, ``pkg/kvcache/kvblock/``): a thread-safe store mapping request block
keys → pod localities, with a dual key space (engine keys vs
indexer-computed request keys). ``native`` builds its C++ library at first
use; ``redis_index`` imports ``redis`` only when it must open a client.
"""

from .base import Index, IndexConfig, create_index
from .cost_aware import CostAwareMemoryIndex, CostAwareMemoryIndexConfig
from .in_memory import InMemoryIndex, InMemoryIndexConfig
from .instrumented import InstrumentedIndex, TracedIndex

__all__ = [
    "Index",
    "IndexConfig",
    "create_index",
    "InMemoryIndex",
    "InMemoryIndexConfig",
    "CostAwareMemoryIndex",
    "CostAwareMemoryIndexConfig",
    "InstrumentedIndex",
    "TracedIndex",
]
