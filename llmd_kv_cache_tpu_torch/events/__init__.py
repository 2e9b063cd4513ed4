"""KV-event plane: ingestion of engine cache events into the index.

Port of ``llmd_kv_cache_tpu/events`` (counterpart of reference
``pkg/kvevents/``). Engines publish BlockStored / BlockRemoved /
AllBlocksCleared events; a sharded worker pool ingests them into the index
with per-pod ordering, from a ZMQ subscriber, an in-process caller
(``Pool.add_task``) or a same-host shared-memory ring. The classes that
need ``zmq`` are exported lazily, so importing the package needs no
``zmq``.
"""

from .model import (
    AllBlocksClearedEvent,
    BlockRemovedEvent,
    BlockStoredEvent,
    EventBatch,
    RawMessage,
)
from .pool import Pool, PoolConfig

_LAZY = {
    "StorageEventPublisher": ".publisher",
    "SubscriberManager": ".subscriber_manager",
    "ZMQSubscriber": ".zmq_subscriber",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AllBlocksClearedEvent",
    "BlockRemovedEvent",
    "BlockStoredEvent",
    "EventBatch",
    "RawMessage",
    "Pool",
    "PoolConfig",
    "StorageEventPublisher",
    "SubscriberManager",
    "ZMQSubscriber",
]
