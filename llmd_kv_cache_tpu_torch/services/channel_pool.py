"""Process-wide shared gRPC channel pool (port of
``llmd_kv_cache_tpu/services/channel_pool.py``).

Channels are safe to share across threads and multiplex RPCs, so the pool
hands out one refcounted channel per normalized target: constructing many
clients against one indexer (a client per shard, benches, tests) pays the
TCP+HTTP/2 setup once. ``acquire`` / ``release`` pair with client
construction / ``close()``; the channel closes when its last user releases
it. ``grpc`` is imported in :func:`acquire`, never at import: the card's
machine has no ``grpc``, and only the gRPC clients, which run on the CPU,
reach it.
"""

from __future__ import annotations

from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from ..utils.net import grpc_target

logger = get_logger("services.channel_pool")

_lock = new_lock()
_channels: dict = {}  # target -> (grpc.Channel, refcount)


def acquire(address: str):
    """Shared insecure channel for ``address`` (refcount +1)."""
    import grpc

    target = grpc_target(address)
    with _lock:
        entry = _channels.get(target)
        if entry is not None:
            channel, refs = entry
            _channels[target] = (channel, refs + 1)
            return channel
        channel = grpc.insecure_channel(target)
        _channels[target] = (channel, 1)
        return channel


def release(address: str) -> None:
    """Refcount -1; closes the channel when the last user releases.

    Releasing an unknown target is a no-op (idempotent ``close()``)."""
    target = grpc_target(address)
    with _lock:
        entry = _channels.get(target)
        if entry is None:
            return
        channel, refs = entry
        if refs > 1:
            _channels[target] = (channel, refs - 1)
            return
        del _channels[target]
    channel.close()


def stats() -> dict:
    """{target: refcount} snapshot (debug surface, tests)."""
    with _lock:
        return {t: refs for t, (_, refs) in _channels.items()}
