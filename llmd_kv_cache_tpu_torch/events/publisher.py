"""ZMQ PUB publisher for KV events.

Port of ``llmd_kv_cache_tpu/events/publisher.py``. The payload that
``publish`` sends is factored into :func:`encode_batch`, a plain function
of the port (packed with the in-repo codec, ``utils.msgpack_codec``), so a
caller can frame events without a socket: its bytes equal those the JAX
publisher sends. ``zmq`` is imported inside the publishers' constructors,
so the module imports without it.

Engine-side counterpart of the subscriber wire: 3 frames ``[topic,
big-endian uint64 seq, msgpack([ts, [events], dp_rank?])]`` with events as
positional arrays (msgspec ``array_like=True, omit_defaults=True`` style:
trailing default fields trimmed).

Two users:

- the in-tree TPU serving engine (``models.engine``) publishing its block
  store/remove/clear events, topic ``kv@<pod>@<model>``
- the offload data plane's **StorageEventPublisher** (reference
  ``llmd_fs_backend/event_publisher.py:45-158``): tokenless BlockStored /
  BlockRemoved with the *medium* in the pod slot, topic
  ``kv@<MEDIUM>@<model>``, hashes masked to 64 bits.
"""

from __future__ import annotations

import struct
import time
from typing import Optional, Sequence

from ..telemetry.tracing import current_traceparent
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from ..utils.msgpack_codec import packb
from .model import AllBlocksClearedEvent, BlockRemovedEvent, BlockStoredEvent, GenericEvent

logger = get_logger("events.publisher")

_MASK64 = 0xFFFFFFFFFFFFFFFF
DEFAULT_HWM = 100_000  # publisher high-water mark (event_publisher.py:28,72)

MEDIUM_SHARED_STORAGE = "SHARED_STORAGE"
MEDIUM_OBJECT_STORE = "OBJECT_STORE"


def encode_event(event: GenericEvent) -> list:
    """Encode a domain event as its positional wire array, trailing
    defaults trimmed."""
    if isinstance(event, BlockStoredEvent):
        fields = [
            "BlockStored",
            [h & _MASK64 for h in event.block_hashes],
            (event.parent_hash & _MASK64) if event.parent_hash else None,
            list(event.tokens),
            event.block_size,
            event.lora_id,
            event.device_tier or None,
            event.lora_name,
            event.extra_keys,
            event.group_idx,
            event.kv_cache_spec_kind or None,
            event.kv_cache_spec_sliding_window,
        ]
    elif isinstance(event, BlockRemovedEvent):
        fields = [
            "BlockRemoved",
            [h & _MASK64 for h in event.block_hashes],
            event.device_tier or None,
            event.group_idx,
        ]
    elif isinstance(event, AllBlocksClearedEvent):
        fields = ["AllBlocksCleared"]
    else:
        raise TypeError(f"cannot encode event {type(event)!r}")

    while len(fields) > 1 and fields[-1] is None:
        fields.pop()
    return fields


def encode_batch(
    events: Sequence[GenericEvent],
    timestamp: float,
    data_parallel_rank: Optional[int] = None,
    traceparent: Optional[str] = None,
    epoch: int = 0,
) -> bytes:
    """The msgpack payload of one batch, ``[ts, [events], dp_rank?,
    traceparent?, epoch?]``: the W3C trace context rides as wire element
    [3] and the publisher's topology epoch (``epoch`` > 0) as element [4],
    with absent middle elements padded nil. Length-tolerant adapters on old
    subscribers ignore both, so the wire stays engine-compatible."""
    batch: list = [timestamp, [encode_event(e) for e in events]]
    if data_parallel_rank is not None or traceparent is not None or epoch:
        batch.append(data_parallel_rank)
    if traceparent is not None or epoch:
        batch.append(traceparent)
    if epoch:
        batch.append(int(epoch))
    return packb(batch)


class KVEventPublisher:
    """ZMQ PUB socket emitting KV-event batches for one topic."""

    def __init__(
        self,
        endpoint: str,
        pod_identifier: str,
        model_name: str,
        bind: bool = True,
        context=None,
        hwm: int = DEFAULT_HWM,
    ):
        import zmq

        self.topic = f"kv@{pod_identifier}@{model_name}"
        self._ctx = context or zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        self._sock.setsockopt(zmq.SNDHWM, hwm)
        self._sock.setsockopt(zmq.LINGER, 0)
        if bind:
            self._sock.bind(endpoint)
        else:
            self._sock.connect(endpoint)
        self.endpoint = endpoint
        self._seq = 0
        self._lock = new_lock()

    def publish(
        self,
        events: Sequence[GenericEvent],
        timestamp: Optional[float] = None,
        data_parallel_rank: Optional[int] = None,
        traceparent: Optional[str] = None,
        epoch: int = 0,
    ) -> int:
        """Publish one batch; returns the sequence number used.

        The ambient W3C trace context (or an explicit ``traceparent``) and
        the topology epoch ride as in :func:`encode_batch`.
        """
        ts = timestamp if timestamp is not None else time.time()
        if traceparent is None:
            traceparent = current_traceparent()
        payload = encode_batch(events, ts, data_parallel_rank, traceparent, epoch)
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._sock.send_multipart(
                [self.topic.encode("utf-8"), struct.pack(">Q", seq), payload]
            )
        return seq

    def close(self) -> None:
        self._sock.close()


class StorageEventPublisher(KVEventPublisher):
    """Publishes storage-tier events (offload data plane → indexer).

    Mirrors reference ``event_publisher.py``: the "pod" slot carries the
    storage medium, events are tokenless so the pool resolves them through
    the engine→request mapping as device-tier updates.
    """

    def __init__(
        self,
        endpoint: str,
        model_name: str,
        medium: str = MEDIUM_SHARED_STORAGE,
        bind: bool = False,
        context=None,
    ):
        super().__init__(
            endpoint,
            pod_identifier=medium,
            model_name=model_name,
            bind=bind,
            context=context,
        )
        self.medium = medium

    def publish_block_stored(self, block_hashes: Sequence[int], block_size: int) -> int:
        """Tokenless BlockStored: blocks now present on this medium."""
        return self.publish(
            [
                BlockStoredEvent(
                    block_hashes=[h & _MASK64 for h in block_hashes],
                    tokens=[],
                    parent_hash=0,
                    block_size=block_size,
                    device_tier=self.medium,
                )
            ]
        )

    def publish_block_removed(self, block_hashes: Sequence[int]) -> int:
        return self.publish(
            [
                BlockRemovedEvent(
                    block_hashes=[h & _MASK64 for h in block_hashes],
                    device_tier=self.medium,
                )
            ]
        )
