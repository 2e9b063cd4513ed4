"""KV-event domain model.

Copy of ``llmd_kv_cache_tpu/events/model.py`` (counterpart of reference
``pkg/kvevents/events.go``): the raw transport envelope, the parsed engine
events with the same fields, the handoff's transfer-availability event,
the batch that carries them, and the adapter protocol that turns the
first into the last.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Protocol

EVENT_TYPE_BLOCK_STORED = "BlockStored"
EVENT_TYPE_BLOCK_REMOVED = "BlockRemoved"
EVENT_TYPE_ALL_BLOCKS_CLEARED = "AllBlocksCleared"
EVENT_TYPE_TRANSFER_AVAILABLE = "TransferBlocksAvailable"


@dataclass
class RawMessage:
    """Raw transport-level pub/sub message: topic, sequence, undecoded payload."""

    topic: str
    sequence: int
    payload: bytes


@dataclass
class BlockStoredEvent:
    """Blocks added to an engine's cache (``events.go:83-98``).

    ``block_hashes`` are the engine's own keys; ``tokens``+``parent_hash``
    let the pool recompute canonical request keys. Tokenless events signal
    device-tier (offload) updates for already-known blocks.
    """

    block_hashes: list[int]
    tokens: list[int] = field(default_factory=list)
    parent_hash: int = 0
    block_size: int = 0
    device_tier: str = ""
    lora_id: Optional[int] = None
    lora_name: Optional[str] = None
    extra_keys: Optional[list[Optional[list[Any]]]] = None
    group_idx: Optional[int] = None
    kv_cache_spec_kind: str = ""
    kv_cache_spec_sliding_window: Optional[int] = None

    @property
    def type(self) -> str:
        return EVENT_TYPE_BLOCK_STORED


@dataclass
class BlockRemovedEvent:
    """Blocks evicted from an engine's cache (``events.go:106-111``)."""

    block_hashes: list[int]
    device_tier: str = ""
    group_idx: Optional[int] = None

    @property
    def type(self) -> str:
        return EVENT_TYPE_BLOCK_REMOVED


@dataclass
class AllBlocksClearedEvent:
    """Pod-wide cache reset (``events.go:119-121``), e.g. an RL weight rollout."""

    device_tier: str = ""

    @property
    def type(self) -> str:
        return EVENT_TYPE_ALL_BLOCKS_CLEARED


@dataclass
class TransferBlocksAvailableEvent:
    """Handoff transfer availability (prefill/decode disaggregation).

    A prefill pod committed ``block_hashes`` for ``request_id`` to the
    shared transfer tier; the targeted decode pod may pull them now.
    ``done`` marks the final chunk (no more blocks will be published for
    this request). Deliberately NOT part of :data:`GenericEvent` — the
    index pool learns storage residency from the tier's own tokenless
    BlockStored events; this event is the *streamed per-chunk completion*
    a remote handoff coordinator forwards to the decode pod, so the pull
    can start before the prefill tail finishes.
    """

    request_id: str
    block_hashes: list[int]
    decode_pod: str = ""
    done: bool = False

    @property
    def type(self) -> str:
        return EVENT_TYPE_TRANSFER_AVAILABLE


GenericEvent = BlockStoredEvent | BlockRemovedEvent | AllBlocksClearedEvent


@dataclass
class EventBatch:
    """A batch of parsed events from one engine message.

    ``traceparent`` carries the publisher's W3C trace context across the
    wire (element [3], after dp_rank) so ingest spans parent into the trace
    that caused the cache mutation; None when the publisher was untraced or
    the engine predates the field.

    ``epoch`` is the publishing pod's topology epoch (wire element [4],
    after traceparent), which an ingest fence checks; 0 when the publisher
    predates the epoch plane (never fenced).
    """

    timestamp: float
    events: list[GenericEvent]
    data_parallel_rank: Optional[int] = None
    traceparent: Optional[str] = None
    epoch: int = 0


class EngineAdapter(Protocol):
    """Engine-specific message parser (``events.go:71-80``)."""

    def parse_message(self, msg: RawMessage) -> tuple[str, str, EventBatch]:
        """Parse a raw message → (pod_id, model_name, batch)."""
        ...

    def sharding_key(self, msg: RawMessage) -> str:
        """Key that shards messages across worker queues; messages sharing a
        key are processed in order."""
        ...
