"""vLLM engine adapter.

Copy of ``llmd_kv_cache_tpu/events/adapters/vllm.py`` (counterpart of
reference ``pkg/kvevents/engineadapter/vllm_adapter.go``), decoding with the
in-repo codec (``utils.msgpack_codec``) in place of the ``msgpack`` library.
vLLM serializes event batches with msgspec (``array_like=True,
omit_defaults=True``): positional msgpack arrays where trailing default
fields may be absent and newer versions may append fields. Decoding is
therefore positional with length guards, never fixed-shape.

Wire shape: payload = ``[ts, [event, ...], data_parallel_rank?]``; each
event = ``[tag, ...fields]`` with tag one of BlockStored / BlockRemoved /
AllBlocksCleared.

BlockStored positions (``vllm_adapter.go:132-149``):
``[0]`` tag, ``[1]`` block_hashes, ``[2]`` parent_hash|nil, ``[3]``
token_ids, ``[4]`` block_size, ``[5]`` lora_id?, ``[6]`` medium?, ``[7]``
lora_name?, ``[8]`` extra_keys?, ``[9]`` group_idx?, ``[10]``
kv_cache_spec_kind?, ``[11]`` sliding_window?.

BlockRemoved positions (``:277-282``): ``[1]`` block_hashes, ``[2]``
medium?, ``[3]`` group_idx?.
"""

from __future__ import annotations

from typing import Any

from ...utils.msgpack_codec import unpackb
from ..model import (
    AllBlocksClearedEvent,
    BlockRemovedEvent,
    BlockStoredEvent,
    EventBatch,
    GenericEvent,
    RawMessage,
)
from .common import field_at, hash_to_uint64, parse_topic, to_int


class VLLMAdapter:
    """Parses vLLM KV-event messages."""

    def sharding_key(self, msg: RawMessage) -> str:
        pod_id, _ = parse_topic(msg.topic)
        return pod_id

    def parse_message(self, msg: RawMessage) -> tuple[str, str, EventBatch]:
        pod_id, model_name = parse_topic(msg.topic)

        decoded = unpackb(msg.payload)
        if not isinstance(decoded, (list, tuple)) or len(decoded) < 2:
            raise ValueError(f"malformed vLLM event batch: {type(decoded)!r}")

        ts = float(decoded[0])
        raw_events = decoded[1]
        if not isinstance(raw_events, (list, tuple)):
            raise ValueError("vLLM event batch events is not an array")

        dp_rank = None
        if len(decoded) > 2 and decoded[2] is not None:
            dp_rank = to_int(decoded[2])

        # Wire element [3]: W3C traceparent (this repo's publishers only).
        # Positional decoding with length guards keeps engines that never
        # send it — and future appended fields — parseable.
        traceparent = None
        if len(decoded) > 3 and isinstance(decoded[3], str):
            traceparent = decoded[3]

        # Wire element [4]: publisher's topology epoch (cluster.membership)
        # — 0/absent from engines that predate the epoch plane.
        epoch = 0
        if len(decoded) > 4 and decoded[4] is not None:
            try:
                epoch = int(decoded[4])
            except (TypeError, ValueError):
                epoch = 0

        events = [self._decode_event(raw) for raw in raw_events]
        return pod_id, model_name, EventBatch(
            timestamp=ts, events=events, data_parallel_rank=dp_rank,
            traceparent=traceparent, epoch=epoch,
        )

    def _decode_event(self, raw: Any) -> GenericEvent:
        # Events may arrive as nested arrays or as embedded msgpack bytes
        # (both occur depending on the publisher's serializer nesting).
        if isinstance(raw, (bytes, bytearray)):
            raw = unpackb(raw)
        if not isinstance(raw, (list, tuple)) or not raw:
            raise ValueError("malformed tagged union: no tag")
        tag = raw[0]
        if not isinstance(tag, str):
            raise ValueError(f"event tag is not a string: {type(tag)!r}")
        fields = list(raw)
        if tag == "BlockStored":
            return self._convert_block_stored(fields)
        if tag == "BlockRemoved":
            return self._convert_block_removed(fields)
        if tag == "AllBlocksCleared":
            return AllBlocksClearedEvent()
        raise ValueError(f"unknown vLLM event tag: {tag}")

    def _convert_block_stored(self, fields: list) -> BlockStoredEvent:
        if len(fields) < 5:
            raise ValueError(f"BlockStored: need at least 5 fields, got {len(fields)}")

        raw_hashes = fields[1]
        if not isinstance(raw_hashes, (list, tuple)):
            raise ValueError(f"BlockStored: block_hashes is not an array: {type(fields[1])!r}")
        block_hashes = [hash_to_uint64(h) for h in raw_hashes]

        parent_hash = 0
        if fields[2] is not None:
            parent_hash = hash_to_uint64(fields[2])

        raw_tokens = fields[3]
        if not isinstance(raw_tokens, (list, tuple)):
            raise ValueError(f"BlockStored: token_ids is not an array: {type(fields[3])!r}")
        tokens = [to_int(t) & 0xFFFFFFFF for t in raw_tokens]

        block_size = to_int(fields[4])

        lora_id = None
        if (raw := field_at(fields, 5)) is not None:
            lora_id = to_int(raw)

        device_tier = ""
        if (raw := field_at(fields, 6)) is not None:
            if not isinstance(raw, str):
                raise ValueError(f"BlockStored: medium is not a string: {type(raw)!r}")
            device_tier = raw

        lora_name = None
        if (raw := field_at(fields, 7)) is not None:
            if not isinstance(raw, str):
                raise ValueError(f"BlockStored: lora_name is not a string: {type(raw)!r}")
            lora_name = raw

        extra_keys = None
        if (raw := field_at(fields, 8)) is not None:
            if not isinstance(raw, (list, tuple)):
                raise ValueError(f"BlockStored: extra_keys is not an array: {type(raw)!r}")
            extra_keys = [
                list(inner) if isinstance(inner, (list, tuple)) else inner
                for inner in raw
            ]

        group_idx = None
        if (raw := field_at(fields, 9)) is not None:
            group_idx = to_int(raw)
            if group_idx < 0:
                raise ValueError(f"BlockStored: group_idx: negative value: {group_idx}")

        spec_kind = ""
        if (raw := field_at(fields, 10)) is not None:
            if not isinstance(raw, str):
                raise ValueError(
                    f"BlockStored: kv_cache_spec_kind is not a string: {type(raw)!r}"
                )
            spec_kind = raw

        sliding_window = None
        if (raw := field_at(fields, 11)) is not None:
            sliding_window = to_int(raw)

        return BlockStoredEvent(
            block_hashes=block_hashes,
            tokens=tokens,
            parent_hash=parent_hash,
            block_size=block_size,
            device_tier=device_tier,
            lora_id=lora_id,
            lora_name=lora_name,
            extra_keys=extra_keys,
            group_idx=group_idx,
            kv_cache_spec_kind=spec_kind,
            kv_cache_spec_sliding_window=sliding_window,
        )

    def _convert_block_removed(self, fields: list) -> BlockRemovedEvent:
        if len(fields) < 2:
            raise ValueError(f"BlockRemoved: need at least 2 fields, got {len(fields)}")

        raw_hashes = fields[1]
        if not isinstance(raw_hashes, (list, tuple)):
            raise ValueError(f"BlockRemoved: block_hashes is not an array: {type(fields[1])!r}")
        block_hashes = [hash_to_uint64(h) for h in raw_hashes]

        device_tier = ""
        if (raw := field_at(fields, 2)) is not None:
            if not isinstance(raw, str):
                raise ValueError(f"BlockRemoved: medium is not a string: {type(raw)!r}")
            device_tier = raw

        group_idx = None
        if (raw := field_at(fields, 3)) is not None:
            group_idx = to_int(raw)
            if group_idx < 0:
                raise ValueError(f"BlockRemoved: group_idx: negative value: {group_idx}")

        return BlockRemovedEvent(
            block_hashes=block_hashes,
            device_tier=device_tier,
            group_idx=group_idx,
        )
