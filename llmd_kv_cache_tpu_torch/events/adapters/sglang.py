"""SGLang engine adapter.

Copy of ``llmd_kv_cache_tpu/events/adapters/sglang.py`` (counterpart of
reference ``pkg/kvevents/engineadapter/sglang_adapter.go``).
SGLang emits the same positional msgpack wire format as vLLM but with a
shorter field set (no HMA group fields): BlockStored carries at most 9
fields (tag..extra_keys) and BlockRemoved at most 3 (tag, hashes, medium).
Decoding reuses the vLLM positional converters with the field lists clamped
to SGLang's schema so any future vLLM-only trailing fields are ignored.
"""

from __future__ import annotations

from typing import Any

from ..model import BlockRemovedEvent, BlockStoredEvent, GenericEvent
from .vllm import VLLMAdapter

_SGLANG_BLOCK_STORED_FIELDS = 9
_SGLANG_BLOCK_REMOVED_FIELDS = 3


class SGLangAdapter(VLLMAdapter):
    """Parses SGLang KV-event messages."""

    def _decode_event(self, raw: Any) -> GenericEvent:
        event = super()._decode_event(raw)
        if isinstance(event, BlockStoredEvent):
            # SGLang's schema ends at extra_keys; clear HMA-only fields that
            # positional decoding may have picked up from longer arrays.
            event.group_idx = None
            event.kv_cache_spec_kind = ""
            event.kv_cache_spec_sliding_window = None
        elif isinstance(event, BlockRemovedEvent):
            event.group_idx = None
        return event
