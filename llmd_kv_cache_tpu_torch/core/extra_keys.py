"""Multimodal extra-keys: the per-block taint type and its wire parser.

Copy of ``llmd_kv_cache_tpu/core/extra_keys.py`` (counterpart of reference
``pkg/kvcache/kvblock/extra_keys.go``), limited to what the token processor
and the event pool take. Multimodal content taints block hashes: each block
overlapped by an image/audio placeholder range carries the item's
content-hash identifier, so two prompts with identical token ids but
different attachments get different block keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


@dataclass
class BlockExtraFeatures:
    """Per-block extra data that taints the block hash.

    ``None`` (rather than an instance) means pure text / no taint.
    ``mm_hashes`` holds multimodal content-hash identifier strings
    (reference ``extra_keys.go:26-34`` wraps them in an ``MMHash`` struct
    with a single ``Hash`` field; we keep plain strings and reconstruct the
    wire shape at hash time).
    """

    mm_hashes: list[str] = field(default_factory=list)


def parse_raw_extra_keys(
    raw: Optional[Sequence[Optional[Sequence[Any]]]],
) -> Optional[list[Optional[BlockExtraFeatures]]]:
    """Convert the wire-format ``extra_keys`` into typed per-block features.

    Mirrors reference ``extra_keys.go:49-85``. Each inner element is either
    a bare identifier string (vLLM v0.18.0+) or a legacy ``[hash, offset]``
    pair (offset ignored). Unknown entry types (LoRA ids, cache salts) are
    skipped. ``None`` inner entries produce ``None`` (text-only block).
    """
    if raw is None:
        return None

    result: list[Optional[BlockExtraFeatures]] = [None] * len(raw)
    for block_idx, block_keys in enumerate(raw):
        if block_keys is None:
            continue
        hashes: list[str] = []
        for entry in block_keys:
            if isinstance(entry, str):
                hashes.append(entry)
            elif isinstance(entry, (list, tuple)) and entry and isinstance(entry[0], str):
                hashes.append(entry[0])
            # anything else: skip
        if hashes:
            result[block_idx] = BlockExtraFeatures(mm_hashes=hashes)
    return result
