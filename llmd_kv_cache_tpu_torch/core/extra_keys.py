"""Multimodal extra-keys: parsing and read-side recomputation.

Copy of ``llmd_kv_cache_tpu/core/extra_keys.py`` (counterpart of reference
``pkg/kvcache/kvblock/extra_keys.go``). Multimodal content taints block
hashes: each block overlapped by an image/audio placeholder range carries
the item's content-hash identifier, so two prompts with identical token ids
but different attachments get different block keys.
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


@dataclass(frozen=True)
class PlaceholderRange:
    """A contiguous run of placeholder tokens for one multimodal item."""

    offset: int
    length: int


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


def compute_block_extra_features(
    mm_hashes: dict[str, list[str]],
    mm_placeholders: dict[str, list[PlaceholderRange]],
    block_size: int,
    num_tokens: int,
) -> Optional[list[Optional[BlockExtraFeatures]]]:
    """Recompute per-block MM taint from tokenizer metadata.

    Read-side mirror of vLLM's ``_gen_mm_extra_hash_keys``: for each full
    block, emit the identifiers of every multimodal item whose placeholder
    range overlaps the block (reference ``extra_keys.go:100-163``).
    """
    if not mm_hashes or block_size <= 0 or num_tokens <= 0:
        return None

    items: list[tuple[int, int, str]] = []  # (start, end, hash)
    for modality, hashes in mm_hashes.items():
        ranges = mm_placeholders.get(modality)
        if ranges is None:
            continue
        for h, r in zip(hashes, ranges):
            items.append((r.offset, r.offset + r.length, h))

    if not items:
        return None

    items.sort(key=lambda it: it[0])

    num_blocks = num_tokens // block_size
    result: list[Optional[BlockExtraFeatures]] = [None] * num_blocks

    for block_idx in range(num_blocks):
        block_start = block_idx * block_size
        block_end = block_start + block_size
        hashes: list[str] = []
        for start, end, h in items:
            if end <= block_start:
                continue
            if start >= block_end:
                break  # items sorted by start: no further overlaps
            hashes.append(h)
        if hashes:
            result[block_idx] = BlockExtraFeatures(mm_hashes=hashes)

    return result
