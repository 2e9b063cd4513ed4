"""Block-hash and pod-entry value types.

Counterparts of ``pkg/kvcache/kvblock/index.go:157-205`` in the reference.
Block hashes are plain Python ints constrained to uint64; ``0`` is the
empty/error value (``EmptyBlockHash``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

# BlockHash is represented as a plain int (uint64 range). 0 is the sentinel
# "empty" value, matching reference index.go:172-174.
BlockHash = int
EMPTY_BLOCK_HASH: BlockHash = 0

# First-class device tiers for a TPU fleet. The reference's default event
# tier is "gpu" (pkg/kvevents/pool.go:32); ours is TPU HBM. "gpu" remains a
# legal tier string for interop with GPU-emitting engines.
TIER_TPU_HBM = "tpu-hbm"
TIER_CPU = "cpu"
TIER_SHARED_STORAGE = "shared_storage"
TIER_OBJECT_STORE = "object_store"


class KeyType(enum.Enum):
    """Whether a key passed to ``Index.evict`` is engine- or request-keyed.

    Mirrors reference ``index.go:157-167``: engine keys require resolution
    through the engine→request mapping; request keys are used directly
    (speculative entries added without engine keys).
    """

    ENGINE = "engine"
    REQUEST = "request"


@dataclass(frozen=True)
class PodEntry:
    """A pod locality record for one block (reference ``index.go:181-193``).

    Frozen/hashable so it can key the per-block pod LRU. ``speculative``
    marks entries added predictively before a KV event confirmed them;
    ``group_idx`` (with ``has_group``) identifies the engine's hybrid-
    attention KV-cache group.
    """

    pod_identifier: str
    device_tier: str
    speculative: bool = False
    has_group: bool = False
    group_idx: int = 0

    def __str__(self) -> str:
        suffix = "[speculative]" if self.speculative else ""
        if self.has_group:
            suffix += f"[group={self.group_idx}]"
        return f"{self.pod_identifier}@{self.device_tier}{suffix}"
