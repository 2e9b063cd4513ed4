"""Hybrid-model-attention (HMA) group catalog.

Copy of ``llmd_kv_cache_tpu/core/hma.py`` (counterpart of reference
``pkg/kvcache/kvblock/hma.go``). Engines with hybrid attention
(sliding-window + full, Mamba mixers, MLA, ...) maintain several KV cache
groups with distinct block semantics; BlockStored events carry the group
index plus its spec. The catalog records what each pod's groups mean so
scoring can become group-aware.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

# KV cache spec kinds as emitted by vLLM (reference pkg/kvevents/events.go:32-43).
SPEC_FULL_ATTENTION = "full_attention"
SPEC_MLA = "mla_attention"
SPEC_SLIDING_WINDOW = "sliding_window"
SPEC_SLIDING_WINDOW_MLA = "sliding_window_mla"
SPEC_MAMBA = "mamba"
SPEC_CHUNKED_LOCAL = "chunked_local_attention"
SPEC_SINK_FULL = "sink_full_attention"
SPEC_ENCODER_ONLY = "encoder_only_attention"
SPEC_CROSS = "cross_attention"
SPEC_UNKNOWN = "unknown"


@dataclass(frozen=True)
class GroupMetadata:
    """Per-group KV cache spec learned from BlockStored events."""

    kind: str
    block_size: int
    sliding_window_size: Optional[int] = None


class GroupCatalog:
    """Thread-safe per-pod catalog of KV-cache group metadata."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[str, dict[int, GroupMetadata]] = {}

    def learn(self, pod_id: str, group_idx: int, meta: GroupMetadata) -> None:
        with self._lock:
            self._entries.setdefault(pod_id, {})[group_idx] = meta

    def get(self, pod_id: str, group_idx: int) -> Optional[GroupMetadata]:
        with self._lock:
            groups = self._entries.get(pod_id)
            if groups is None:
                return None
            return groups.get(group_idx)

    def pods(self) -> list[str]:
        with self._lock:
            return list(self._entries.keys())

    def groups(self, pod_id: str) -> dict[int, GroupMetadata]:
        """All known groups for a pod (empty dict if none learned)."""
        with self._lock:
            return dict(self._entries.get(pod_id, {}))
