"""Synchronous KV-event ingestion into the index.

Port of the event semantics of ``llmd_kv_cache_tpu/events/pool.py``
(``Pool.process_event_batch`` and its three handlers, counterpart of
reference ``pkg/kvevents/pool.go:302-479``). The JAX package's sharded
worker queues, ZMQ/shared-memory transports, adapters, liveness, fencing
and ledger hooks belong to the event plane, a later slice; here a caller
(an engine's event sink) applies each batch directly:

- BlockStored with tokens → learn HMA group, resolve parent engine key to a
  request key, parse + realign extra keys to canonical granularity,
  recompute request keys, ``index.add`` (``pool.go:312-425``)
- BlockStored without tokens → device-tier (offload) update for known
  blocks (``pool.go:262-299``)
- BlockRemoved → evict each engine key (``pool.go:427-451``)
- AllBlocksCleared → pod-wide ``index.clear`` (``pool.go:453-473``)
"""

from __future__ import annotations

import logging
from typing import Optional

from ..core.extra_keys import BlockExtraFeatures, parse_raw_extra_keys
from ..core.hma import GroupCatalog, GroupMetadata
from ..core.keys import EMPTY_BLOCK_HASH, TIER_TPU_HBM, BlockHash, KeyType, PodEntry
from ..core.token_processor import ChunkedTokenDatabase
from ..index.base import Index
from .model import (
    AllBlocksClearedEvent,
    BlockRemovedEvent,
    BlockStoredEvent,
    EventBatch,
)

logger = logging.getLogger(__name__)

# Default tier for events that omit a medium: the JAX package's engine-
# resident tier, kept so both packages build identical index entries from
# the same event stream (the scorer weighs it like the reference's "gpu").
DEFAULT_EVENT_SOURCE_TIER = TIER_TPU_HBM


class Pool:
    """Applies parsed event batches to an index, in call order.

    Stateless apart from the group catalog: all key mappings are delegated
    to the Index, so replicas ingesting the same stream converge to the
    same soft state.
    """

    def __init__(self, index: Index, token_processor: ChunkedTokenDatabase):
        self.index = index
        self.token_processor = token_processor
        self.group_catalog = GroupCatalog()

    def process_event_batch(
        self, batch: EventBatch, pod_identifier: str, model_name: str,
    ) -> None:
        """Apply a parsed event batch to the index (``pool.go:302-479``)."""
        for event in batch.events:
            if isinstance(event, BlockStoredEvent):
                self._handle_block_stored(event, pod_identifier, model_name)
            elif isinstance(event, BlockRemovedEvent):
                self._handle_block_removed(event, pod_identifier)
            elif isinstance(event, AllBlocksClearedEvent):
                # Pod-wide: engines emit this with no tier; a tier-scoped
                # clear is unsupported and would over-wipe.
                self.index.clear(pod_identifier)
            else:
                raise TypeError(f"unknown event from pod {pod_identifier}: {event!r}")

    def _handle_block_stored(
        self, ev: BlockStoredEvent, pod_identifier: str, model_name: str,
    ) -> None:
        device_tier = ev.device_tier.lower() if ev.device_tier else DEFAULT_EVENT_SOURCE_TIER

        # LoRA adapters are distinct cache namespaces: use the LoRA name as
        # the effective model for key derivation (pool.go:319-323).
        effective_model = ev.lora_name if ev.lora_name else model_name

        pod_entry = PodEntry(pod_identifier=pod_identifier, device_tier=device_tier)
        if ev.group_idx is not None:
            self.group_catalog.learn(
                pod_identifier,
                ev.group_idx,
                GroupMetadata(
                    kind=ev.kv_cache_spec_kind,
                    block_size=ev.block_size,
                    sliding_window_size=ev.kv_cache_spec_sliding_window,
                ),
            )
            pod_entry = PodEntry(
                pod_identifier=pod_identifier,
                device_tier=device_tier,
                has_group=True,
                group_idx=ev.group_idx,
            )
        pod_entries = [pod_entry]

        engine_keys: list[BlockHash] = ev.block_hashes

        parent_request_key = EMPTY_BLOCK_HASH
        if ev.parent_hash != 0:
            resolved = self.index.get_request_key(ev.parent_hash)
            if resolved is None:
                logger.debug(
                    "no request key for parent engine key %d (pod %s); dropping event",
                    ev.parent_hash, pod_identifier,
                )
                return
            parent_request_key = resolved

        extra_features: Optional[list[Optional[BlockExtraFeatures]]] = None
        if ev.extra_keys is not None:
            extra_features = parse_raw_extra_keys(ev.extra_keys)

        # Realign extra features from engine-block to canonical-block
        # granularity (pool.go:366-378).
        if extra_features is not None:
            canonical_count = len(ev.tokens) // self.token_processor.block_size
            if canonical_count == 0:
                extra_features = None
            elif len(extra_features) != canonical_count:
                extra_features = realign_extra_features(extra_features, canonical_count)

        try:
            request_keys = self.token_processor.tokens_to_kv_block_keys(
                parent_request_key, ev.tokens, effective_model, extra_features
            )
        except ValueError:
            logger.exception("failed to generate request keys for pod %s", pod_identifier)
            return

        if not request_keys:
            self._handle_device_tier_update(ev.tokens, engine_keys, pod_entries)
            return

        self.index.add(engine_keys, request_keys, pod_entries)

    def _handle_device_tier_update(
        self,
        tokens: list[int],
        engine_keys: list[BlockHash],
        pod_entries: list[PodEntry],
    ) -> None:
        """Tokenless BlockStored = offload/location update (``pool.go:262-299``).

        Resolve known engine keys to request keys and add the new tier entry.
        Partial-block events (0 < tokens < block size) are skipped entirely.
        """
        if tokens or not engine_keys:
            return

        seen: set[BlockHash] = set()
        resolved: list[BlockHash] = []
        for ek in engine_keys:
            rk = self.index.get_request_key(ek)
            if rk is None or rk in seen:
                continue
            seen.add(rk)
            resolved.append(rk)

        if resolved:
            self.index.add(None, resolved, pod_entries)

    def _handle_block_removed(self, ev: BlockRemovedEvent, pod_identifier: str) -> None:
        device_tier = ev.device_tier.lower() if ev.device_tier else DEFAULT_EVENT_SOURCE_TIER
        pod_entry = PodEntry(pod_identifier=pod_identifier, device_tier=device_tier)
        if ev.group_idx is not None:
            pod_entry = PodEntry(
                pod_identifier=pod_identifier,
                device_tier=device_tier,
                has_group=True,
                group_idx=ev.group_idx,
            )
        if not ev.block_hashes:
            return
        self.index.evict_batch(ev.block_hashes, KeyType.ENGINE, [pod_entry])


def realign_extra_features(
    engine_features: list[Optional[BlockExtraFeatures]], canonical_block_count: int
) -> Optional[list[Optional[BlockExtraFeatures]]]:
    """Convert per-engine-block features to per-canonical-block granularity.

    Mirrors reference ``pool.go:227-260``: for 1:many (engine block larger)
    replicate each engine feature onto its canonical sub-blocks; for many:1
    merge (union of MM hashes) constituent engine features into each
    canonical block.
    """
    engine_count = len(engine_features)
    if canonical_block_count == 0:
        return None
    if engine_count == 0 or engine_count == canonical_block_count:
        return engine_features

    canonical: list[Optional[BlockExtraFeatures]] = [None] * canonical_block_count

    if engine_count < canonical_block_count:
        for i in range(canonical_block_count):
            canonical[i] = engine_features[i * engine_count // canonical_block_count]
    else:
        for i, ef in enumerate(engine_features):
            if ef is None:
                continue
            ci = i * canonical_block_count // engine_count
            if canonical[ci] is None:
                canonical[ci] = BlockExtraFeatures()
            canonical[ci].mm_hashes.extend(ef.mm_hashes)

    return canonical
