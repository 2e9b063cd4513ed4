"""Metrics and tracing decorators for Index backends.

Copy of ``llmd_kv_cache_tpu/index/instrumented.py`` (counterparts of
reference ``instrumented_index.go`` / ``traced_index.go``): wrap any Index
with the index metric families (on the port's in-repo registry) on
lookups/admissions/evictions and the port's tracer spans around each
operation. Wrapping is cheap and no-ops when tracing is unconfigured.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from ..core.keys import BlockHash, KeyType, PodEntry
from ..metrics.collector import (
    INDEX_ADMISSIONS,
    INDEX_EVICTIONS,
    INDEX_LOOKUP_HITS,
    INDEX_LOOKUP_LATENCY,
    INDEX_LOOKUP_REQUESTS,
    INDEX_MAX_POD_HIT_COUNT,
)
from ..telemetry.tracing import tracer
from .base import Index


class InstrumentedIndex(Index):
    """Prometheus-instrumented Index decorator."""

    def __init__(self, inner: Index):
        self._inner = inner

    def lookup(self, request_keys, pod_identifier_set=None):
        INDEX_LOOKUP_REQUESTS.inc()
        start = time.perf_counter()
        try:
            result = self._inner.lookup(request_keys, pod_identifier_set)
        finally:
            INDEX_LOOKUP_LATENCY.observe(time.perf_counter() - start)
        INDEX_LOOKUP_HITS.inc(len(result))
        if result:
            pod_hits: dict[str, int] = {}
            for entries in result.values():
                for e in entries:
                    pod_hits[e.pod_identifier] = pod_hits.get(e.pod_identifier, 0) + 1
            INDEX_MAX_POD_HIT_COUNT.inc(max(pod_hits.values()))
        return result

    def add(self, engine_keys, request_keys, entries):
        self._inner.add(engine_keys, request_keys, entries)
        INDEX_ADMISSIONS.inc(len(request_keys))

    def evict(self, key, key_type, entries):
        self._inner.evict(key, key_type, entries)
        INDEX_EVICTIONS.inc()

    def evict_batch(self, keys, key_type, entries):
        # Delegate so the backend's batched implementation (pipelined
        # Redis, packed-once native) isn't degraded to an evict loop.
        self._inner.evict_batch(keys, key_type, entries)
        INDEX_EVICTIONS.inc(len(keys))

    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        return self._inner.get_request_key(engine_key)

    def clear(self, pod_identifier: str) -> None:
        self._inner.clear(pod_identifier)

    def dump_state(self):
        return self._inner.dump_state()

    def restore_state(self, state: dict) -> int:
        return self._inner.restore_state(state)


class TracedIndex(Index):
    """Span Index decorator (no-op without an exporter or provider)."""

    def __init__(self, inner: Index):
        self._inner = inner
        self._tracer = tracer()

    def lookup(
        self,
        request_keys: Sequence[BlockHash],
        pod_identifier_set=None,
    ):
        with self._tracer.span(
            "llm_d.kv_cache.index.lookup", key_count=len(request_keys)
        ) as span:
            result = self._inner.lookup(request_keys, pod_identifier_set)
            span.set_attribute("hit_count", len(result))
            return result

    def add(self, engine_keys, request_keys, entries):
        with self._tracer.span(
            "llm_d.kv_cache.index.add",
            engine_key_count=len(engine_keys) if engine_keys else 0,
            request_key_count=len(request_keys),
            entry_count=len(entries),
        ):
            self._inner.add(engine_keys, request_keys, entries)

    def evict(self, key: BlockHash, key_type: KeyType, entries: Sequence[PodEntry]):
        with self._tracer.span("llm_d.kv_cache.index.evict", key_type=key_type.value):
            self._inner.evict(key, key_type, entries)

    def evict_batch(self, keys, key_type: KeyType, entries: Sequence[PodEntry]):
        with self._tracer.span(
            "llm_d.kv_cache.index.evict_batch",
            key_type=key_type.value, key_count=len(keys),
        ):
            self._inner.evict_batch(keys, key_type, entries)

    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        return self._inner.get_request_key(engine_key)

    def clear(self, pod_identifier: str) -> None:
        with self._tracer.span("llm_d.kv_cache.index.clear", pod=pod_identifier):
            self._inner.clear(pod_identifier)

    def dump_state(self):
        with self._tracer.span("llm_d.kv_cache.index.dump_state"):
            return self._inner.dump_state()

    def restore_state(self, state: dict) -> int:
        with self._tracer.span("llm_d.kv_cache.index.restore_state") as span:
            restored = self._inner.restore_state(state)
            span.set_attribute("restored_entries", restored)
            return restored
