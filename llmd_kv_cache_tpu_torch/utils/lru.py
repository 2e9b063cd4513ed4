"""Thread-safe LRU cache.

Copy of ``llmd_kv_cache_tpu/utils/lru.py``. Equivalent in role to
hashicorp/golang-lru in the reference in-memory index
(``pkg/kvcache/kvblock/in_memory.go:61-76``): bounded, promote-on-get, with
a non-promoting ``peek`` so maintenance scans (Clear) don't distort recency
(``in_memory.go:327-330``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Generic, Hashable, Iterator, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

_SENTINEL = object()


class LRUCache(Generic[K, V]):
    """Bounded LRU mapping with promote-on-get semantics."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"LRU capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._data: "OrderedDict[K, V]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: K, default: Optional[V] = None) -> Optional[V]:
        """Return value for ``key``, promoting it to most-recently-used."""
        with self._lock:
            value = self._data.get(key, _SENTINEL)
            if value is _SENTINEL:
                return default
            self._data.move_to_end(key)
            return value  # type: ignore[return-value]

    def peek(self, key: K, default: Optional[V] = None) -> Optional[V]:
        """Return value for ``key`` without promoting recency."""
        with self._lock:
            value = self._data.get(key, _SENTINEL)
            return default if value is _SENTINEL else value  # type: ignore[return-value]

    def add(self, key: K, value: V) -> bool:
        """Insert or update; returns True if an entry was evicted."""
        with self._lock:
            if key in self._data:
                self._data[key] = value
                self._data.move_to_end(key)
                return False
            self._data[key] = value
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
                return True
            return False

    def get_or_create(self, key: K, factory) -> tuple[V, bool]:
        """Return the existing value or insert ``factory()`` on a miss.

        Returns ``(stored_value, existed)``; the value is only constructed
        when the key is absent.
        """
        with self._lock:
            existing = self._data.get(key, _SENTINEL)
            if existing is not _SENTINEL:
                self._data.move_to_end(key)
                return existing, True  # type: ignore[return-value]
            value = factory()
            self._data[key] = value
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
            return value, False

    def remove(self, key: K) -> bool:
        with self._lock:
            if key in self._data:
                del self._data[key]
                return True
            return False

    def keys(self) -> list[K]:
        """Snapshot of keys, oldest first."""
        with self._lock:
            return list(self._data.keys())

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._data

    def __iter__(self) -> Iterator[K]:
        return iter(self.keys())
