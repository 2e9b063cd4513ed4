"""Degraded-mode index: primary backend with in-memory failover.

Copy of ``llmd_kv_cache_tpu/resilience/failover.py``. Wraps a primary
:class:`~llmd_kv_cache_tpu_torch.index.base.Index` (typically
Redis) behind a retry policy and a circuit breaker.  Every write is
mirrored into the fallback index first, so the fallback holds a warm
(LRU-bounded) replica of everything this process has learned; when the
primary's breaker opens, reads are served from the fallback until the
breaker's probe succeeds.  The index is soft state rebuilt from the
event stream, so a temporarily narrower fallback view only costs some
routing quality — never correctness.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.keys import BlockHash, KeyType, PodEntry
from ..index.base import Index
from ..telemetry.flight_recorder import KIND_FAILOVER, flight_recorder
from ..telemetry.tracing import tracer
from ..utils.logging import get_logger
from .policy import CircuitBreaker, CircuitOpenError, RetryPolicy, call_with_retry

logger = get_logger("resilience.failover")


class FailoverIndex(Index):
    """Index wrapper: primary under breaker+retry, in-memory fallback."""

    def __init__(
        self,
        primary,
        fallback,
        retry_policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.primary = primary
        self.fallback = fallback
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=2, base_delay_s=0.02, max_delay_s=0.2, deadline_s=1.0
        )
        self.breaker = breaker or CircuitBreaker(
            target="index.primary", failure_threshold=3, reset_timeout_s=5.0
        )
        self.failovers = 0  # reads served by the fallback

    # -- internals --------------------------------------------------------

    def _primary_call(self, fn):
        """Run a primary op through breaker + retry; raise on failure."""
        return self.breaker.call(
            lambda: call_with_retry(fn, self.retry_policy)
        )

    def _record_failover(self, op_name: str, reason: str) -> None:
        """Flight-record + span the failover decision so post-hoc debugging
        can see when (and why) routing quality degraded to the fallback."""
        flight_recorder().record(
            KIND_FAILOVER,
            {
                "op": op_name,
                "reason": reason,
                "breaker_state": self.breaker.state,
                "failovers": self.failovers,
            },
        )
        with tracer().span(
            "llm_d.kv_cache.resilience.failover",
            op=op_name,
            reason=reason,
            breaker_state=self.breaker.state,
        ):
            pass

    def _read(self, op_name: str, primary_fn, fallback_fn):
        try:
            return self._primary_call(primary_fn)
        except CircuitOpenError:
            self.failovers += 1
            self._record_failover(op_name, "breaker_open")
            return fallback_fn()
        except Exception as exc:
            self.failovers += 1
            self._record_failover(op_name, f"error: {exc}")
            logger.warning("primary index %s failed (%s); serving fallback", op_name, exc)
            return fallback_fn()

    def _write(self, op_name: str, primary_fn) -> None:
        # Fallback is written by the caller before this; primary write
        # failures are absorbed (the breaker counts them) because the
        # event stream will converge the primary once it heals.
        try:
            self._primary_call(primary_fn)
        except CircuitOpenError:  # breaker open; fallback already holds the write  # lint: allow-swallow
            pass
        except Exception as exc:
            logger.warning("primary index %s failed (%s); fallback retains write", op_name, exc)

    # -- Index contract ---------------------------------------------------

    def lookup(
        self,
        request_keys: Sequence[BlockHash],
        pod_identifier_set: Optional[set[str]] = None,
    ) -> dict[BlockHash, list[PodEntry]]:
        return self._read(
            "lookup",
            lambda: self.primary.lookup(request_keys, pod_identifier_set),
            lambda: self.fallback.lookup(request_keys, pod_identifier_set),
        )

    def add(
        self,
        engine_keys: Optional[Sequence[BlockHash]],
        request_keys: Sequence[BlockHash],
        entries: Sequence[PodEntry],
    ) -> None:
        self.fallback.add(engine_keys, request_keys, entries)
        self._write("add", lambda: self.primary.add(engine_keys, request_keys, entries))

    def evict(
        self,
        key: BlockHash,
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        self.fallback.evict(key, key_type, entries)
        self._write("evict", lambda: self.primary.evict(key, key_type, entries))

    def evict_batch(
        self,
        keys: Sequence[BlockHash],
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        # One mirrored batch instead of N wrapped evicts: the primary's
        # pipelined implementation stays engaged and the breaker counts
        # one op per digest.
        self.fallback.evict_batch(keys, key_type, entries)
        self._write(
            "evict_batch", lambda: self.primary.evict_batch(keys, key_type, entries)
        )

    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        return self._read(
            "get_request_key",
            lambda: self.primary.get_request_key(engine_key),
            lambda: self.fallback.get_request_key(engine_key),
        )

    def clear(self, pod_identifier: str) -> None:
        self.fallback.clear(pod_identifier)
        self._write("clear", lambda: self.primary.clear(pod_identifier))

    def dump_state(self):
        # The fallback mirrors every write this process made; the primary
        # (Redis) is durable on its own, so the warm replica is the right
        # thing to snapshot — and it works even while the breaker is open.
        return self.fallback.dump_state()

    def restore_state(self, state: dict) -> int:
        restored = self.fallback.restore_state(state)
        self._write("restore_state", lambda: self.primary.restore_state(state))
        return restored
