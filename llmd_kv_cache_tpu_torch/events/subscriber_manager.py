"""Per-pod subscriber lifecycle management.

Copy of ``llmd_kv_cache_tpu/events/subscriber_manager.py``. Counterpart of
reference ``pkg/kvevents/subscriber_manager.go``: one
subscriber per discovered pod, idempotent ``ensure_subscriber`` with
endpoint-change handling, individual stop on pod removal. Driven by a pod
reconciler (Kubernetes watch) or any discovery source.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .model import RawMessage
from .zmq_subscriber import ZMQSubscriber

logger = get_logger("events.submgr")


class SubscriberManager:
    """Tracks one ZMQSubscriber per pod."""

    def __init__(
        self,
        on_message: Callable[[RawMessage], None],
        topic_filter: str = "kv@",
    ):
        self._on_message = on_message
        self._topic_filter = topic_filter
        self._lock = new_lock()
        self._subscribers: dict[str, tuple[str, ZMQSubscriber]] = {}

    def ensure_subscriber(self, pod_name: str, endpoint: str) -> bool:
        """Create (or re-create on endpoint change) a pod's subscriber.

        Returns True when a new subscriber was started. Idempotent for an
        unchanged endpoint (``subscriber_manager.go:52-93``).
        """
        old_sub = None
        with self._lock:
            existing = self._subscribers.get(pod_name)
            if existing is not None:
                old_endpoint, old_sub = existing
                if old_endpoint == endpoint:
                    return False
                logger.info("pod %s endpoint changed %s → %s; restarting subscriber",
                            pod_name, old_endpoint, endpoint)
                del self._subscribers[pod_name]

            sub = ZMQSubscriber(
                endpoint=endpoint,
                topic_filter=self._topic_filter,
                on_message=self._on_message,
                bind=False,
            )
            sub.start()
            self._subscribers[pod_name] = (endpoint, sub)

        # Stop the replaced subscriber outside the lock: stop() joins its
        # thread (seconds) and must not stall other pods' reconciliation.
        if old_sub is not None:
            old_sub.stop()
        logger.info("subscriber started for pod %s at %s", pod_name, endpoint)
        return True

    def remove_subscriber(self, pod_name: str) -> bool:
        """Stop and drop a pod's subscriber (pod deleted)."""
        with self._lock:
            existing = self._subscribers.pop(pod_name, None)
        if existing is None:
            return False
        existing[1].stop()
        logger.info("subscriber removed for pod %s", pod_name)
        return True

    def pods(self) -> list[str]:
        with self._lock:
            return list(self._subscribers.keys())

    def endpoint_of(self, pod_name: str) -> Optional[str]:
        with self._lock:
            entry = self._subscribers.get(pod_name)
            return entry[0] if entry else None

    def shutdown(self) -> None:
        with self._lock:
            subs = list(self._subscribers.values())
            self._subscribers.clear()
        for _, sub in subs:
            sub.stop()
