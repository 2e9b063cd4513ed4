"""ZMQ SUB subscriber for KV events.

Copy of ``llmd_kv_cache_tpu/events/zmq_subscriber.py``; ``zmq`` is
imported by the constructor, so the module imports without it. Counterpart
of reference ``pkg/kvevents/zmq_subscriber.go``. Wire protocol:
three frames ``[topic, 8-byte big-endian sequence, msgpack payload]``
(``zmq_subscriber.go:121-135``). Two delivery modes:

- **centralized**: the indexer *binds* a local endpoint and every engine
  connects its PUB to it
- **pod-discovery**: one subscriber per pod *dials* the pod's PUB endpoint

Crash-only: an outer retry loop re-establishes the socket forever; a dead
pod's subscriber just keeps retrying until the reconciler removes it. The
reference retries on a fixed 5 s cadence (``zmq_subscriber.go:54-76``);
here the delay is jittered exponential (fast first reconnect after a
transient blip, capped for a truly dead peer, reset after a successful
receive) so a restarted fleet neither hammers a recovering indexer nor
waits 5 s to heal a 50 ms hiccup.
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, Optional

from ..resilience.failpoints import failpoints
from ..resilience.policy import RetryPolicy
from ..telemetry.flight_recorder import KIND_RECONNECT, flight_recorder
from ..utils.logging import get_logger
from .model import RawMessage

logger = get_logger("events.zmq")

# Backoff cap; kept as the historical name — stop() joins against it and
# external tooling references it as the worst-case reconnect cadence.
RETRY_INTERVAL_S = 5.0
_POLL_INTERVAL_MS = 200

# Error-mode fires inside the subscriber loop right after the socket is
# established, forcing a teardown/reconnect cycle (chaos: flapping peer).
FP_ZMQ_CONNECT = "events.zmq.connect"

# max_attempts is a per-call concept; the subscriber loop retries forever
# and only uses delay(attempt) with the attempt counter it maintains.
DEFAULT_RECONNECT_POLICY = RetryPolicy(
    max_attempts=1, base_delay_s=0.25, max_delay_s=RETRY_INTERVAL_S,
    multiplier=2.0, jitter=True,
)


class ZMQSubscriber:
    """A resilient SUB socket feeding a Pool."""

    def __init__(
        self,
        endpoint: str,
        topic_filter: str,
        on_message: Callable[[RawMessage], None],
        bind: bool = False,
        context=None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        import zmq

        self._zmq = zmq
        self.endpoint = endpoint
        self.topic_filter = topic_filter
        self.on_message = on_message
        self.bind = bind
        self.retry_policy = retry_policy or DEFAULT_RECONNECT_POLICY
        self._ctx = context or zmq.Context.instance()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Consecutive failed connection cycles since the last successful
        # receive; drives the backoff exponent.
        self._consecutive_failures = 0
        # Total reconnect cycles over the subscriber's lifetime
        # (observability/chaos-test hook).
        self.reconnects = 0

    def start(self) -> None:
        """Start the subscriber loop in a daemon thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"zmq-sub-{self.endpoint}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * RETRY_INTERVAL_S)
            self._thread = None

    def next_delay(self) -> float:
        """Backoff before the next reconnect, from the failure streak."""
        return self.retry_policy.delay(self._consecutive_failures)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._run_subscriber()
            except Exception:
                logger.exception("subscriber error for %s", self.endpoint)
            if self._stop.is_set():
                return
            delay = self.next_delay()
            self._consecutive_failures += 1
            self.reconnects += 1
            flight_recorder().record(
                KIND_RECONNECT,
                {
                    "endpoint": self.endpoint,
                    "streak": self._consecutive_failures,
                    "delay_s": delay,
                },
            )
            logger.info("reconnecting to %s in %.2fs (streak=%d)",
                        self.endpoint, delay, self._consecutive_failures)
            if self._stop.wait(delay):
                return

    def _run_subscriber(self) -> None:
        zmq = self._zmq
        sock = self._ctx.socket(zmq.SUB)
        try:
            sock.setsockopt(zmq.LINGER, 0)
            sock.setsockopt_string(zmq.SUBSCRIBE, self.topic_filter)
            if self.bind:
                sock.bind(self.endpoint)
            else:
                sock.connect(self.endpoint)
            logger.info("subscribed to %s (%s, filter=%r)",
                        self.endpoint, "bind" if self.bind else "connect", self.topic_filter)
            failpoints.hit(FP_ZMQ_CONNECT)

            while not self._stop.is_set():
                failpoints.hit(FP_ZMQ_CONNECT)
                if not sock.poll(_POLL_INTERVAL_MS):
                    continue
                frames = sock.recv_multipart()
                # A delivered message proves the link: reset the backoff so
                # the next outage starts from the fast end again.
                self._consecutive_failures = 0
                msg = self._parse_frames(frames)
                if msg is not None:
                    self.on_message(msg)
        finally:
            sock.close()

    @staticmethod
    def _parse_frames(frames: list[bytes]) -> Optional[RawMessage]:
        if len(frames) != 3:
            logger.warning("dropping message with %d frames (want 3)", len(frames))
            return None
        topic_raw, seq_raw, payload = frames
        try:
            topic = topic_raw.decode("utf-8")
        except UnicodeDecodeError:
            logger.warning("dropping message with non-utf8 topic")
            return None
        if len(seq_raw) < 8:
            logger.warning("dropping message with %d-byte seq frame (want >= 8)", len(seq_raw))
            return None
        # Decode the first 8 bytes; longer frames are tolerated for interop
        # (reference zmq_subscriber.go:130).
        (sequence,) = struct.unpack(">Q", seq_raw[:8])
        return RawMessage(topic=topic, sequence=sequence, payload=payload)
