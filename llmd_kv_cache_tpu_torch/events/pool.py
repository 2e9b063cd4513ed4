"""Sharded, per-pod-ordered event processing pool.

Port of ``llmd_kv_cache_tpu/events/pool.py`` (counterpart of reference
``pkg/kvevents/pool.go``), with its queues, raw, packed (KZC1) and
shared-memory ingest paths, coalescer, lag tracking, liveness, spans,
flight records and metric families. The packed path hashes its uint32
token view with the native chain (``index.native``) and hands the key
arrays straight to an index that ``accepts_key_arrays``.
``attach_membership`` arms the ingest write fence of
``cluster.membership``: a live batch from a pod whose lease lapsed, or
stamped with a stale epoch, is dropped (``fenced_batches``) under
``fenceMode: reject``.

Messages are sharded
across worker queues by FNV-1a(pod id) % concurrency (``pool.go:161-173``)
so all events from one pod land on one worker and are processed in order —
the system's own "parallelism". Workers ingest parsed events into the index:

- BlockStored with tokens → learn HMA group, resolve parent engine key to a
  request key, parse + realign extra keys to canonical granularity,
  recompute request keys, ``index.add`` (``pool.go:312-425``)
- BlockStored without tokens → device-tier (offload) update for known
  blocks (``pool.go:262-299``)
- BlockRemoved → evict each engine key (``pool.go:427-451``)
- AllBlocksCleared → pod-wide ``index.clear`` (``pool.go:453-473``)
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..core.extra_keys import BlockExtraFeatures, parse_raw_extra_keys
from ..core.hma import GroupCatalog, GroupMetadata
from ..core.keys import EMPTY_BLOCK_HASH, TIER_TPU_HBM, BlockHash, KeyType, PodEntry
from ..core.token_processor import ChunkedTokenDatabase
from ..index import native
from ..index.base import Index
from ..resilience.liveness import PodLivenessTracker
from ..telemetry.flight_recorder import KIND_INGEST, KIND_OVERFLOW, flight_recorder
from ..telemetry.tracing import tracer
from ..utils.fnv import fnv1a_32
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .adapters import create_adapter
from .model import (
    AllBlocksClearedEvent,
    BlockRemovedEvent,
    BlockStoredEvent,
    EventBatch,
    EngineAdapter,
    RawMessage,
)

logger = get_logger("events.pool")

# Default tier for events that omit a medium. The reference defaults to
# "gpu" (pool.go:32); on a TPU fleet the engine-resident tier is TPU HBM.
DEFAULT_EVENT_SOURCE_TIER = TIER_TPU_HBM


@dataclass
class PodDiscoveryConfig:
    """Kubernetes pod-reconciler knobs (``pool.go:56-76``)."""

    pod_label_selector: str = "llm-d.ai/inference-serving=true"
    pod_namespace: str = ""
    socket_port: int = 5557


@dataclass
class PoolConfig:
    """Event pool configuration (``pool.go:37-86``)."""

    zmq_endpoint: str = ""
    topic_filter: str = "kv@"
    concurrency: int = 4
    engine_type: str = "vllm"
    discover_pods: bool = False
    pod_discovery_config: PodDiscoveryConfig = field(default_factory=PodDiscoveryConfig)
    # TPU addition closing the reference's documented DP gap
    # (vllm_adapter.go:95, architecture.md "DP ranks WIP"): when True, pod
    # identifiers become "<pod>|dp<rank>" for events tagged with a
    # data-parallel rank, so routing can target a specific rank.
    track_dp_rank: bool = False
    # Pod-liveness degradation (resilience.liveness): a pod whose last
    # event is older than liveness_stale_after_s starts losing score
    # weight, reaching zero at liveness_drop_after_s. 0 disables tracking.
    liveness_stale_after_s: float = 30.0
    liveness_drop_after_s: float = 120.0
    # Batched ingestion: a worker drains up to this many queued messages
    # per wake-up and coalesces consecutive same-pod BlockStored /
    # BlockRemoved digests into single index calls. 1 restores strict
    # one-message-at-a-time processing.
    ingest_batch_max: int = 64
    # Per-shard queue bound. When a shard backs up to this depth, the
    # *oldest* queued message is dropped to admit the newest (fresh events
    # carry the current truth; anti-entropy repairs the hole). 0 restores
    # the old unbounded behavior — and its unbounded-memory failure mode.
    ingest_queue_max: int = 8192
    # Zero-copy ingest (docs/architecture.md "Native data plane"): accept
    # packed KZC1 frames (events.packed) alongside msgpack and decode
    # them as numpy views over the received buffer — no per-key/per-token
    # Python objects. Off turns packed frames into parse failures.
    ingest_zero_copy: bool = True
    # Same-host shared-memory ring (events.shm_ring): when set, a reader
    # thread drains packed frames from this ring file in addition to the
    # socket wire. Empty disables. The writer side creates the file; the
    # pool attaches (and retries until it appears).
    shm_ring_path: str = ""
    shm_ring_bytes: int = 1 << 20
    shm_ring_poll_s: float = 0.0005

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PoolConfig":
        if not d:
            return cls()
        batch_max = d.get("ingestBatchMax", d.get("ingest_batch_max"))
        queue_max = d.get("ingestQueueMax", d.get("ingest_queue_max"))
        zero_copy = d.get("ingestZeroCopy", d.get("ingest_zero_copy"))
        ring_bytes = d.get("shmRingBytes", d.get("shm_ring_bytes"))
        cfg = cls(
            zmq_endpoint=d.get("zmqEndpoint", d.get("zmq_endpoint", "")),
            topic_filter=d.get("topicFilter", d.get("topic_filter", "kv@")),
            concurrency=d.get("concurrency", 4) or 4,
            engine_type=d.get("engineType", d.get("engine_type", "vllm")) or "vllm",
            discover_pods=d.get("discoverPods", d.get("discover_pods", False)),
            track_dp_rank=d.get("trackDPRank", d.get("track_dp_rank", False)),
            ingest_batch_max=64 if batch_max is None else batch_max,
            ingest_queue_max=8192 if queue_max is None else queue_max,
            ingest_zero_copy=True if zero_copy is None else bool(zero_copy),
            shm_ring_path=d.get("shmRingPath", d.get("shm_ring_path", "")) or "",
            shm_ring_bytes=(1 << 20) if ring_bytes is None else ring_bytes,
            shm_ring_poll_s=d.get(
                "shmRingPollS", d.get("shm_ring_poll_s", 0.0005)
            ),
            liveness_stale_after_s=d.get(
                "livenessStaleAfterSeconds",
                d.get("liveness_stale_after_s", 30.0),
            ),
            liveness_drop_after_s=d.get(
                "livenessDropAfterSeconds",
                d.get("liveness_drop_after_s", 120.0),
            ),
        )
        pdc = d.get("podDiscoveryConfig", d.get("pod_discovery_config"))
        if pdc:
            cfg.pod_discovery_config = PodDiscoveryConfig(
                pod_label_selector=pdc.get(
                    "podLabelSelector",
                    pdc.get("pod_label_selector", "llm-d.ai/inference-serving=true"),
                ),
                pod_namespace=pdc.get("podNamespace", pdc.get("pod_namespace", "")),
                socket_port=pdc.get("socketPort", pdc.get("socket_port", 5557)) or 5557,
            )
        return cfg


class Pool:
    """Sharded worker pool ingesting KV events into an index.

    Stateless: all key mappings are delegated to the Index, so multiple
    replicas ingesting the same stream converge to the same soft state.
    """

    def __init__(
        self,
        cfg: Optional[PoolConfig],
        index: Index,
        token_processor: ChunkedTokenDatabase,
        adapter: Optional[EngineAdapter] = None,
    ):
        self.cfg = cfg or PoolConfig()
        self.index = index
        self.token_processor = token_processor
        self.adapter = adapter if adapter is not None else create_adapter(self.cfg.engine_type)
        self.group_catalog = GroupCatalog()
        # Per-pod last-event tracking; scorers attached to this pool (via
        # Indexer.attach_liveness) demote pods whose index view went stale.
        self.liveness: Optional[PodLivenessTracker] = None
        if self.cfg.liveness_stale_after_s > 0:
            self.liveness = PodLivenessTracker(
                stale_after_s=self.cfg.liveness_stale_after_s,
                drop_after_s=max(self.cfg.liveness_drop_after_s,
                                 self.cfg.liveness_stale_after_s * 2),
            )
        # maxsize=0 means unbounded (queue.Queue semantics); see
        # PoolConfig.ingest_queue_max for the drop-oldest overflow policy.
        self._queues: list[queue.Queue] = [
            queue.Queue(maxsize=max(0, self.cfg.ingest_queue_max))
            for _ in range(self.cfg.concurrency)
        ]
        self._threads: list[threading.Thread] = []
        self._started = False
        self._shutdown = object()  # queue sentinel
        # Sharding-key → shard memo: pod cardinality is small and stable,
        # so add_task skips re-encoding + FNV-hashing per message. Bounded
        # defensively; a full reset on overflow just re-hashes.
        self._shard_cache: dict[str, int] = {}
        self._stats_mu = new_lock()
        # Ingestion telemetry, mirrored into Prometheus per drained batch.
        self.ingest_batches = 0
        self.ingest_messages = 0
        self.coalesced_ops = 0
        # Native data plane accounting (kvdiag "data_plane" section):
        # packed frames decoded zero-copy, and messages that arrived over
        # the shared-memory ring instead of the socket wire.
        self.zerocopy_batches = 0
        self.shm_messages = 0
        # Packed frames whose key arrays went to the index as arrays (the
        # index ``accepts_key_arrays``), bypassing the coalescer.
        self.array_adds = 0
        self._shm_ring = None
        self._shm_stop = threading.Event()
        self._shm_thread: Optional[threading.Thread] = None
        # Event-pipeline lag/staleness: per-pod last sequence +
        # timestamps for gap detection and index-staleness estimation, and
        # a bounded sample window for p50/p99 lag readouts (admin, bench).
        self._lag_mu = new_lock()
        self._pod_lag: dict[str, dict] = {}
        self.lag_samples: collections.deque = collections.deque(maxlen=4096)
        # Per-pod cache-efficiency ledger (Indexer owns it; the service
        # wires the same object here so store/evict events attribute).
        self.ledger = None
        # Queue-overflow accounting (bounded shards drop the oldest
        # message; recovery's anti-entropy repairs the resulting holes).
        self.dropped_events = 0
        # Optional journal hook (recovery.manager.attach_journal): called
        # with (pod_id, sequence, topic, payload, event_ts) for every
        # successfully parsed live message.
        self.journal_sink = None
        # Epoch-fenced membership (cluster.membership.MembershipTable,
        # attach_membership): live batches are write-fenced against the
        # publishing pod's lease + stamped epoch; a zombie's post-lease
        # writes never reach the index. Replay (warm restart) bypasses
        # the fence — those writes were already accepted once.
        self.membership = None
        self.fenced_batches = 0
        self._replaying = False
        self._tracer = tracer()
        self._recorder = flight_recorder()

    # -- lifecycle --

    def start(self) -> None:
        """Start worker threads (non-blocking, idempotent)."""
        if self._started:
            return
        self._started = True
        for i in range(self.cfg.concurrency):
            t = threading.Thread(
                target=self._worker, args=(i,), name=f"kvevents-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        if self.cfg.shm_ring_path:
            self._shm_stop.clear()
            self._shm_thread = threading.Thread(
                target=self._shm_reader, name="kvevents-shm-reader",
                daemon=True,
            )
            self._shm_thread.start()
        logger.info("started sharded event pool with %d workers", self.cfg.concurrency)

    def shutdown(self) -> None:
        """Drain queues and stop workers (idempotent)."""
        if not self._started:
            return
        if self._shm_thread is not None:
            self._shm_stop.set()
            self._shm_thread.join()
            self._shm_thread = None
        if self._shm_ring is not None:
            self._shm_ring.close()
            self._shm_ring = None
        for q in self._queues:
            q.put(self._shutdown)
        for t in self._threads:
            t.join()
        self._threads.clear()
        self._started = False

    def join(self) -> None:
        """Block until all currently queued tasks are processed (testing aid)."""
        for q in self._queues:
            q.join()

    # -- ingestion --

    def add_task(self, task: RawMessage) -> None:
        """Queue a raw message on the shard owned by its pod."""
        key = self.adapter.sharding_key(task)
        shard = self._shard_cache.get(key)
        if shard is None:
            if len(self._shard_cache) >= 8192:
                self._shard_cache.clear()
            shard = fnv1a_32(key.encode("utf-8")) % self.cfg.concurrency
            self._shard_cache[key] = shard
        q = self._queues[shard]
        dropped = 0
        while True:
            try:
                q.put_nowait(task)
                break
            except queue.Full:
                # Drop-oldest: the newest message carries the pod's current
                # truth, so it must land; the evicted hole is repaired by
                # anti-entropy (recovery.reconcile). task_done keeps the
                # unfinished-task count balanced for Pool.join().
                try:
                    q.get_nowait()
                    q.task_done()
                    dropped += 1
                except queue.Empty:  # lint: allow-swallow (worker drained the shard; retry the put)
                    pass
        if dropped:
            first = self.dropped_events == 0
            with self._stats_mu:
                self.dropped_events += dropped
            if first:
                self._recorder.record(
                    KIND_OVERFLOW,
                    {
                        "shard": shard,
                        "queue_max": self.cfg.ingest_queue_max,
                        "dropped": dropped,
                    },
                )
                logger.warning(
                    "event shard %d overflowed (ingestQueueMax=%d); dropping oldest",
                    shard, self.cfg.ingest_queue_max,
                )
            try:
                from ..metrics.collector import record_dropped_events

                record_dropped_events(shard, dropped)
            except Exception:  # pragma: no cover - metrics must never break intake  # lint: allow-swallow
                pass

    def _worker(self, worker_index: int) -> None:
        q = self._queues[worker_index]
        budget = max(1, self.cfg.ingest_batch_max)
        # One write-combining coalescer per worker for its whole lifetime
        # (flushed at every batch boundary): same sequential semantics as
        # a per-batch instance, without reallocating the buffers per drain
        # — and single-message batches whose one message carries several
        # digests now coalesce too.
        sink = _IngestCoalescer(self.index)
        while True:
            batch = [q.get()]  # lint: allow-no-deadline (worker parks for work; shutdown via sentinel)
            shutdown = batch[0] is self._shutdown
            # Opportunistic drain: everything already queued on this shard
            # (up to the budget) is one batch; the blocking get above keeps
            # the idle path latency-free.
            while not shutdown and len(batch) < budget:
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                batch.append(nxt)
                shutdown = nxt is self._shutdown
            try:
                msgs = [t for t in batch if t is not self._shutdown]
                if msgs:
                    self._process_raw_batch(msgs, worker_index, sink)
            finally:
                for _ in batch:
                    q.task_done()
            if shutdown:
                return

    def _process_raw_batch(self, msgs: list[RawMessage],
                           worker_index: int = 0, sink=None) -> None:
        """Process one drained batch, write-combining through a coalescer.

        ``sink`` is the worker's persistent :class:`_IngestCoalescer`;
        ``saved_ops`` accumulates across batches there, so this reports
        the delta. A None sink (direct calls in tests) gets a throwaway.
        """
        if sink is None:
            sink = _IngestCoalescer(self.index)
        ops_before = sink.saved_ops
        for msg in msgs:
            self._process_raw_message(msg, sink)
        sink.flush()
        coalesced = sink.saved_ops - ops_before
        with self._stats_mu:
            self.ingest_batches += 1
            self.ingest_messages += len(msgs)
            self.coalesced_ops += coalesced
        self._recorder.record(
            KIND_INGEST,
            {"shard": worker_index, "messages": len(msgs), "coalesced_ops": coalesced},
        )
        try:
            from ..metrics.collector import (
                EVENT_QUEUE_DEPTH,
                INDEX_STALENESS,
                record_ingest_batch,
            )

            record_ingest_batch(len(msgs), coalesced)
            EVENT_QUEUE_DEPTH.labels(str(worker_index)).set(
                self._queues[worker_index].qsize()
            )
            INDEX_STALENESS.set(self.index_staleness_s())
        except Exception:  # pragma: no cover - metrics must never break ingestion  # lint: allow-swallow
            pass

    def _process_raw_message(self, msg: RawMessage, sink=None) -> None:
        # Zero-copy data plane: packed KZC1 frames (events.packed) skip
        # the msgpack adapter entirely. 4-byte sniff, no import cost on
        # the msgpack path.
        if self.cfg.ingest_zero_copy and msg.payload[:4] == b"KZC1":
            self._process_packed_message(msg, sink)
            return
        try:
            pod_id, model_name, batch = self.adapter.parse_message(msg)
        except Exception:
            logger.exception("failed to parse message on topic %s", msg.topic)
            return
        self._track_lag(pod_id, msg.sequence, batch.timestamp)
        if self.journal_sink is not None:
            try:
                self.journal_sink(
                    pod_id, msg.sequence, msg.topic, msg.payload, batch.timestamp
                )
            except Exception:
                # Journaling is best-effort durability; it must never stall
                # or kill live ingestion.
                logger.exception("journal append failed for pod %s", pod_id)
        try:
            with self._tracer.span(
                "llm_d.kv_cache.events.ingest",
                parent_traceparent=batch.traceparent,
                pod=pod_id,
                model=model_name,
                event_count=len(batch.events),
                sequence=msg.sequence,
            ):
                self.process_event_batch(batch, pod_id, model_name, sink=sink)
        except Exception:
            # Catch-all: a backend failure on one message must never kill
            # the shard's worker thread.
            logger.exception("failed to process event batch from %s", pod_id)

    def _process_packed_message(self, msg: RawMessage, sink=None) -> None:
        """Zero-copy BlockStored ingest (docs/architecture.md "Native
        data plane"): decode one packed frame into numpy views over the
        payload buffer, with no per-key or per-token Python object made by
        the decode. Packed frames are
        engine-resident stores (DEFAULT_EVENT_SOURCE_TIER) with no
        extra-keys/LoRA/dp-rank sidecars; events needing those stay on
        the msgpack wire."""
        try:
            from .packed import decode_packed_batch

            pb = decode_packed_batch(msg.payload)
        except Exception:
            logger.exception(
                "failed to decode packed frame on topic %s", msg.topic
            )
            return
        self._track_lag(pb.pod_id, msg.sequence, pb.timestamp)
        if self.journal_sink is not None:
            try:
                self.journal_sink(
                    pb.pod_id, msg.sequence, msg.topic, msg.payload,
                    pb.timestamp,
                )
            except Exception:
                logger.exception("journal append failed for pod %s", pb.pod_id)
        if self.liveness is not None:
            self.liveness.touch(pb.pod_id)
        try:
            with self._tracer.span(
                "llm_d.kv_cache.events.ingest",
                pod=pb.pod_id,
                model=pb.model_name,
                event_count=1,
                sequence=msg.sequence,
                zero_copy=True,
            ):
                self._ingest_packed(pb, sink)
        except Exception:
            logger.exception(
                "failed to process packed batch from %s", pb.pod_id
            )
            return
        with self._stats_mu:
            self.zerocopy_batches += 1
        try:
            from ..metrics.collector import record_zerocopy_batch

            record_zerocopy_batch()
        except Exception:  # pragma: no cover - metrics must never break ingestion  # lint: allow-swallow
            pass

    def _ingest_packed(self, pb, sink=None) -> None:
        """Apply one decoded packed frame to the index."""
        ops = sink if sink is not None else self.index
        parent_request_key = EMPTY_BLOCK_HASH
        if pb.parent_hash != 0:
            resolved = ops.get_request_key(pb.parent_hash)
            if resolved is None:
                logger.debug(
                    "no request key for packed parent %d (pod %s); dropping",
                    pb.parent_hash, pb.pod_id,
                )
                return
            parent_request_key = resolved
        tp = self.token_processor
        # Same chain the msgpack path derives, minus the Python detour:
        # model-seeded root, then the native FNV chain over the uint32
        # token view. A native failure raises into the frame's error log
        # (``_process_packed_message``): the chain never switches to
        # Python quietly.
        parent = (parent_request_key if parent_request_key != EMPTY_BLOCK_HASH
                  else tp._get_init_hash(pb.model_name))
        request_keys, keys_arr = native.hash_chain_with_array(
            parent, pb.tokens, tp.block_size)
        tp.hash_calls += len(request_keys)
        if not request_keys:
            return
        pod_entries = [PodEntry(pod_identifier=pb.pod_id,
                                device_tier=DEFAULT_EVENT_SOURCE_TIER)]
        try:
            if getattr(self.index, "accepts_key_arrays", False):
                # Array fast path: hand the views straight to the native
                # index. The coalescer buffers Python lists, so it is
                # flushed (ordering preserved) and bypassed here.
                if sink is not None:
                    sink.flush()
                self.index.add(pb.engine_keys, keys_arr, pod_entries)
                with self._stats_mu:
                    self.array_adds += 1
            else:
                ops.add(pb.engine_keys.tolist(), request_keys, pod_entries)
        except Exception:
            logger.exception(
                "failed to add packed batch to index for pod %s", pb.pod_id
            )
            return
        if self.ledger is not None:
            self.ledger.record_store(pb.pod_id, len(request_keys))

    def _shm_reader(self) -> None:
        """Drain packed frames from the shared-memory ring into the
        normal sharded queues. Attach-side: the writer creates the ring
        file, so keep retrying until it exists."""
        from .shm_ring import ShmRing

        poll_s = max(0.0001, self.cfg.shm_ring_poll_s)
        seqs: dict[str, int] = {}
        while not self._shm_stop.is_set():
            if self._shm_ring is None:
                try:
                    self._shm_ring = ShmRing(self.cfg.shm_ring_path)
                except (OSError, ValueError):  # lint: allow-swallow (writer not up yet; retry)
                    self._shm_stop.wait(0.05)
                    continue
            record = self._shm_ring.read()
            if record is None:
                self._shm_stop.wait(poll_s)
                continue
            # Cheap header peek for the sharding topic; the worker decodes
            # the same frame again (struct-only, no array copies either
            # time).
            try:
                from .packed import decode_packed_batch

                pb = decode_packed_batch(record)
            except Exception:
                logger.exception("malformed shm-ring record; skipping")
                continue
            seq = seqs.get(pb.pod_id, 0) + 1
            seqs[pb.pod_id] = seq
            with self._stats_mu:
                self.shm_messages += 1
            try:
                from ..metrics.collector import record_shm_messages

                record_shm_messages(1)
            except Exception:  # pragma: no cover - metrics must never break ingestion  # lint: allow-swallow
                pass
            self.add_task(RawMessage(
                topic=f"kv@{pb.pod_id}@{pb.model_name}",
                sequence=seq,
                payload=record,
            ))

    def _track_lag(self, pod_id: str, sequence: int, event_ts: float) -> None:
        """Per-pod sequence-gap + publish→ingest lag bookkeeping.

        Lag compares the publisher's wall clock against ours, so cross-host
        skew leaks in; within one cluster (NTP-disciplined) it is still the
        right staleness signal, and sequence gaps are skew-free.
        """
        now = time.time()
        lag_s = max(0.0, now - event_ts)
        with self._lag_mu:
            st = self._pod_lag.get(pod_id)
            if st is None:
                st = self._pod_lag[pod_id] = {
                    "last_seq": sequence,
                    "last_event_ts": event_ts,
                    "last_ingest_ts": now,
                    "lag_s": lag_s,
                    "seq_gaps": 0,
                    "messages": 1,
                }
                gap = 0
            else:
                gap = max(0, sequence - st["last_seq"] - 1) if sequence > st["last_seq"] else 0
                st["seq_gaps"] += gap
                st["last_seq"] = max(st["last_seq"], sequence)
                st["last_event_ts"] = max(st["last_event_ts"], event_ts)
                st["last_ingest_ts"] = now
                st["lag_s"] = lag_s
                st["messages"] += 1
            self.lag_samples.append(lag_s)
        try:
            from ..metrics.collector import record_event_lag

            record_event_lag(pod_id, lag_s, gap)
        except Exception:  # pragma: no cover - metrics must never break ingestion  # lint: allow-swallow
            pass

    def replay_record(self, topic: str, sequence: int, payload: bytes) -> None:
        """Synchronously re-ingest one journaled message (warm restart).

        Runs the normal parse → track-lag → process path on the caller's
        thread, bypassing the shard queues; call before ``start()`` /
        before live subscriptions so replay is ordered ahead of live
        traffic. The journal sink must not be attached yet, or replayed
        records would be re-journaled.
        """
        self._replaying = True
        try:
            self._process_raw_message(RawMessage(topic=topic, sequence=sequence,
                                                 payload=payload))
        finally:
            self._replaying = False

    def seed_sequences(self, pod_seqs: dict, event_ts: float) -> None:
        """Seed per-pod watermarks from a snapshot (recovery.manager).

        Lets sequence-gap detection span a restart, and makes
        ``index_staleness_s`` reflect the snapshot's age until live events
        catch up — which is the warmup readiness gate. Pods that already
        progressed past the seed (journal replay, live traffic) keep their
        newer watermark.
        """
        now = time.time()
        with self._lag_mu:
            for pod, seq in pod_seqs.items():
                st = self._pod_lag.get(pod)
                if st is None:
                    self._pod_lag[pod] = {
                        "last_seq": int(seq),
                        "last_event_ts": float(event_ts),
                        "last_ingest_ts": now,
                        "lag_s": 0.0,
                        "seq_gaps": 0,
                        "messages": 0,
                    }
                elif int(seq) > st["last_seq"]:
                    st["last_seq"] = int(seq)
                    st["last_event_ts"] = max(st["last_event_ts"], float(event_ts))

    def index_staleness_s(self, now: Optional[float] = None) -> float:
        """Upper-bound age of the index's view of the slowest pod: the
        oldest per-pod last-event timestamp, measured against now. 0 when
        no events have been seen."""
        now = time.time() if now is None else now
        with self._lag_mu:
            if not self._pod_lag:
                return 0.0
            oldest = min(st["last_event_ts"] for st in self._pod_lag.values())
        return max(0.0, now - oldest)

    def attach_membership(self, membership) -> None:
        """Enable the ingest write fence: every live batch is checked
        against ``membership`` (publisher lease validity + stamped epoch)
        before its events touch the index."""
        self.membership = membership

    def data_plane_debug(self) -> dict:
        """Zero-copy / shm-ring ingest counters (kvdiag ``data_plane``)."""
        with self._stats_mu:
            return {
                "zerocopy_batches": self.zerocopy_batches,
                "shm_messages": self.shm_messages,
                "fenced_batches": self.fenced_batches,
            }

    def lag_stats(self) -> dict:
        """Lag/staleness snapshot for the admin endpoint and kvdiag."""
        with self._lag_mu:
            pods = {
                pod: {k: v for k, v in st.items()}
                for pod, st in self._pod_lag.items()
            }
            samples = list(self.lag_samples)
            # Inline (index_staleness_s re-takes the non-reentrant lock).
            oldest = min(
                (st["last_event_ts"] for st in self._pod_lag.values()),
                default=None,
            )
        stats: dict = {
            "pods": pods,
            "staleness_s": 0.0 if oldest is None else max(0.0, time.time() - oldest),
            "queue_depths": [q.qsize() for q in self._queues],
        }
        if samples:
            samples.sort()
            n = len(samples)
            stats["lag_p50_s"] = samples[n // 2]
            stats["lag_p99_s"] = samples[min(n - 1, (n * 99) // 100)]
        return stats

    # -- event semantics --

    def process_event_batch(
        self, batch: EventBatch, pod_identifier: str, model_name: str,
        sink=None,
    ) -> None:
        """Apply a parsed event batch to the index (``pool.go:302-479``).

        ``sink`` (an :class:`_IngestCoalescer`) substitutes for the index
        during batched worker drains; all index writes/reads route through
        it so consecutive digests can be write-combined.
        """
        if self.membership is not None and not self._replaying:
            # Zombie fence (cluster.membership): a publisher whose lease
            # lapsed — a pod that stalled past its TTL and resumed — or
            # whose stamped epoch is stale gets its writes dropped (or
            # flagged, per fenceMode) BEFORE they can poison the index
            # with placement the fleet no longer agrees on.
            fence = self.membership.check_write(
                pod_identifier, batch.epoch, "events.ingest")
            if not fence.allowed:
                self.fenced_batches += 1
                logger.warning(
                    "dropped fenced event batch from pod %s (%s; epoch=%d)",
                    pod_identifier, fence.reason, batch.epoch)
                return
        if (
            self.cfg.track_dp_rank
            and batch.data_parallel_rank is not None
            and batch.data_parallel_rank >= 0
        ):
            pod_identifier = f"{pod_identifier}|dp{batch.data_parallel_rank}"

        # Any event from a pod proves its publisher (and thus our view of
        # it) is alive; touch AFTER dp-rank suffixing so routing-visible
        # identifiers are the ones tracked.
        if self.liveness is not None:
            self.liveness.touch(pod_identifier)

        ops = sink if sink is not None else self.index
        for event in batch.events:
            if isinstance(event, BlockStoredEvent):
                self._handle_block_stored(event, pod_identifier, model_name, ops)
            elif isinstance(event, BlockRemovedEvent):
                self._handle_block_removed(event, pod_identifier, ops)
            elif isinstance(event, AllBlocksClearedEvent):
                # Pod-wide: engines emit this with no tier; a tier-scoped
                # clear is unsupported and would over-wipe.
                try:
                    ops.clear(pod_identifier)
                except Exception:
                    logger.exception("failed to clear pod %s", pod_identifier)
                else:
                    if self.ledger is not None:
                        self.ledger.record_clear(pod_identifier)
            else:  # pragma: no cover - adapter produces only known events
                logger.debug("unknown event from pod %s: %r", pod_identifier, event)

    def _handle_block_stored(
        self, ev: BlockStoredEvent, pod_identifier: str, model_name: str,
        ops: Index,
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
            try:
                resolved = ops.get_request_key(ev.parent_hash)
            except Exception:
                logger.exception("parent key resolution failed (pod %s)", pod_identifier)
                resolved = None
            if resolved is None:
                logger.debug(
                    "no request key for parent engine key %d (pod %s); dropping event",
                    ev.parent_hash, pod_identifier,
                )
                return
            parent_request_key = resolved

        extra_features: Optional[list[Optional[BlockExtraFeatures]]] = None
        if ev.extra_keys is not None:
            try:
                extra_features = parse_raw_extra_keys(ev.extra_keys)
            except Exception:
                logger.exception("failed to parse extra keys from pod %s", pod_identifier)
                return

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
            self._handle_device_tier_update(
                ev.tokens, engine_keys, pod_entries, pod_identifier, device_tier, ops
            )
            return

        try:
            ops.add(engine_keys, request_keys, pod_entries)
        except Exception:
            logger.exception("failed to add event to index for pod %s", pod_identifier)
        else:
            if self.ledger is not None:
                self.ledger.record_store(pod_identifier, len(request_keys))

    def _handle_device_tier_update(
        self,
        tokens: list[int],
        engine_keys: list[BlockHash],
        pod_entries: list[PodEntry],
        pod_identifier: str,
        device_tier: str,
        ops: Index,
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
            try:
                rk = ops.get_request_key(ek)
            except Exception:
                logger.exception("engine key resolution failed (pod %s)", pod_identifier)
                continue
            if rk is None or rk in seen:
                continue
            seen.add(rk)
            resolved.append(rk)

        if resolved:
            try:
                ops.add(None, resolved, pod_entries)
            except Exception:
                logger.exception(
                    "failed to add device-tier update (pod %s, tier %s)",
                    pod_identifier, device_tier,
                )
        else:
            logger.debug(
                "no indexed engine keys for device-tier update (pod %s, %d keys)",
                pod_identifier, len(engine_keys),
            )

    def _handle_block_removed(
        self, ev: BlockRemovedEvent, pod_identifier: str, ops: Index
    ) -> None:
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
        try:
            ops.evict_batch(ev.block_hashes, KeyType.ENGINE, [pod_entry])
        except Exception:
            logger.exception(
                "failed to evict %d engine keys from pod %s",
                len(ev.block_hashes), pod_identifier,
            )
        else:
            if self.ledger is not None:
                self.ledger.record_evict(pod_identifier, len(ev.block_hashes))


class _IngestCoalescer:
    """Write-combining Index facade for one drained worker batch.

    Duck-types the slice of the Index contract the event handlers use
    (``add``/``evict_batch``/``get_request_key``/``clear``). Consecutive
    homogeneous writes buffer and merge; any differing operation flushes
    the buffer first, so the index observes the same sequential semantics
    as per-message processing — just with fewer calls (fewer lock
    acquisitions, interning passes and Redis round-trips).

    Coalescing rules:

    - only 1:1 engine:request ``add`` digests with identical pod entries
      merge — concatenation preserves the inferred mappings exactly when
      each position maps to itself and no engine key repeats in the buffer
    - ``evict_batch`` runs with identical key type + entries merge
    - ``get_request_key`` is answered from the pending add buffer when
      possible (chained digests stay coalesced); otherwise pending evicts
      flush first (they could have removed the mapping), then the index is
      asked. A pending add for *other* keys cannot change the answer and
      stays buffered.
    - ``clear`` flushes everything, then clears.
    """

    def __init__(self, index: Index):
        self.index = index
        self.saved_ops = 0  # index calls absorbed by merging
        # pending add: [engine_keys, request_keys, entries_sig, entries,
        #               engine_key → request_key]
        self._add: Optional[list] = None
        # pending evict: [(key_type, entries_sig), keys, entries]
        self._evict: Optional[list] = None

    # -- flushing ---------------------------------------------------------

    def _flush_add(self) -> None:
        if self._add is None:
            return
        engine_keys, request_keys, _, entries, _ = self._add
        self._add = None
        try:
            self.index.add(engine_keys, request_keys, entries)
        except Exception:
            logger.exception("coalesced add of %d keys failed", len(request_keys))

    def _flush_evict(self) -> None:
        if self._evict is None:
            return
        (key_type, _), keys, entries = self._evict
        self._evict = None
        try:
            self.index.evict_batch(keys, key_type, entries)
        except Exception:
            logger.exception("coalesced evict of %d keys failed", len(keys))

    def flush(self) -> None:
        """Write out all buffered operations (end of the drained batch)."""
        # At most one kind is pending (starting either flushes the other).
        self._flush_evict()
        self._flush_add()

    # -- Index surface used by the handlers -------------------------------

    def add(self, engine_keys, request_keys, entries) -> None:
        self._flush_evict()
        if engine_keys is None or len(engine_keys) != len(request_keys):
            self._flush_add()
            self.index.add(engine_keys, request_keys, entries)
            return
        sig = tuple(entries)
        if self._add is not None:
            b_ek, b_rk, b_sig, _, b_map = self._add
            if b_sig == sig and not any(ek in b_map for ek in engine_keys):
                b_ek.extend(engine_keys)
                b_rk.extend(request_keys)
                b_map.update(zip(engine_keys, request_keys))
                self.saved_ops += 1
                return
            self._flush_add()
        self._add = [
            list(engine_keys), list(request_keys), sig, list(entries),
            dict(zip(engine_keys, request_keys)),
        ]

    def evict_batch(self, keys, key_type, entries) -> None:
        self._flush_add()
        sig = (key_type, tuple(entries))
        if self._evict is not None:
            if self._evict[0] == sig:
                self._evict[1].extend(keys)
                self.saved_ops += 1
                return
            self._flush_evict()
        self._evict = [sig, list(keys), list(entries)]

    def get_request_key(self, engine_key):
        if self._add is not None:
            rk = self._add[4].get(engine_key)
            if rk is not None:
                return rk
        self._flush_evict()
        return self.index.get_request_key(engine_key)

    def clear(self, pod_identifier: str) -> None:
        self.flush()
        self.index.clear(pod_identifier)


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
