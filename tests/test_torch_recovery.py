"""The recovery plane of the port (``llmd_kv_cache_tpu_torch/recovery``)
against the JAX package's.

First the JAX package's own cases (``tests/test_recovery.py``: snapshot
format and store, journal framing and torn tails, warm restart and the
readiness gate, bounded queues, anti-entropy, ``/healthz``, the drain's
deadline) and its kill-and-warm-restart scenario
(``tests/test_failure_recovery.py::TestKillAndWarmRestart``), run on the
port. Then the port against the JAX package on shared inputs made from a
numpy seed: the CBOR decoder's verdicts, snapshot and journal files
byte-identical and read across the packages (a torn journal stops at the
same record), ``IndexerConfig``'s ``recoveryConfig``, the reconciler's and
the auditor's reports and repaired states, and a warm restart's
``dump_state`` after the same traffic.
"""

import dataclasses
import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest

from llmd_kv_cache_tpu_torch.core.keys import TIER_TPU_HBM, PodEntry
from llmd_kv_cache_tpu_torch.core.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llmd_kv_cache_tpu_torch.events import Pool, PoolConfig
from llmd_kv_cache_tpu_torch.events.model import RawMessage
from llmd_kv_cache_tpu_torch.index import InMemoryIndex, InMemoryIndexConfig
from llmd_kv_cache_tpu_torch.recovery import (
    AntiEntropyReconciler,
    DrainCoordinator,
    EventJournal,
    IndexDigestSource,
    RecoveryConfig,
    RecoveryManager,
    SnapshotError,
    SnapshotStore,
    STATE_READY,
    STATE_WARMING,
    decode_snapshot,
    encode_snapshot,
)
from llmd_kv_cache_tpu_torch.services.admin import AdminServer
from llmd_kv_cache_tpu_torch.utils.msgpack_codec import packb

from torch_telemetry_helpers import private_jax_metrics, private_port_metrics

BLOCK = 4
MODEL = "m"


@pytest.fixture(autouse=True)
def private_metrics(monkeypatch):
    """Both packages' collector families on registries of the test's own
    (snapshots, warm restarts, drains, audits and repairs record them)."""
    private_jax_metrics(monkeypatch)
    private_port_metrics(monkeypatch)


def _entry(pod="pod-a", tier=TIER_TPU_HBM, **kw):
    return PodEntry(pod_identifier=pod, device_tier=tier, **kw)


def _raw(pod: str, seq: int, hashes, tokens, ts=None) -> RawMessage:
    payload = packb(
        [ts if ts is not None else time.time(),
         [["BlockStored", list(hashes), None, list(tokens), BLOCK, None]]])
    return RawMessage(topic=f"kv@{pod}@{MODEL}", sequence=seq, payload=payload)


# ---------------------------------------------------------------------------
# Snapshot format + store
# ---------------------------------------------------------------------------


class TestSnapshotFormat:
    def test_round_trip(self):
        doc = {"version": 1, "pod_seqs": {"pod-a": 7},
               "index": {"entries": [[1, [["pod-a", "tier", 0, 0]]]],
                         "mappings": []}}
        assert decode_snapshot(encode_snapshot(doc)) == doc

    def test_bad_magic_rejected(self):
        with pytest.raises(SnapshotError, match="magic"):
            decode_snapshot(b"NOTASNAPSHOT" + b"\x00" * 64)

    def test_flipped_byte_rejected(self):
        blob = bytearray(encode_snapshot({"version": 1}))
        blob[len(blob) // 2] ^= 0xFF
        with pytest.raises(SnapshotError):
            decode_snapshot(bytes(blob))

    def test_truncation_rejected(self):
        blob = encode_snapshot({"version": 1, "pad": "x" * 64})
        with pytest.raises(SnapshotError):
            decode_snapshot(blob[: len(blob) - 5])


class TestSnapshotStore:
    def test_save_load_and_retention(self, tmp_path):
        store = SnapshotStore(str(tmp_path), keep=2)
        for i in range(4):
            store.save({"version": 1, "n": i})
        names = sorted(os.listdir(tmp_path))
        assert names == ["index-00000003.snap", "index-00000004.snap"]
        doc, path = store.load_newest()
        assert doc["n"] == 3 and path.endswith("index-00000004.snap")

    def test_corrupt_newest_quarantined_falls_back(self, tmp_path):
        store = SnapshotStore(str(tmp_path), keep=3)
        store.save({"version": 1, "n": 0})
        newest = store.save({"version": 1, "n": 1})
        with open(newest, "r+b") as f:
            f.seek(20)
            f.write(b"\xde\xad")
        doc, path = store.load_newest()
        assert doc["n"] == 0 and path.endswith("index-00000001.snap")
        assert os.path.exists(newest + ".quarantine")
        assert not os.path.exists(newest)
        assert store.quarantined == 1

    def test_all_corrupt_returns_none(self, tmp_path):
        store = SnapshotStore(str(tmp_path), keep=3)
        p = store.save({"version": 1})
        with open(p, "wb") as f:
            f.write(b"garbage")
        assert store.load_newest() is None
        assert store.quarantined == 1


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------


class TestEventJournal:
    def test_append_replay_with_watermarks(self, tmp_path):
        path = str(tmp_path / "j")
        j = EventJournal(path, sync_every=2)
        j.append("pod-a", 1, "kv@pod-a@m", b"p1", 10.0)
        j.append("pod-a", 2, "kv@pod-a@m", b"p2", 11.0)
        j.append("pod-b", 1, "kv@pod-b@m", b"q1", 12.0)
        j.close()
        got = [(r.pod_id, r.sequence, r.payload)
               for r in EventJournal(path).replay({"pod-a": 1})]
        assert got == [("pod-a", 2, b"p2"), ("pod-b", 1, b"q1")]

    def test_torn_tail_tolerated(self, tmp_path):
        path = str(tmp_path / "j")
        j = EventJournal(path)
        j.append("pod-a", 1, "t", b"x", 1.0)
        j.close()
        with open(path, "ab") as f:
            f.write(b"\xff\xff\xff")  # partial header from a crash
        assert len(list(EventJournal(path).replay())) == 1

    def test_corrupt_record_stops_replay(self, tmp_path):
        path = str(tmp_path / "j")
        j = EventJournal(path)
        j.append("pod-a", 1, "t", b"x", 1.0)
        size_one = os.path.getsize(path)
        j.append("pod-a", 2, "t", b"y", 2.0)
        j.close()
        with open(path, "r+b") as f:
            f.seek(size_one + 10)
            f.write(b"\xee")
        recs = list(EventJournal(path).replay())
        assert [r.sequence for r in recs] == [1]

    def test_rotate_restarts_empty(self, tmp_path):
        path = str(tmp_path / "j")
        j = EventJournal(path)
        j.append("pod-a", 1, "t", b"x", 1.0)
        j.rotate()
        assert list(j.replay()) == []
        j.append("pod-a", 2, "t", b"y", 2.0)
        j.close()
        assert [r.sequence for r in EventJournal(path).replay()] == [2]


# ---------------------------------------------------------------------------
# Warm restart + readiness gate
# ---------------------------------------------------------------------------


def _stack(queue_max=0):
    processor = ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=BLOCK))
    index = InMemoryIndex(InMemoryIndexConfig(size=10_000))
    pool = Pool(PoolConfig(concurrency=1, ingest_queue_max=queue_max),
                index, processor)
    return processor, index, pool


class TestWarmRestart:
    def test_cold_start_is_ready_immediately(self, tmp_path):
        _p, index, pool = _stack()
        mgr = RecoveryManager(
            RecoveryConfig(snapshot_dir=str(tmp_path), snapshot_interval_s=0),
            index, pool)
        summary = mgr.warm_restart()
        assert summary["restored_entries"] == 0
        assert mgr.state == STATE_READY
        mgr.stop(final_snapshot=False)

    def test_snapshot_restore_replay_and_warmup(self, tmp_path):
        cfg = RecoveryConfig(snapshot_dir=str(tmp_path), snapshot_interval_s=0,
                             warmup_staleness_bound_s=1.0)
        processor, index, pool = _stack()
        pool.start()
        mgr = RecoveryManager(cfg, index, pool)
        mgr.attach_journal()
        old_ts = time.time() - 30.0  # events "published" 30s ago
        pool.add_task(_raw("pod-a", 1, [1, 2], list(range(8)), ts=old_ts))
        pool.join()
        rks = processor.tokens_to_kv_block_keys(0, list(range(8)), MODEL)
        assert len(index.lookup(rks)) == 2
        assert mgr.snapshot_now("test") is not None
        # Past the snapshot: journal-only territory.
        pool.add_task(_raw("pod-a", 2, [3, 4], list(range(100, 108)), ts=old_ts))
        pool.join()
        rks2 = processor.tokens_to_kv_block_keys(0, list(range(100, 108)), MODEL)
        pool.shutdown()  # crash: no final snapshot

        processor2, index2, pool2 = _stack()
        mgr2 = RecoveryManager(cfg, index2, pool2)
        summary = mgr2.warm_restart()
        assert summary["restored_entries"] >= 2
        assert summary["replayed_records"] == 1
        assert len(index2.lookup(rks)) == 2   # from the snapshot
        assert len(index2.lookup(rks2)) == 2  # from the journal
        # The replayed events are 30s old: still warming under a 1s bound.
        assert mgr2.state == STATE_WARMING
        assert not mgr2.ready
        # A fresh live event clears the staleness gate.
        pool2.start()
        pool2.add_task(_raw("pod-a", 3, [5], list(range(200, 204))))
        pool2.join()
        assert mgr2.state == STATE_READY and mgr2.ready
        mgr2.stop(final_snapshot=False)
        pool2.shutdown()

    def test_stop_detaches_journal_sink(self, tmp_path):
        _p, index, pool = _stack()
        mgr = RecoveryManager(
            RecoveryConfig(snapshot_dir=str(tmp_path), snapshot_interval_s=0),
            index, pool)
        mgr.attach_journal()
        assert pool.journal_sink is not None
        mgr.stop(final_snapshot=False)
        assert pool.journal_sink is None

    def test_sequence_watermark_survives_restart(self, tmp_path):
        cfg = RecoveryConfig(snapshot_dir=str(tmp_path), snapshot_interval_s=0)
        _p, index, pool = _stack()
        pool.start()
        mgr = RecoveryManager(cfg, index, pool)
        mgr.attach_journal()
        pool.add_task(_raw("pod-a", 9, [1], list(range(4))))
        pool.join()
        mgr.snapshot_now("test")
        pool.shutdown()

        _p2, index2, pool2 = _stack()
        mgr2 = RecoveryManager(cfg, index2, pool2)
        mgr2.warm_restart()
        pool2.start()
        # Sequences 10..14 were lost while down; the restarted pool must
        # notice the hole against the seeded watermark (9 -> 15 = 5 gap).
        pool2.add_task(_raw("pod-a", 15, [2], list(range(8))))
        pool2.join()
        assert pool2.lag_stats()["pods"]["pod-a"]["seq_gaps"] == 5
        mgr2.stop(final_snapshot=False)
        pool2.shutdown()


# ---------------------------------------------------------------------------
# Bounded shard queues
# ---------------------------------------------------------------------------


class TestBoundedQueues:
    def test_drop_oldest_overflow(self):
        _p, _index, pool = _stack(queue_max=4)  # workers not started
        for seq in range(10):
            pool.add_task(_raw("pod-a", seq, [seq], list(range(4))))
        assert pool.dropped_events == 6
        q = pool._queues[0]
        assert q.qsize() == 4
        # The newest messages survived (drop-oldest, not drop-newest).
        kept = [q.get_nowait().sequence for _ in range(4)]
        assert kept == [6, 7, 8, 9]

    def test_join_accounting_survives_drops(self):
        _p, index, pool = _stack(queue_max=2)
        for seq in range(6):
            pool.add_task(_raw("pod-a", seq, [seq], list(range(4))))
        pool.start()
        pool.join()  # must not deadlock despite 4 dropped tasks
        pool.shutdown()
        assert pool.dropped_events == 4

    def test_unbounded_when_zero(self):
        _p, _index, pool = _stack(queue_max=0)
        for seq in range(100):
            pool.add_task(_raw("pod-a", seq, [seq], list(range(4))))
        assert pool.dropped_events == 0
        assert pool._queues[0].qsize() == 100


# ---------------------------------------------------------------------------
# Anti-entropy
# ---------------------------------------------------------------------------


class TestAntiEntropy:
    def test_diverged_replica_converges_then_stays_clean(self):
        truth = InMemoryIndex(InMemoryIndexConfig())
        local = InMemoryIndex(InMemoryIndexConfig())
        truth.add(None, [11, 12], [_entry("pod-a")])
        truth.add(None, [12], [_entry("pod-b", speculative=True)])
        local.add(None, [11], [_entry("pod-a")])   # missing 12
        local.add(None, [99], [_entry("pod-a")])   # stale extra
        rec = AntiEntropyReconciler(local, IndexDigestSource(truth))
        stats = rec.reconcile_once()
        assert sorted(stats["divergent"]) == ["pod-a", "pod-b"]
        assert stats["repaired_added"] == 2 and stats["repaired_removed"] == 1
        assert set(local.lookup([11, 12, 99])) == {11, 12}
        assert local.lookup([12])[12] == truth.lookup([12])[12]
        # Converged: the next round exchanges digests only.
        assert AntiEntropyReconciler(
            local, IndexDigestSource(truth)).reconcile_once()["divergent"] == []

    def test_matching_digests_touch_nothing(self):
        truth = InMemoryIndex(InMemoryIndexConfig())
        local = InMemoryIndex(InMemoryIndexConfig())
        for idx in (truth, local):
            idx.add(None, [5], [_entry("pod-a")])
        rec = AntiEntropyReconciler(local, IndexDigestSource(truth))
        stats = rec.reconcile_once()
        assert stats["divergent"] == []
        assert stats["repaired_added"] == stats["repaired_removed"] == 0


# ---------------------------------------------------------------------------
# /healthz readiness gate
# ---------------------------------------------------------------------------


class TestHealthzGate:
    def _get(self, port):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def test_warming_serves_503_then_ready_200(self):
        health = {"status": "warming", "state": "warming"}
        server = AdminServer(port=0, expose_debug=False,
                             health=lambda: dict(health))
        port = server.start()
        try:
            status, body = self._get(port)
            assert status == 503 and body["state"] == "warming"
            health["status"] = "ok"
            health["state"] = "ready"
            status, body = self._get(port)
            assert status == 200 and body["state"] == "ready"
        finally:
            server.stop()

    def test_default_health_unchanged(self):
        server = AdminServer(port=0, expose_debug=False)
        port = server.start()
        try:
            assert self._get(port) == (200, {"status": "ok"})
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# Drain deadline
# ---------------------------------------------------------------------------


class _SlowOffload:
    def __init__(self, busy_for_s):
        self._until = time.monotonic() + busy_for_s

    def flush(self, deadline_s: float) -> bool:
        t_end = time.monotonic() + deadline_s
        while time.monotonic() < self._until:
            if time.monotonic() >= t_end:
                return False
            time.sleep(0.01)
        return True


class TestDrainDeadline:
    def test_fast_drain_completes_all_steps(self, tmp_path):
        _p, index, pool = _stack()
        pool.start()
        mgr = RecoveryManager(
            RecoveryConfig(snapshot_dir=str(tmp_path), snapshot_interval_s=0),
            index, pool)
        mgr.attach_journal()
        stopped = []
        coordinator = DrainCoordinator(
            deadline_s=5.0,
            intake_stoppers=[lambda: stopped.append(True)],
            pool=pool,
            offload=_SlowOffload(0.0),
            manager=mgr,
        )
        report = coordinator.drain()
        assert report["completed"] is True
        assert stopped == [True]
        assert report["steps"] == {
            "stop_intake": True, "drain_pool": True,
            "flush_offload": True, "final_snapshot": True,
        }
        # The final snapshot landed on disk.
        assert any(n.endswith(".snap") for n in os.listdir(tmp_path))

    def test_deadline_abandons_slow_steps(self, tmp_path):
        _p, index, pool = _stack()
        pool.start()
        mgr = RecoveryManager(
            RecoveryConfig(snapshot_dir=str(tmp_path), snapshot_interval_s=0,
                           drain_deadline_s=0.3),
            index, pool)
        coordinator = DrainCoordinator(
            deadline_s=0.3,
            pool=pool,
            offload=_SlowOffload(30.0),  # will never finish in budget
            manager=mgr,
        )
        start = time.monotonic()
        report = coordinator.drain()
        elapsed = time.monotonic() - start
        assert report["completed"] is False
        assert report["steps"]["flush_offload"] is False
        assert elapsed < 5.0  # deadline enforced, not the 30s flush

    def test_drain_is_idempotent(self):
        _p, _index, pool = _stack()
        pool.start()
        coordinator = DrainCoordinator(deadline_s=2.0, pool=pool)
        first = coordinator.drain()
        assert coordinator.drain() is first or coordinator.drain() == first


# ---------------------------------------------------------------------------
# Kill and warm restart, end to end (tests/test_failure_recovery.py)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_until(cond, timeout=6.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return bool(cond())


@pytest.mark.chaos
class TestKillAndWarmRestart:
    def test_kill_warm_restart_converges(self, tmp_path):
        """An indexer dies uncleanly mid-stream; a replacement boots from the
        last snapshot, replays the journal tail, serves degraded scores
        behind a 503 readiness gate, repairs the crash window by
        anti-entropy and goes ready once live events clear the staleness
        bound."""
        import urllib.error

        from llmd_kv_cache_tpu_torch.events import ZMQSubscriber
        from llmd_kv_cache_tpu_torch.events.model import BlockStoredEvent
        from llmd_kv_cache_tpu_torch.events.publisher import KVEventPublisher
        from llmd_kv_cache_tpu_torch.recovery import STATE_READY, STATE_WARMING
        from llmd_kv_cache_tpu_torch.scoring.indexer import IndexerConfig
        from llmd_kv_cache_tpu_torch.services.indexer_service import (
            IndexerService,
            ScoreRequest,
        )

        endpoint = f"tcp://127.0.0.1:{_free_port()}"
        snapdir = str(tmp_path / "snaps")

        def make_service():
            return IndexerService(
                IndexerConfig(
                    token_processor_config=TokenProcessorConfig(block_size_tokens=BLOCK),
                    recovery_config=RecoveryConfig(
                        snapshot_dir=snapdir,
                        snapshot_interval_s=0,  # snapshots manual in-test
                        warmup_staleness_bound_s=1.0,
                        drain_deadline_s=5.0,
                    ),
                ),
                PoolConfig(concurrency=1),
            )

        def pub_until(publisher, hashes, tokens, index, rks):
            for _ in range(20):
                publisher.publish([BlockStoredEvent(
                    block_hashes=hashes, tokens=tokens, parent_hash=0, block_size=BLOCK)])
                if wait_until(lambda: len(index.lookup(rks)) == len(rks), timeout=0.5):
                    return True
            return False

        def healthz(port):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                            timeout=5) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        t1, t2, t3 = list(range(8)), list(range(100, 108)), list(range(200, 208))
        svc1 = make_service()
        svc1.start()
        index1 = svc1.indexer.kv_block_index
        processor = svc1.indexer.token_processor
        rk1 = processor.tokens_to_kv_block_keys(0, t1, MODEL)
        rk2 = processor.tokens_to_kv_block_keys(0, t2, MODEL)
        rk3 = processor.tokens_to_kv_block_keys(0, t3, MODEL)
        sub1 = ZMQSubscriber(endpoint, "kv@", svc1.pool.add_task, bind=False)
        sub1.start()
        pub = KVEventPublisher(endpoint, "pod-a", MODEL, bind=True)
        time.sleep(0.3)
        sub2 = admin = svc2 = None
        try:
            # Era 1: t1 lands and a snapshot captures it; t2 lands after it
            # (journal only).
            assert pub_until(pub, [1, 2], t1, index1, rk1)
            assert svc1.recovery.snapshot_now("test") is not None
            assert pub_until(pub, [3, 4], t2, index1, rk2)
            # Unclean death: no stop(), no final snapshot.
            pub.close()
            sub1.stop()
            # The ground truth moved on while the indexer was down.
            truth = InMemoryIndex(InMemoryIndexConfig())
            truth.restore_state(index1.dump_state())
            truth.add(None, rk3, [PodEntry(pod_identifier="pod-a",
                                           device_tier=TIER_TPU_HBM)])
            # Age the surviving state past the warm-up bound.
            time.sleep(1.3)

            svc2 = make_service()
            svc2.attach_digest_source(IndexDigestSource(truth))
            svc2.start()
            index2 = svc2.indexer.kv_block_index
            assert len(index2.lookup(rk1)) == len(rk1)
            assert len(index2.lookup(rk2)) == len(rk2)
            assert index2.lookup(rk3) == {}

            assert svc2.recovery.state == STATE_WARMING
            resp = svc2.get_pod_scores(ScoreRequest(tokens=t1, model_name=MODEL))
            assert resp.degraded is True and resp.degraded_reason == "warmup"
            assert resp.scores == {"pod-a": float(len(rk1))}
            admin = AdminServer(port=0, expose_debug=False, health=svc2.recovery.health)
            port = admin.start()
            status, body = healthz(port)
            assert status == 503 and body["state"] == STATE_WARMING

            stats = svc2.reconcile_now()
            assert stats["repaired_added"] >= len(rk3)
            assert len(index2.lookup(rk3)) == len(rk3)

            sub2 = ZMQSubscriber(endpoint, "kv@", svc2.pool.add_task, bind=False)
            sub2.start()
            pub = KVEventPublisher(endpoint, "pod-a", MODEL, bind=True)
            time.sleep(0.3)
            fresh = list(range(300, 308))
            rkf = processor.tokens_to_kv_block_keys(0, fresh, MODEL)
            assert pub_until(pub, [7, 8], fresh, index2, rkf)
            assert wait_until(lambda: svc2.recovery.ready)
            assert svc2.recovery.state == STATE_READY
            resp = svc2.get_pod_scores(ScoreRequest(tokens=t1, model_name=MODEL))
            assert resp.degraded is False
            status, body = healthz(port)
            assert status == 200 and body["state"] == STATE_READY
        finally:
            pub.close()
            if sub2 is not None:
                sub2.stop()
            if admin is not None:
                admin.stop()
            if svc2 is not None:
                svc2.stop()
            # svc1 was abandoned as a crash would leave it; release its
            # threads and its journal handle.
            svc1.pool.shutdown()
            svc1.recovery.journal.close()


# ---------------------------------------------------------------------------
# The port against the JAX package, on inputs made from a numpy seed
# ---------------------------------------------------------------------------

JAX, PORT = "llmd_kv_cache_tpu", "llmd_kv_cache_tpu_torch"
PKGS = (JAX, PORT)
PODS = ("pod-a", "pod-b", "pod-c")


def mod(pkg: str, name: str):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def random_ops(seed: int, n: int = 120) -> list:
    """Adds and evictions over a small key space, so some evictions hit."""
    rng = np.random.default_rng(seed)
    space = [int(k) for k in rng.integers(1, 2**62, size=48, dtype=np.int64)]
    ops = []
    for _ in range(n):
        keys = [space[i] for i in rng.choice(len(space), size=int(rng.integers(1, 5)),
                                             replace=False)]
        entry = (PODS[int(rng.integers(len(PODS)))],
                 ("tpu-hbm", "cpu")[int(rng.integers(2))],
                 bool(rng.integers(2)), int(rng.integers(3)))
        ops.append(("evict" if rng.random() < 0.25 else "add", keys, entry))
    return ops


def make_entry(pkg: str, entry):
    pod, tier, spec, group = entry
    return mod(pkg, "core.keys").PodEntry(
        pod_identifier=pod, device_tier=tier, speculative=spec,
        has_group=group > 0, group_idx=group)


def apply_ops(pkg: str, index, ops) -> None:
    key_type = mod(pkg, "core.keys").KeyType
    for op, keys, entry in ops:
        if op == "add":
            index.add(None, keys, [make_entry(pkg, entry)])
        else:
            for key in keys:
                index.evict(key, key_type.REQUEST, [make_entry(pkg, entry)])


def make_index(pkg: str, ops=()):
    index_mod = mod(pkg, "index")
    index = index_mod.InMemoryIndex(index_mod.InMemoryIndexConfig(size=10_000))
    apply_ops(pkg, index, ops)
    return index


def decode_outcome(pkg: str, blob: bytes):
    cbor = mod(pkg, "utils.cbor")
    try:
        return ("ok", cbor.canonical_cbor_decode(blob))
    except cbor.CBORDecodeError as e:
        return ("error", str(e))


def _cbor_cases() -> dict:
    from llmd_kv_cache_tpu_torch.utils.cbor import canonical_cbor_encode

    rng = np.random.default_rng(24)
    doc = {"version": 1, "n": -int(rng.integers(1, 2**40)), "f": float(rng.random()),
           "b": bytes(rng.integers(0, 256, size=40, dtype=np.uint8)), "t": "zé",
           "l": [int(x) for x in rng.integers(0, 2**63, size=5, dtype=np.uint64)],
           "z": [None, True, False, {}]}
    blob = canonical_cbor_encode(doc)
    return {
        "document": blob,
        "truncated_head": blob[:1],
        "truncated_body": blob[:len(blob) // 2],
        "truncated_float": canonical_cbor_encode(1.5)[:5],
        "trailing_byte": blob + b"\x00",
        "indefinite_array": b"\x9f\x01\xff",
        "additional_info_28": b"\x1c",
        "float16": b"\xf9\x3c\x00",
        "tag": b"\xc0\x61a",
        "uint64_max": b"\x1b" + b"\xff" * 8,
        "negative_long_head": b"\x3b" + b"\x00" * 7 + b"\x05",
        "short_string_body": b"\x65abc",
        "empty": b"",
    }


CBOR_CASES = _cbor_cases()


@pytest.mark.parametrize("case", sorted(CBOR_CASES))
def test_cbor_decoder_verdicts_match_jax(case):
    """The decoder decodes what JAX's decodes (a non-shortest head too) and
    rejects what it rejects, with the same message; the encoder's document
    decodes and re-encodes to its bytes."""
    blob = CBOR_CASES[case]
    got = {pkg: decode_outcome(pkg, blob) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    if case == "document":
        from llmd_kv_cache_tpu_torch.utils.cbor import canonical_cbor_encode

        assert canonical_cbor_encode(got[PORT][1]) == blob


def snapshot_doc(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"version": 1, "created_unix": 1.7e9 + float(rng.random()), "reason": "test",
            "pod_seqs": {pod: int(rng.integers(0, 1000)) for pod in PODS},
            "index": make_index(PORT, random_ops(seed)).dump_state()}


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_files_byte_identical_and_cross_read(tmp_path, seed):
    """The same document writes the same file in both packages; each
    package's store loads the other's, and restoring it gives the writer's
    index state."""
    states = {pkg: make_index(pkg, random_ops(seed)).dump_state() for pkg in PKGS}
    assert states[PORT] == states[JAX]
    doc = snapshot_doc(seed)
    blobs = {pkg: mod(pkg, "recovery").encode_snapshot(doc) for pkg in PKGS}
    assert blobs[PORT] == blobs[JAX]
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        directory = str(tmp_path / writer)
        path = mod(writer, "recovery").SnapshotStore(directory, keep=2).save(doc)
        with open(path, "rb") as f:
            assert f.read() == blobs[PORT]
        loaded, loaded_path = mod(reader, "recovery").SnapshotStore(directory).load_newest()
        assert loaded == doc and loaded_path == path
        index = make_index(reader)
        assert index.restore_state(loaded["index"]) == \
            make_index(writer).restore_state(loaded["index"])
        assert index.dump_state() == states[writer]


@pytest.mark.parametrize("damage", ["flip_body", "flip_footer", "truncate", "magic"])
def test_damaged_snapshot_quarantined_as_in_jax(tmp_path, damage):
    """A damaged newest snapshot gets the same verdict and message in both
    packages; each store quarantines it and falls back to the older one."""
    doc = snapshot_doc(2)
    blob = bytearray(mod(PORT, "recovery").encode_snapshot(doc))
    if damage == "flip_body":
        blob[len(blob) // 2] ^= 0x40
    elif damage == "flip_footer":
        blob[-3] ^= 0x01
    elif damage == "truncate":
        del blob[-7:]
    else:
        blob[0:4] = b"XXXX"
    errors = {}
    for pkg in PKGS:
        rec = mod(pkg, "recovery")
        with pytest.raises(rec.SnapshotError) as err:
            rec.decode_snapshot(bytes(blob))
        errors[pkg] = str(err.value)
        store = rec.SnapshotStore(str(tmp_path / pkg), keep=3)
        older = store.save({"version": 1, "n": 0})
        newest = store.save(doc)
        with open(newest, "wb") as f:
            f.write(bytes(blob))
        loaded, path = store.load_newest()
        assert (loaded, path) == ({"version": 1, "n": 0}, older)
        assert os.path.exists(newest + ".quarantine") and store.quarantined == 1
    assert errors[PORT] == errors[JAX]


def journal_records(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    seqs = dict.fromkeys(PODS, 0)
    out = []
    for _ in range(n):
        pod = PODS[int(rng.integers(len(PODS)))]
        seqs[pod] += int(rng.integers(1, 3))
        payload = bytes(rng.integers(0, 256, size=int(rng.integers(0, 64)), dtype=np.uint8))
        out.append((pod, seqs[pod], f"kv@{pod}@{MODEL}", payload, 1.7e9 + float(rng.random())))
    return out


def replayed(pkg: str, path: str, min_seqs=None) -> list:
    return [(r.pod_id, r.sequence, r.topic, r.payload, r.event_ts)
            for r in mod(pkg, "recovery").EventJournal(path).replay(min_seqs)]


@pytest.mark.parametrize("sync_every", [1, 64])
def test_journal_bytes_identical_and_cross_replay(tmp_path, sync_every):
    """The same appends write the same journal in both packages, and each
    package replays the other's past the same watermarks."""
    recs = journal_records(3)
    paths = {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / pkg / "events.journal")
        journal = mod(pkg, "recovery").EventJournal(paths[pkg], sync_every=sync_every)
        for rec in recs:
            journal.append(*rec)
        journal.close()
    with open(paths[JAX], "rb") as a, open(paths[PORT], "rb") as b:
        assert a.read() == b.read()
    marks = {"pod-a": 3, "pod-c": 10}
    want = [r for r in recs if r[1] > marks.get(r[0], -1)]
    for writer in PKGS:
        for reader in PKGS:
            assert replayed(reader, paths[writer], marks) == want
            assert replayed(reader, paths[writer]) == recs


@pytest.mark.parametrize("cut", [0.13, 0.5, 0.77, 0.999, "flip"])
def test_torn_journal_stops_where_jax_stops(tmp_path, cut):
    """A journal cut mid-record, or with one flipped byte, replays the same
    records in both packages and stops at the same one."""
    recs = journal_records(4)
    path = str(tmp_path / "events.journal")
    journal = EventJournal(path, sync_every=1)
    for rec in recs:
        journal.append(*rec)
    journal.close()
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if cut == "flip":
        data[len(data) // 3] ^= 0x10
    else:
        data = data[:int(len(data) * cut)]
    with open(path, "wb") as f:
        f.write(bytes(data))
    got = {pkg: replayed(pkg, path) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    assert got[PORT] == recs[:len(got[PORT])] and len(got[PORT]) < len(recs)


def test_indexer_config_reads_recovery_config_as_jax():
    """``recoveryConfig`` builds equal ``RecoveryConfig``s in both packages
    (camelCase and snake_case keys); ``fleetTelemetry`` still raises."""
    cfgs = [{"recoveryConfig": {"snapshotDir": "/tmp/x", "snapshotIntervalS": 5,
                                "snapshotKeep": 2, "warmupStalenessBoundS": 0.5,
                                "drainDeadlineS": 3, "reconcileIntervalS": 7,
                                "divergenceAuditIntervalS": 2, "divergenceAuditSample": 0.5,
                                "journalSyncEvery": 1}},
            {"recovery_config": {"snapshot_dir": "/tmp/y", "journal_sync_every": 0}},
            {"recoveryConfig": {}}]
    for d in cfgs:
        got = {pkg: mod(pkg, "scoring.indexer").IndexerConfig.from_dict(d).recovery_config
               for pkg in PKGS}
        if got[JAX] is None:
            assert got[PORT] is None
        else:
            assert dataclasses.asdict(got[PORT]) == dataclasses.asdict(got[JAX])
            assert got[PORT].enabled == got[JAX].enabled
    with pytest.raises(NotImplementedError, match="A.8.6"):
        mod(PORT, "scoring.indexer").IndexerConfig.from_dict(
            {"fleetTelemetry": {"spanExport": True}})


def rows(state: dict) -> set:
    """An index state's entries as a set of (request key, row): the
    reconciler repairs entries, in its own order, and not the engine-key
    mappings."""
    return {(rk, tuple(row)) for rk, rs in state["entries"] for row in rs}


def diverged_pair(pkg: str, seed: int):
    """``truth`` and a ``local`` view that missed some of its adds and holds
    adds of its own (phantoms)."""
    ops = random_ops(seed)
    rng = np.random.default_rng(seed + 100)
    dropped = rng.random(len(ops)) < 0.15
    local_ops = [op for op, drop in zip(ops, dropped) if not drop] + random_ops(seed + 7, 15)
    return make_index(pkg, ops), make_index(pkg, local_ops)


@pytest.mark.parametrize("seed", [5, 6])
def test_reconcilers_and_auditors_agree_with_jax(seed):
    """Both packages' auditors report the same phantom and ghost counts per
    pod, round by round (a rotating half sample), and both reconcilers the
    same repairs, after which each local index equals its truth."""
    reports, views, stats, states = {}, {}, {}, {}
    for pkg in PKGS:
        truth, local = diverged_pair(pkg, seed)
        rec = mod(pkg, "recovery.reconcile")
        clock = iter(float(t) for t in range(100, 200))
        auditor = rec.DivergenceAuditor(local, rec.IndexDigestSource(truth),
                                        sample=0.5, clock=lambda: next(clock))
        reports[pkg] = [auditor.audit_once() for _ in range(3)]
        views[pkg] = auditor.debug_view()
        stats[pkg] = [rec.AntiEntropyReconciler(local, rec.IndexDigestSource(truth))
                      .reconcile_once() for _ in range(2)]
        reports[pkg].append(auditor.audit_once())
        reports[pkg].append(auditor.audit_once())
        states[pkg] = local.dump_state()
        assert rows(states[pkg]) == rows(truth.dump_state())
    assert reports[PORT] == reports[JAX]
    assert views[PORT] == views[JAX]
    assert stats[PORT] == stats[JAX]
    assert states[PORT] == states[JAX]
    assert any(r["divergent"] for r in reports[PORT][:3])
    assert stats[PORT][0]["divergent"] and not stats[PORT][1]["divergent"]
    assert not reports[PORT][-1]["divergent"]


def _service(pkg: str, snapdir: str = ""):
    cfg = {"tokenProcessorConfig": {"blockSize": BLOCK},
           "kvBlockIndexConfig": {"inMemoryConfig": {"size": 10_000}}}
    if snapdir:
        cfg["recoveryConfig"] = {"snapshotDir": snapdir, "snapshotIntervalS": 0,
                                 "warmupStalenessBoundS": 1.0, "journalSyncEvery": 1}
    svc_mod = mod(pkg, "services.indexer_service")
    return svc_mod.IndexerService(
        mod(pkg, "scoring.indexer").IndexerConfig.from_dict(cfg),
        mod(pkg, "events").PoolConfig(concurrency=1))


def traffic(seed: int, n: int = 24, ts=None) -> list:
    """(pod, seq, hashes, tokens, removed hashes) event batches."""
    rng = np.random.default_rng(seed)
    seqs = dict.fromkeys(PODS[:2], 0)
    out, stored = [], {pod: [] for pod in seqs}
    for i in range(n):
        pod = PODS[int(rng.integers(2))]
        seqs[pod] += 1
        tokens = [int(t) for t in rng.integers(1, 5000, size=BLOCK * int(rng.integers(1, 4)))]
        hashes = [int(h) for h in rng.integers(1, 2**62, size=len(tokens) // BLOCK,
                                               dtype=np.int64)]
        removed = []
        if stored[pod] and rng.random() < 0.3:
            removed = stored[pod][:int(rng.integers(1, len(stored[pod]) + 1))]
            stored[pod] = stored[pod][len(removed):]
        stored[pod] += hashes
        out.append((pod, seqs[pod], hashes, tokens, removed))
    return out


def message(pod, seq, hashes, tokens, removed, ts) -> RawMessage:
    events = [["BlockStored", hashes, None, tokens, BLOCK, None]]
    if removed:
        events.append(["BlockRemoved", removed, None])
    return RawMessage(topic=f"kv@{pod}@{MODEL}", sequence=seq, payload=packb([ts, events]))


def feed(pkg: str, pool, batches, ts) -> None:
    raw = mod(pkg, "events.model").RawMessage
    for batch in batches:
        msg = message(*batch, ts)
        pool.add_task(raw(topic=msg.topic, sequence=msg.sequence, payload=msg.payload))
    pool.join()


def test_services_audit_and_repair_as_jax():
    """Two ``IndexerService``s, one of each package, miss the same batches
    of the same traffic; ``audit_now`` and ``reconcile_now`` against the
    complete index answer alike, and both end equal to it."""
    batches = traffic(8)
    missed = {3, 9, 15}
    got = {}
    for pkg in PKGS:
        truth_svc, svc = _service(pkg), _service(pkg)
        for s in (truth_svc, svc):
            s.pool.start()
        feed(pkg, truth_svc.pool, batches, 1.7e9)
        feed(pkg, svc.pool, [b for i, b in enumerate(batches) if i not in missed], 1.7e9)
        truth = truth_svc.indexer.kv_block_index
        with pytest.raises(RuntimeError, match="no digest source"):
            svc.reconcile_now()
        svc.attach_digest_source(mod(pkg, "recovery").IndexDigestSource(truth))
        got[pkg] = (svc.audit_now(), svc.reconcile_now(), svc.audit_now(),
                    svc.indexer.kv_block_index.dump_state())
        assert rows(got[pkg][3]) == rows(truth.dump_state())
        for s in (truth_svc, svc):
            s.stop()
    assert got[PORT] == got[JAX]
    assert got[PORT][0]["divergent"] and not got[PORT][2]["divergent"]


def test_warm_restart_state_equals_jax(tmp_path):
    """The same traffic into both packages' services: half before a
    snapshot, half journaled, then a crash. Each restarts warm from its own
    directory, the port also from the JAX package's; the journals are
    byte-identical and every restarted index equals the pre-crash one."""
    batches = traffic(9)
    ts = time.time() - 60.0  # old events: restarted services stay warming
    before, journals = {}, {}
    for pkg in PKGS:
        svc = _service(pkg, str(tmp_path / pkg))
        svc.start()
        feed(pkg, svc.pool, batches[:12], ts)
        assert svc.recovery.snapshot_now("test") is not None
        feed(pkg, svc.pool, batches[12:], ts)
        before[pkg] = svc.indexer.kv_block_index.dump_state()
        svc.pool.shutdown()  # crash: no final snapshot
        svc.recovery.journal.close()
        with open(os.path.join(str(tmp_path / pkg), "events.journal"), "rb") as f:
            journals[pkg] = f.read()
    assert before[PORT] == before[JAX]
    assert journals[PORT] == journals[JAX] and journals[PORT]
    for pkg, directory in ((JAX, JAX), (PORT, PORT), (PORT, JAX)):
        svc = _service(pkg, str(tmp_path / directory))
        svc.start()
        try:
            assert svc.recovery.replayed_records == 12
            assert svc.recovery.state == "warming"
            assert svc.indexer.kv_block_index.dump_state() == before[JAX]
        finally:
            svc.pool.shutdown()
            svc.recovery.journal.close()


def test_peer_anti_entropy_over_grpc_as_jax():
    """``attach_peer_digest_source`` as JAX has it, over real gRPC (held on
    the CPU: the card's machine has no grpc). Three replicas of each
    package (rf 2) serve the shard surface; one missed a batch (stores and
    a removal). One peer round repairs its share of the batch's keys, and
    both packages repair the same rows."""
    got = {}
    for pkg in PKGS:
        addrs = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
        ids = ["s0", "s1", "s2"]  # the ring hashes ids: both packages own alike
        svc_mod = mod(pkg, "services.indexer_service")
        cfg_mod = mod(pkg, "scoring.indexer")
        services, servers = {}, []
        try:
            for sid, addr in zip(ids, addrs):
                svc = svc_mod.IndexerService(cfg_mod.IndexerConfig.from_dict({
                    "tokenProcessorConfig": {"blockSize": BLOCK},
                    "kvBlockIndexConfig": {"inMemoryConfig": {"size": 10_000}},
                    "clusterConfig": {"shardAddresses": addrs, "shardIds": ids,
                                      "shardId": sid, "replicationFactor": 2}}),
                    mod(pkg, "events").PoolConfig(concurrency=1))
                svc.pool.start()
                services[sid] = svc
                servers.append(svc_mod.serve(addr, svc))
            batches = traffic(10, n=8)
            victim = "s0"
            for addr, svc in services.items():
                feed(pkg, svc.pool, [b for i, b in enumerate(batches)
                                     if not (addr == victim and i == 5)], 1.7e9)
            before = services[victim].indexer.kv_block_index.dump_state()
            services[victim].attach_peer_digest_source()
            stats = services[victim].reconcile_now()
            after = services[victim].indexer.kv_block_index.dump_state()
            again = services[victim].reconcile_now()
            got[pkg] = (stats, again, rows(after) - rows(before), rows(before) - rows(after))
        finally:
            for server in servers:
                server.stop(grace=0)
            for svc in services.values():
                svc.stop()
    assert got[PORT] == got[JAX]
    stats, again, added, removed = got[PORT]
    assert (stats["repaired_added"], stats["repaired_removed"]) == (len(added), len(removed))
    assert added and stats["divergent"] and not again["divergent"]
