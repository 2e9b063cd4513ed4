"""The port's ZMQ transports against the JAX package's, over loopback TCP.

The port's publisher feeds JAX's subscriber and JAX's publisher feeds the
port's, with the frames byte-equal; the subscriber manager and the pod
reconciler behave as JAX's; an offload spec with an ``events_endpoint``
publishes the storage tier's updates into the port's index as JAX's does
into its own (``test_zmq_integration.py``'s tier update).
"""

import json
import time

import pytest
import zmq

from llmd_kv_cache_tpu.core import ChunkedTokenDatabase as JaxTokens
from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokensConfig
from llmd_kv_cache_tpu.events import model as jax_model
from llmd_kv_cache_tpu.events import reconciler as jax_reconciler
from llmd_kv_cache_tpu.events.pool import Pool as JaxPool
from llmd_kv_cache_tpu.events.pool import PoolConfig as JaxPoolConfig
from llmd_kv_cache_tpu.events.publisher import KVEventPublisher as JaxPublisher
from llmd_kv_cache_tpu.events.subscriber_manager import SubscriberManager as JaxManager
from llmd_kv_cache_tpu.events.zmq_subscriber import ZMQSubscriber as JaxSubscriber
from llmd_kv_cache_tpu.index import InMemoryIndex as JaxIndex
from llmd_kv_cache_tpu.offload import spec as jax_spec
from llmd_kv_cache_tpu_torch.core.token_processor import ChunkedTokenDatabase, TokenProcessorConfig
from llmd_kv_cache_tpu_torch.events import (
    StorageEventPublisher,
    SubscriberManager,
    ZMQSubscriber,
    model,
    reconciler,
)
from llmd_kv_cache_tpu_torch.events.pool import Pool, PoolConfig
from llmd_kv_cache_tpu_torch.events.publisher import KVEventPublisher, encode_batch
from llmd_kv_cache_tpu_torch.index.in_memory import InMemoryIndex
from llmd_kv_cache_tpu_torch.offload import spec
from torch_telemetry_helpers import (
    private_flight_recorders,
    private_jax_metrics,
    private_port_metrics,
)

BLOCK = 4
MODEL = "m"
TRACE = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"

@pytest.fixture(autouse=True)
def _private_globals(monkeypatch):
    """Both packages' metric families and flight recorders of the test's
    own: the pools record lag, staleness and drops, which the JAX fleet
    tests later in the worker would otherwise read."""
    private_jax_metrics(monkeypatch)
    private_port_metrics(monkeypatch)
    with private_flight_recorders():
        yield



def wait_until(cond, timeout=5.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def index_dump(index):
    return {rk: sorted((e.pod_identifier, e.device_tier) for e in index._data.peek(rk).cache.keys())
            for rk in index._data.keys()}


def stack(side):
    if side == "port":
        index = InMemoryIndex()
        tp = ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=BLOCK))
        pool = Pool(PoolConfig(concurrency=2), index, tp)
    else:
        index = JaxIndex()
        tp = JaxTokens(JaxTokensConfig(block_size_tokens=BLOCK))
        pool = JaxPool(JaxPoolConfig(concurrency=2), index, tp)
    pool.start()
    return index, tp, pool


def bound_endpoint(publisher) -> str:
    return publisher._sock.getsockopt(zmq.LAST_ENDPOINT).decode()


def free_endpoint() -> str:
    """A loopback endpoint on a port that was free a moment ago."""
    ctx = zmq.Context()
    probe = ctx.socket(zmq.PUB)
    probe.bind("tcp://127.0.0.1:*")
    endpoint = probe.getsockopt(zmq.LAST_ENDPOINT).decode()
    probe.close()
    ctx.term()
    return endpoint


def events_of(mod):
    return [
        [mod.BlockStoredEvent(block_hashes=[1, 2], tokens=list(range(8)), block_size=BLOCK)],
        [mod.BlockStoredEvent(block_hashes=[3], tokens=list(range(8, 12)), parent_hash=2,
                              block_size=BLOCK, device_tier="cpu")],
        [mod.BlockRemovedEvent(block_hashes=[3])],
        [mod.AllBlocksClearedEvent(), mod.BlockStoredEvent(
            block_hashes=[2**64 - 1], tokens=list(range(20, 24)), block_size=BLOCK)],
    ]


def publish_through(pub_cls, pub_mod, sub_cls, side):
    """One package's publisher (bound) into the other's subscriber
    (connected) feeding a started pool; returns the received frames and the
    index. The first batches are probes until the subscription is live."""
    index, _, pool = stack(side)
    got = []

    def on_message(msg):
        got.append((msg.topic, msg.sequence, bytes(msg.payload)))
        pool.add_task(msg)

    pub = pub_cls("tcp://127.0.0.1:*", "pod-z", MODEL, bind=True)
    sub = sub_cls(bound_endpoint(pub), "kv@", on_message)
    sub.start()
    try:
        assert wait_until(lambda: pub.publish([], timestamp=0.0) is not None and bool(got),
                          timeout=10, interval=0.05)
        time.sleep(0.1)
        got.clear()
        first = pub._seq
        for i, evs in enumerate(events_of(pub_mod)):
            pub.publish(evs, timestamp=100.0 + i, data_parallel_rank=i % 2 or None,
                        traceparent=TRACE if i == 1 else None, epoch=3 if i == 2 else 0)
        assert wait_until(lambda: len(got) == 4)
        pool.join()
    finally:
        sub.stop()
        pub.close()
        pool.shutdown()
    return [(t, s - first, p) for t, s, p in got], index_dump(index)


def test_each_publisher_feeds_the_other_packages_subscriber_byte_equal():
    port_frames, jax_index = publish_through(KVEventPublisher, model, JaxSubscriber, "jax")
    jax_frames, port_index = publish_through(JaxPublisher, jax_model, ZMQSubscriber, "port")
    assert port_frames == jax_frames
    assert [p for _, _, p in port_frames] == [
        encode_batch(evs, 100.0 + i, i % 2 or None, TRACE if i == 1 else None,
                     3 if i == 2 else 0) for i, evs in enumerate(events_of(model))]
    assert port_index == jax_index and len(port_index) == 1  # cleared, then 1 stored
    assert ZMQSubscriber._parse_frames([b"kv@a@m", b"\x00" * 8, b"x"]) == model.RawMessage(
        "kv@a@m", 0, b"x")
    assert ZMQSubscriber._parse_frames([b"kv@a@m", b"\x00" * 7, b"x"]) is None
    assert ZMQSubscriber._parse_frames([b"\xff", b"\x00" * 8, b"x"]) is None


def manager_trace(manager_cls):
    mgr = manager_cls(on_message=lambda m: None)
    try:
        out = [mgr.ensure_subscriber("p1", "tcp://127.0.0.1:1"),
               mgr.ensure_subscriber("p1", "tcp://127.0.0.1:1"),
               mgr.ensure_subscriber("p1", "tcp://127.0.0.1:2"),
               mgr.endpoint_of("p1"),
               mgr.ensure_subscriber("p2", "tcp://127.0.0.1:3"),
               sorted(mgr.pods()),
               mgr.remove_subscriber("p1"), mgr.remove_subscriber("p1"),
               mgr.endpoint_of("p1"), mgr.pods()]
    finally:
        mgr.shutdown()
    return out + [mgr.pods()]


def test_subscriber_manager_idempotence_and_endpoint_change_as_jax():
    got = manager_trace(SubscriberManager)
    assert got == manager_trace(JaxManager)
    assert got[:4] == [True, False, True, "tcp://127.0.0.1:2"]


def reconcile_trace(mod, manager_cls, tmp_path):
    path = tmp_path / f"{mod.__name__}.json"
    mgr = manager_cls(on_message=lambda m: None)
    changes = []
    static = mod.StaticDiscovery({"a": "tcp://127.0.0.1:11", "b": "tcp://127.0.0.1:12"})
    out = []
    try:
        rec = mod.PodReconciler(static, mgr, interval_s=60, on_change=changes.append)
        out += [rec.reconcile_once(), rec.reconcile_once()]
        static.set({"b": "tcp://127.0.0.1:13"})
        out += [rec.reconcile_once(), sorted(mgr.pods()), mgr.endpoint_of("b")]
        filed = mod.PodReconciler(mod.FileDiscovery(str(path)), mgr, interval_s=60)
        out.append(filed.reconcile_once())  # no file: no pods
        path.write_text(json.dumps({"c": "tcp://127.0.0.1:14"}))
        out += [filed.reconcile_once(), sorted(mgr.pods())]
        path.write_text("{not json")
        out.append(filed.reconcile_once())
        filed.start()
        filed.start()
        filed.stop()
    finally:
        mgr.shutdown()
    return out, changes


def test_pod_reconciler_static_and_file_discovery_as_jax(tmp_path):
    got = reconcile_trace(reconciler, SubscriberManager, tmp_path)
    assert got == reconcile_trace(jax_reconciler, JaxManager, tmp_path)
    assert got[0][:3] == [(2, 0), (0, 0), (1, 1)]

    class Pods:
        def __init__(self, items):
            self.items = items

    class Obj:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    class Api:
        def list_pod_for_all_namespaces(self, label_selector):
            return Pods([Obj(metadata=Obj(name="x"), status=Obj(pod_ip="10.0.0.1",
                                                                 phase="Running")),
                         Obj(metadata=Obj(name="y"), status=Obj(pod_ip=None, phase="Pending"))])

    cfg = reconciler.PodDiscoveryConfig(socket_port=5557)
    assert reconciler.KubernetesDiscovery(cfg, core_api=Api()).discover() == {
        "x": "tcp://10.0.0.1:5557"}


def tier_update(side, tmp_path):
    """``test_zmq_integration.py``'s tier update through an offload spec's
    manager: an engine publisher and the spec's storage publisher both
    connect to the indexer's bound subscriber."""
    index, tp, pool = stack(side)
    Sub, Pub, Spec = ((ZMQSubscriber, KVEventPublisher, spec.SharedStorageOffloadSpec)
                      if side == "port" else
                      (JaxSubscriber, JaxPublisher, jax_spec.SharedStorageOffloadSpec))
    mod = model if side == "port" else jax_model
    endpoint = free_endpoint()
    sub = Sub(endpoint, "kv@", pool.add_task, bind=True)
    sub.start()
    time.sleep(0.2)
    engine_pub = Pub(endpoint, "pod-a", MODEL, bind=False)
    manager = Spec(root=str(tmp_path / side), model_name=MODEL, page_size=BLOCK,
                   events_endpoint=endpoint).get_manager()
    time.sleep(0.3)
    tokens = list(range(4))
    rk = tp.tokens_to_kv_block_keys(0, tokens, MODEL)
    stages = []
    try:
        assert wait_until(lambda: engine_pub.publish([mod.BlockStoredEvent(
            block_hashes=[9], tokens=tokens, block_size=BLOCK)]) is not None
            and index.lookup(rk) != {}, interval=0.1)
        stages.append(index_dump(index))
        manager.complete_store([9])
        assert wait_until(lambda: len(index.lookup(rk).get(rk[0], [])) == 2)
        stages.append(index_dump(index))
        manager.complete_load_failure([9])
        assert wait_until(lambda: len(index.lookup(rk).get(rk[0], [])) == 1)
        stages.append(index_dump(index))
    finally:
        sub.stop()
        engine_pub.close()
        manager.event_publisher.close()
        pool.shutdown()
    return stages


def test_offload_spec_events_endpoint_lands_tier_updates_as_jax(tmp_path):
    got = tier_update("port", tmp_path)
    assert got == tier_update("jax", tmp_path)
    assert [sorted(t for _, t in rows) for rows in (s[next(iter(s))] for s in got)] == [
        ["tpu-hbm"], ["shared_storage", "tpu-hbm"], ["tpu-hbm"]]


@pytest.mark.parametrize("name", ["StorageEventPublisher", "SubscriberManager", "ZMQSubscriber"])
def test_zmq_classes_are_exported_lazily(name):
    import llmd_kv_cache_tpu_torch.events as events

    assert getattr(events, name).__name__ == name
    assert StorageEventPublisher.__module__.endswith("events.publisher")
    with pytest.raises(AttributeError):
        events.NoSuchName  # noqa: B018


def test_flapping_peer_reconnects_with_backoff_and_records_it():
    """``test_failure_recovery.py``'s flapping peer on the port: three
    injected connection faults (the port's failpoint registry), a backoff
    that grows with the streak, ``KIND_RECONNECT`` flight records, then a
    healthy link whose first delivery resets the streak."""
    from llmd_kv_cache_tpu_torch.events.zmq_subscriber import FP_ZMQ_CONNECT
    from llmd_kv_cache_tpu_torch.resilience.failpoints import failpoints
    from llmd_kv_cache_tpu_torch.resilience.policy import RetryPolicy
    from llmd_kv_cache_tpu_torch.telemetry.flight_recorder import KIND_RECONNECT, flight_recorder

    index, tp, pool = stack("port")
    endpoint = free_endpoint()
    policy = RetryPolicy(max_attempts=1, base_delay_s=0.01, max_delay_s=0.08,
                         multiplier=2.0, jitter=False)
    sub = ZMQSubscriber(endpoint, "kv@", pool.add_task, retry_policy=policy)
    failpoints.arm(FP_ZMQ_CONNECT, times=3)
    sub.start()
    pub = None
    try:
        assert wait_until(lambda: sub.reconnects >= 3)
        assert sub.next_delay() > policy.base_delay_s
        records = [r for r in flight_recorder().snapshot() if r["kind"] == KIND_RECONNECT
                   and r["data"]["endpoint"] == endpoint]
        assert [r["data"]["streak"] for r in records][:3] == [1, 2, 3]
        pub = KVEventPublisher(endpoint, "pod-a", MODEL, bind=True)
        tokens = list(range(8))
        rks = tp.tokens_to_kv_block_keys(0, tokens, MODEL)
        assert wait_until(lambda: pub.publish([model.BlockStoredEvent(
            block_hashes=[5, 6], tokens=tokens, block_size=BLOCK)]) is not None
            and index.lookup(rks) != {}, interval=0.1)
        assert sub.next_delay() == policy.base_delay_s
    finally:
        failpoints.disarm(FP_ZMQ_CONNECT)
        sub.stop()
        if pub is not None:
            pub.close()
        pool.shutdown()
