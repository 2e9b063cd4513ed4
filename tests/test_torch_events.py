"""The port's event plane against the JAX package's.

Held exactly: the adapters' parses (the payloads of ``test_adapters.py``
and the fuzz of ``test_adapter_fuzz.py``), KZC1 frames both ways, shared-
memory rings written by one package and read by the other, one seeded
stream through a started pool of each package (index dumps, shards and
counters), liveness factors and scores on a fake clock, the ingest span's
parent, and a tiny engine's events through ``encode_batch`` → ``add_task``
against the JAX engine → ``publish`` → pool.
"""

import dataclasses
import logging
import time

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import zmq

from llmd_kv_cache_tpu.core import ChunkedTokenDatabase as JaxTokens
from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokensConfig
from llmd_kv_cache_tpu.core.keys import PodEntry as JaxPodEntry
from llmd_kv_cache_tpu.events import model as jax_model
from llmd_kv_cache_tpu.events import packed as jax_packed
from llmd_kv_cache_tpu.events import shm_ring as jax_ring
from llmd_kv_cache_tpu.events.adapters import SGLangAdapter as JaxSGLang
from llmd_kv_cache_tpu.events.adapters import VLLMAdapter as JaxVLLM
from llmd_kv_cache_tpu.events.pool import Pool as JaxPool
from llmd_kv_cache_tpu.events.pool import PoolConfig as JaxPoolConfig
from llmd_kv_cache_tpu.events.publisher import KVEventPublisher as JaxPublisher
from llmd_kv_cache_tpu.index import InMemoryIndex as JaxIndex
from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.resilience.liveness import PodLivenessTracker as JaxLiveness
from llmd_kv_cache_tpu.scoring import Indexer as JaxIndexer
from llmd_kv_cache_tpu.scoring import IndexerConfig as JaxIndexerConfig
from llmd_kv_cache_tpu_torch.core.keys import PodEntry
from llmd_kv_cache_tpu_torch.core.token_processor import ChunkedTokenDatabase, TokenProcessorConfig
from llmd_kv_cache_tpu_torch.events import model, packed, shm_ring
from llmd_kv_cache_tpu_torch.events.adapters import SGLangAdapter, VLLMAdapter, create_adapter
from llmd_kv_cache_tpu_torch.events.pool import Pool, PoolConfig
from llmd_kv_cache_tpu_torch.events.publisher import encode_batch
from llmd_kv_cache_tpu_torch.index.in_memory import InMemoryIndex
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.resilience.liveness import PodLivenessTracker
from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig
from llmd_kv_cache_tpu_torch.telemetry import tracing
from torch_telemetry_helpers import (
    private_flight_recorders,
    private_jax_metrics,
    private_port_metrics,
)

BLOCK = 4
PAIRS = [(JaxVLLM, VLLMAdapter), (JaxSGLang, SGLangAdapter)]

@pytest.fixture(autouse=True)
def _private_globals(monkeypatch):
    """Both packages' metric families and flight recorders of the test's
    own: the pools record lag, staleness and drops, which the JAX fleet
    tests later in the worker would otherwise read."""
    private_jax_metrics(monkeypatch)
    private_port_metrics(monkeypatch)
    with private_flight_recorders():
        yield



def pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def parsed(adapter, payload, topic="kv@pod-1@model-a"):
    """(pod, model, batch as plain data), or the exception's family."""
    try:
        pod, mdl, batch = adapter.parse_message(type_of(adapter).RawMessage(
            topic=topic, sequence=7, payload=payload))
    except Exception as exc:  # noqa: BLE001
        return ("raised", ValueError if isinstance(exc, ValueError) else Exception)
    events = [(type(e).__name__, dataclasses.asdict(e)) for e in batch.events]
    return pod, mdl, batch.timestamp, events, batch.data_parallel_rank, batch.traceparent, \
        batch.epoch


def type_of(adapter):
    return jax_model if type(adapter).__module__.startswith("llmd_kv_cache_tpu.") else model


DIGEST = bytes(range(32))
ADAPTER_PAYLOADS = [
    pack([123.5, [["BlockStored", [1, 2], 99, list(range(32)), 16, 7, "cpu", "lora-x",
                   [["mm1"], None], 1, "sliding_window", 1024]]]),
    pack([123.5, [["BlockStored", [10], None, [1, 2, 3], 16]]]),
    pack([123.5, [["BlockStored", [10], None, [1], 16, None, None, None, None, None,
                   None, None, "future-field", 42]]]),
    pack([123.5, [["BlockStored", [DIGEST], DIGEST, [1], 16]]]),
    pack([123.5, [["BlockRemoved", [5, 6], "cpu", 2]]]),
    pack([123.5, [["BlockRemoved", [5]]]]),
    pack([123.5, [["AllBlocksCleared"]]]),
    pack([123.5, [], 3]),
    pack([123.5, [pack(["AllBlocksCleared"])]]),
    pack([123.5, [["BlockStored", [1], None, [1], 16, None, "cpu", None, None, 5,
                   "sliding_window", 100]]]),
    pack([123.5, [["BlockRemoved", [1], "cpu", 3]]]),
    pack([1.0, [["BlockStored", [2**64 - 1, -1], 2**63, [2**33 + 5], 16]], 0,
          "00-" + "1f" * 16 + "-" + "2e" * 8 + "-01", 9]),
    pack([1.0, [], None, None, "not-an-epoch"]),
    # Malformed (test_adapters.py's and the fuzz's plausible garbage).
    pack([123.5, [["BlockStored", [1]]]]),
    pack([123.5, [["BlockStored", "not-array", None, [1], 16]]]),
    pack([123.5, [["Unknown", 1]]]),
    pack([123.5, [[42, 1]]]),
    pack([123.5, [[]]]),
    pack([123.5, [["BlockStored", [1], None, [1], 16, None, None, None, None, -1]]]),
    b"\x00garbage",
    *[pack(case) for case in (
        [], [1.0], [1.0, None], ["ts", []], [1.0, [None]], [1.0, [[]]], [1.0, [[123]]],
        [1.0, [["BlockStored"]]], [1.0, [["BlockStored", None, None, None, None]]],
        [1.0, [["BlockStored", [None], None, [1], 4]]],
        [1.0, [["BlockStored", [1], "parent", [1], 4]]],
        [1.0, [["BlockStored", [1], None, ["tok"], 4]]], [1.0, [["BlockRemoved"]]],
        [1.0, [["BlockRemoved", {"a": 1}]]], [1.0, [["AllBlocksCleared", "extra", 42]]],
        [1.0, [], "dp-rank-as-string"], {"not": "a list"})],
]


@pytest.mark.parametrize("pair", PAIRS, ids=["vllm", "sglang"])
@pytest.mark.parametrize("i", range(len(ADAPTER_PAYLOADS)))
def test_adapter_parses_equal_jax(pair, i):
    jax_cls, port_cls = pair
    payload = ADAPTER_PAYLOADS[i]
    assert parsed(port_cls(), payload) == parsed(jax_cls(), payload)
    msg = model.RawMessage(topic="kv@pod-1@m@lora", sequence=0, payload=payload)
    assert port_cls().sharding_key(msg) == jax_cls().sharding_key(
        jax_model.RawMessage(topic=msg.topic, sequence=0, payload=payload))


@pytest.mark.parametrize("pair", PAIRS, ids=["vllm", "sglang"])
@pytest.mark.parametrize("seed,size", [(0, None), (2, 32)])
def test_adapter_fuzz_drops_what_jax_drops(pair, seed, size):
    """The fuzz's seeded garbage (``test_adapter_fuzz.py``): the port's
    adapter refuses exactly the messages JAX's refuses, and parses the rest
    equal."""
    jax_cls, port_cls = pair
    rng = np.random.default_rng(seed)
    for _ in range(300):
        n = size if size is not None else rng.integers(0, 64)
        payload = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert parsed(port_cls(), payload) == parsed(jax_cls(), payload)


def test_create_adapter_as_jax():
    assert isinstance(create_adapter("vllm"), VLLMAdapter)
    assert isinstance(create_adapter("SGLang"), SGLangAdapter)
    assert isinstance(create_adapter(None), VLLMAdapter)
    with pytest.raises(ValueError, match="unknown engine type: tgi"):
        create_adapter("tgi")


# --------------------------------------------------------------------------
# KZC1 frames and the shared-memory ring
# --------------------------------------------------------------------------

def frame_args(rng, i):
    n = int(rng.integers(0, 9))
    return dict(pod_id=f"pod-{i}-é", model_name="meta/llama@lora" * (i % 2),
                engine_keys=rng.integers(0, 2**64, n, dtype=np.uint64),
                tokens=rng.integers(0, 2**32, n * BLOCK + i % 3, dtype=np.uint32),
                timestamp=float(rng.random() * 2e9), parent_hash=int(rng.integers(0, 2**63)) * (i % 2),
                block_size=BLOCK * (i % 3))


def test_packed_frames_byte_equal_both_ways():
    rng = np.random.default_rng(0)
    assert (packed.MAGIC, packed.HEADER_SIZE) == (jax_packed.MAGIC, jax_packed.HEADER_SIZE)
    for i in range(40):
        args = frame_args(rng, i)
        pos = (args.pop("pod_id"), args.pop("model_name"), args.pop("engine_keys"),
               args.pop("tokens"))
        ours = packed.encode_packed_batch(*pos, **args)
        assert ours == jax_packed.encode_packed_batch(*pos, **args)
        assert packed.is_packed(ours) and jax_packed.is_packed(ours)
        for a, b in ((packed.decode_packed_batch(ours), jax_packed.decode_packed_batch(ours)),):
            for f in ("pod_id", "model_name", "timestamp", "parent_hash", "block_size"):
                assert getattr(a, f) == getattr(b, f)
            assert a.engine_keys.dtype == np.uint64 and a.tokens.dtype == np.uint32
            assert np.array_equal(a.engine_keys, b.engine_keys)
            assert np.array_equal(a.tokens, b.tokens)
            assert not a.engine_keys.flags.owndata  # a view over the payload
    for bad in (b"KZC1", b"KZC0" + bytes(40), ours[:-1] if len(ours) > 40 else b"KZC1" * 9):
        for decode in (packed.decode_packed_batch, jax_packed.decode_packed_batch):
            with pytest.raises(ValueError):
                decode(bad)


@pytest.mark.parametrize("writer,reader", [(jax_ring, shm_ring), (shm_ring, jax_ring)],
                         ids=["jax-to-port", "port-to-jax"])
def test_ring_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    path = str(tmp_path / "ring")
    w = writer.ShmRing(path, capacity=4096, create=True)
    r = reader.ShmRing(path)
    rng = np.random.default_rng(1)
    sent, got = [], []
    for i in range(120):  # wraps the ring many times (skip markers)
        rec = bytes(rng.integers(0, 256, int(rng.integers(1, 700)), dtype=np.uint8))
        if w.write(rec):
            sent.append(rec)
        if i % 3 == 2:
            while (rec := r.read()) is not None:
                got.append(rec)
    while (rec := r.read()) is not None:
        got.append(rec)
    assert got == sent and len(sent) > 60
    assert r.capacity == w.capacity == 4096 and len(r) == 0
    assert not w.write(bytes(5000))  # never fits
    r.close()
    w.close()
    w.unlink()
    assert shm_ring.default_ring_dir() == jax_ring.default_ring_dir()


# --------------------------------------------------------------------------
# One seeded stream through a started pool of each package
# --------------------------------------------------------------------------

PODS = ["pod-a", "pod-b", "pod-c", "pod-d", "pod-e"]


def seeded_stream(seed=0):
    """Wire messages (topic, seq, kind, content) and ring frames: chains of
    BlockStored per pod (msgpack and packed), removals, a clear, dp ranks,
    a malformed frame. Each pod draws its own engine keys and tokens, so
    shards are independent and a pod's order is its shard's."""
    rng = np.random.default_rng(seed)
    wire, ring = [], []
    seqs = {p: 0 for p in PODS}
    chains = {p: [] for p in PODS}  # engine keys stored, in chain order
    for step in range(70):
        pod = PODS[int(rng.integers(0, len(PODS)))]
        seqs[pod] += 1
        topic = f"kv@{pod}@m"
        r = rng.random()
        n = int(rng.integers(1, 4))
        keys = [int(k) for k in rng.integers(1, 2**64, n, dtype=np.uint64)]
        toks = [int(t) for t in rng.integers(0, 50_000, n * BLOCK)]
        parent = chains[pod][-1] if chains[pod] and rng.random() < 0.7 else 0
        if r < 0.4:
            dp = int(rng.integers(0, 2)) if pod == "pod-e" else None
            ev = ("stored", keys, parent, toks, dp)
            chains[pod].extend(keys)
        elif r < 0.65:
            ev = ("packed", keys, parent, toks)
            chains[pod].extend(keys)
        elif r < 0.78 and chains[pod]:
            k = int(rng.integers(1, len(chains[pod]) + 1))
            ev = ("removed", chains[pod][-k:])
        elif r < 0.82:
            ev = ("cleared",)
        elif r < 0.87:
            ev = ("malformed",)
        else:
            ev = ("tier", chains[pod][-2:])  # tokenless: a device-tier update
        wire.append((topic, seqs[pod], pod, ev))
    for i in range(5):  # ring frames, written after the wire drained
        pod = PODS[i % 2]
        keys = [int(k) for k in rng.integers(1, 2**64, 2, dtype=np.uint64)]
        toks = [int(t) for t in rng.integers(0, 50_000, 2 * BLOCK)]
        ring.append((pod, keys, toks))
    return wire, ring


def payload_of(mod, pod, ev, ts):
    """The bytes one message carries, framed by ``mod``'s package."""
    kind = ev[0]
    if kind == "packed":
        enc = packed.encode_packed_batch if mod is model else jax_packed.encode_packed_batch
        return enc(pod, "m", ev[1], ev[3], timestamp=ts, parent_hash=ev[2], block_size=BLOCK)
    if kind == "malformed":
        return b"KZC1\x00\x01" if pod < "pod-c" else b"\x93\x01"
    if kind == "stored":
        events = [mod.BlockStoredEvent(block_hashes=ev[1], tokens=ev[3], parent_hash=ev[2],
                                       block_size=BLOCK)]
        dp = ev[4]
    elif kind == "removed":
        events, dp = [mod.BlockRemovedEvent(block_hashes=ev[1])], None
    elif kind == "tier":
        events, dp = [mod.BlockStoredEvent(block_hashes=ev[1], tokens=[], block_size=BLOCK,
                                           device_tier="cpu")], None
    else:
        events, dp = [mod.AllBlocksClearedEvent()], None
    if mod is model:
        return encode_batch(events, ts, data_parallel_rank=dp)
    from llmd_kv_cache_tpu.events.publisher import encode_event

    batch = [ts, [encode_event(e) for e in events]]
    if dp is not None:
        batch.append(dp)
    return pack(batch)


def index_dump(index) -> tuple[dict, dict]:
    entries = {}
    for rk in index._data.keys():
        pc = index._data.peek(rk)
        entries[rk] = sorted(dataclasses.astuple(e) for e in pc.cache.keys())
    mappings = {ek: list(index._engine_to_request.peek(ek))
                for ek in index._engine_to_request.keys()}
    return entries, mappings


def run_stream(side, tmp_path, wire, ring):
    mod = model if side == "port" else jax_model
    tok_cfg = dict(block_size_tokens=BLOCK)
    if side == "port":
        tp, index, Cfg, P, Ring = (ChunkedTokenDatabase(TokenProcessorConfig(**tok_cfg)),
                                   InMemoryIndex(), PoolConfig, Pool, shm_ring.ShmRing)
    else:
        tp, index, Cfg, P, Ring = (JaxTokens(JaxTokensConfig(**tok_cfg)), JaxIndex(),
                                   JaxPoolConfig, JaxPool, jax_ring.ShmRing)
    ring_path = str(tmp_path / f"{side}.ring")
    writer = Ring(ring_path, capacity=1 << 16, create=True)
    cfg = Cfg.from_dict({"concurrency": 3, "ingestQueueMax": 16, "ingestBatchMax": 4,
                         "trackDPRank": True, "shmRingPath": ring_path,
                         "shmRingPollS": 0.0005})
    pool = P(cfg, index, tp)
    ts = 1.7e9
    # Queued before the workers start: the drop-oldest overflow is the same
    # in both packages (same shards, same order).
    for topic, seq, pod, ev in wire:
        pool.add_task(mod.RawMessage(topic=topic, sequence=seq,
                                     payload=payload_of(mod, pod, ev, ts)))
    pool.start()
    try:
        pool.join()
        enc = packed.encode_packed_batch if side == "port" else jax_packed.encode_packed_batch
        for pod, keys, toks in ring:  # fewer frames than a shard holds: no drop
            assert writer.write(enc(pod, "m", keys, toks, timestamp=ts, block_size=BLOCK))
        deadline = time.monotonic() + 10
        while pool.shm_messages < len(ring):
            assert time.monotonic() < deadline, "the ring did not drain"
            time.sleep(0.002)
        pool.join()
    finally:
        pool.shutdown()
        writer.close()
    return dict(dump=index_dump(index), shards=dict(pool._shard_cache),
                counters={k: getattr(pool, k) for k in (
                    "dropped_events", "ingest_messages", "zerocopy_batches", "shm_messages",
                    "fenced_batches")},
                lag_pods=sorted(pool.lag_stats()["pods"]),
                gaps={p: st["seq_gaps"] for p, st in pool.lag_stats()["pods"].items()},
                groups=pool.group_catalog.groups("pod-a"))


def test_started_pools_fed_one_stream_leave_equal_indexes(tmp_path):
    wire, ring = seeded_stream(0)
    port = run_stream("port", tmp_path, wire, ring)
    ref = run_stream("jax", tmp_path, wire, ring)
    assert port == ref
    c = port["counters"]
    assert c["dropped_events"] > 0 and c["zerocopy_batches"] > len(ring)
    assert c["shm_messages"] == len(ring)
    assert c["ingest_messages"] == len(wire) - c["dropped_events"] + len(ring)
    entries, _ = port["dump"]
    pods = {row[0] for rows in entries.values() for row in rows}
    assert {"pod-e|dp0", "pod-e|dp1"} & pods and "cpu" in {
        row[1] for rows in entries.values() for row in rows}


def test_pool_config_from_dict_and_membership_refusal():
    d = {"zmqEndpoint": "tcp://*:5557", "topicFilter": "kv@x", "concurrency": 0,
         "engineType": "sglang", "discoverPods": True, "trackDPRank": True,
         "ingestBatchMax": 0, "ingestQueueMax": 0, "ingestZeroCopy": 0,
         "shmRingPath": None, "shmRingBytes": 4096, "livenessStaleAfterSeconds": 0,
         "podDiscoveryConfig": {"podLabelSelector": "a=b", "socketPort": 0}}
    ours, ref = PoolConfig.from_dict(d), JaxPoolConfig.from_dict(d)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(PoolConfig.from_dict(None)) == dataclasses.asdict(
        JaxPoolConfig.from_dict(None))
    pool = Pool(ours, InMemoryIndex(), ChunkedTokenDatabase(TokenProcessorConfig()))
    assert pool.liveness is None and isinstance(pool.adapter, SGLangAdapter)
    # The membership's write fence refuses a batch stamped with a stale
    # epoch (fence mode reject); the full fence sequence is held against
    # JAX's in tests/test_torch_cluster.py.
    from llmd_kv_cache_tpu_torch.cluster.membership import MembershipTable

    table = MembershipTable(fence_mode="reject", epoch=3)
    pool.attach_membership(table)
    assert pool.membership is table
    pool.process_event_batch(model.EventBatch(timestamp=0.0, events=[], epoch=2), "pod-z", "m")
    assert pool.data_plane_debug() == {"zerocopy_batches": 0, "shm_messages": 0,
                                       "fenced_batches": 1}


def test_replay_seed_sequences_and_journal_as_jax():
    out = {}
    for side in ("port", "jax"):
        mod = model if side == "port" else jax_model
        if side == "port":
            pool = Pool(None, InMemoryIndex(), ChunkedTokenDatabase(TokenProcessorConfig(
                block_size_tokens=BLOCK)))
        else:
            pool = JaxPool(None, JaxIndex(), JaxTokens(JaxTokensConfig(block_size_tokens=BLOCK)))
        journal = []
        pool.seed_sequences({"pod-a": 5, "pod-b": 2}, 100.0)
        pool.replay_record("kv@pod-a@m", 6, payload_of(mod, "pod-a", ("stored", [7], 0,
                                                                      [1, 2, 3, 4], None), 1.0))
        pool.journal_sink = lambda *a: journal.append(a)
        pool._process_raw_message(mod.RawMessage("kv@pod-b@m", 9, payload_of(
            mod, "pod-b", ("removed", [7]), 2.0)))
        stats = pool.lag_stats()
        out[side] = ({p: (st["last_seq"], st["seq_gaps"], st["messages"])
                      for p, st in stats["pods"].items()}, journal,
                     index_dump(pool.index), pool.index_staleness_s(now=200.0))
    assert out["port"] == out["jax"]


def test_process_event_batch_rewrites_dp_rank_and_touches_liveness():
    out = {}
    for side in ("port", "jax"):
        mod, P, Cfg = ((model, Pool, PoolConfig) if side == "port"
                       else (jax_model, JaxPool, JaxPoolConfig))
        idx, tp = ((InMemoryIndex(), ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=BLOCK)))
                   if side == "port" else
                   (JaxIndex(), JaxTokens(JaxTokensConfig(block_size_tokens=BLOCK))))
        pool = P(Cfg(track_dp_rank=True), idx, tp)
        batch = mod.EventBatch(timestamp=0.0, data_parallel_rank=2, events=[
            mod.BlockStoredEvent(block_hashes=[1], tokens=[1, 2, 3, 4], block_size=BLOCK)])
        pool.process_event_batch(batch, "pod-x", "m")
        out[side] = (index_dump(idx), pool.liveness.last_seen("pod-x|dp2") is not None)
    assert out["port"] == out["jax"] and out["port"][1]


# --------------------------------------------------------------------------
# Liveness
# --------------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_liveness_factors_and_scores_equal_on_a_fake_clock():
    clocks = {"port": Clock(), "jax": Clock()}
    tracker = {"port": PodLivenessTracker(10.0, 40.0, latency_demote_after_s=0.2,
                                          latency_drop_after_s=1.0, clock=clocks["port"]),
               "jax": JaxLiveness(10.0, 40.0, latency_demote_after_s=0.2,
                                  latency_drop_after_s=1.0, clock=clocks["jax"])}
    ix = {"port": Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
              block_size_tokens=BLOCK))),
          "jax": JaxIndexer(JaxIndexerConfig(token_processor_config=JaxTokensConfig(
              block_size_tokens=BLOCK)), index=JaxIndex())}
    entry = {"port": PodEntry, "jax": JaxPodEntry}
    toks = list(range(1, 17))
    for side in ("port", "jax"):
        keys = ix[side].compute_block_keys(toks, "m")
        for pod, n in (("a", 4), ("b", 3), ("c", 2)):
            ix[side].kv_block_index.add(keys[:n], keys[:n], [entry[side](pod, "tpu-hbm")])
            tracker[side].touch(pod)
        ix[side].attach_liveness(tracker[side])
    seen = []
    for dt, pod_touch, lat in ((0, None, None), (15, "b", None), (10, None, ("c", 0.6)),
                               (20, None, ("c", 0.6)), (30, "a", None), (100, None, None)):
        got = {}
        for side in ("port", "jax"):
            clocks[side].t += dt
            if pod_touch:
                tracker[side].touch(pod_touch)
            if lat:
                for _ in range(6):
                    tracker[side].observe_latency(*lat)
            got[side] = (ix[side].score_tokens(toks, "m"), tracker[side].snapshot(),
                         [tracker[side].staleness(p) for p in "abcz"])
        assert got["port"] == got["jax"]
        seen.append(got["port"][0])
    assert seen[0] == {"a": 4.0, "b": 3.0, "c": 2.0} and seen[-1] == {}
    with pytest.raises(ValueError, match="must exceed"):
        PodLivenessTracker(5.0, 5.0)


# --------------------------------------------------------------------------
# Tracing and the engine's sink
# --------------------------------------------------------------------------

def test_ingest_span_is_a_child_of_the_publishing_span():
    with tracing.recording_tracing() as exporter:
        pool = Pool(PoolConfig(concurrency=2), InMemoryIndex(),
                    ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=BLOCK)))
        pool.start()
        try:
            with tracing.tracer().span("engine.commit") as root:
                payload = encode_batch([model.BlockStoredEvent(
                    block_hashes=[5], tokens=[1, 2, 3, 4], block_size=BLOCK)], time.time(),
                    traceparent=tracing.current_traceparent())
            pool.add_task(model.RawMessage("kv@pod-t@m", 0, payload))
            pool.join()
        finally:
            pool.shutdown()
        [ingest] = [s for s in exporter.spans if s.name == "llm_d.kv_cache.events.ingest"]
    assert (ingest.trace_id, ingest.parent_span_id) == (root.trace_id, root.span_id)
    assert ingest.attributes["pod"] == "pod-t" and ingest.attributes["event_count"] == 1


TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=BLOCK)


class _SubReader:
    """A SUB socket on the JAX publisher's inproc endpoint, read inline:
    every message becomes a RawMessage for the JAX pool."""

    def __init__(self, ctx, endpoint, publisher):
        self.sock = ctx.socket(zmq.SUB)
        self.sock.setsockopt_string(zmq.SUBSCRIBE, "kv@")
        self.sock.connect(endpoint)
        deadline = time.monotonic() + 5
        while not self.sock.poll(10):  # the slow joiner: probe until one lands
            assert time.monotonic() < deadline
            publisher.publish([])
        self.drain(lambda _m: None)

    def drain(self, sink):
        while self.sock.poll(50):
            topic, seq, payload = self.sock.recv_multipart()
            sink(jax_model.RawMessage(topic.decode(), int.from_bytes(seq, "big"), payload))


def test_engine_sink_encode_batch_add_task_equals_jax_publish(tmp_path):
    prompts = [list(range(1, 20)), list(range(1, 12)) + [7, 7, 7], list(range(30, 41))]
    # JAX: engine → KVEventPublisher.publish → ZMQ → the JAX pool.
    ctx = zmq.Context()
    endpoint = "inproc://engine-events"
    pub = JaxPublisher(endpoint, "pod-0", "tiny", bind=True, context=ctx)
    reader = _SubReader(ctx, endpoint, pub)
    jax_pool = JaxPool(JaxPoolConfig(concurrency=2), JaxIndex(),
                       JaxTokens(JaxTokensConfig(block_size_tokens=BLOCK)))
    jax_pool.start()
    jeng = jax_engine.MiniEngine(
        jax_engine.EngineConfig(model=jax_llama.LlamaConfig(**TINY, dtype=jnp.float32),
                                max_pages_per_seq=16, num_pages=64, model_name="tiny",
                                pod_identifier="pod-0"),
        event_sink=lambda evs: pub.publish(evs), seed=0)
    # The port: engine → encode_batch → RawMessage → Pool.add_task.
    pool = Pool(PoolConfig(concurrency=2), InMemoryIndex(),
                ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=BLOCK)))
    pool.start()
    seq = iter(range(1 << 30))
    params = llama.params_from_jax(jax_llama_params(jeng), llama.LlamaConfig(
        **TINY, dtype=torch.float32), device="cpu")
    peng = engine.MiniEngine(
        engine.EngineConfig(model=llama.LlamaConfig(**TINY, dtype=torch.float32),
                            max_pages_per_seq=16, num_pages=64, model_name="tiny",
                            pod_identifier="pod-0"),
        event_sink=lambda evs: pool.add_task(model.RawMessage(
            "kv@pod-0@tiny", next(seq), encode_batch(evs, time.time()))),
        params=params, device="cpu")
    try:
        for i, p in enumerate(prompts):
            assert jeng.generate(f"r{i}", p, max_new_tokens=2) == peng.generate(
                f"r{i}", p, max_new_tokens=2)
        reader.drain(jax_pool.add_task)
        jax_pool.join()
        pool.join()
        assert index_dump(pool.index) == index_dump(jax_pool.index)
        assert len(pool.index) > 0
        assert pool.lag_stats()["pods"]["pod-0"]["seq_gaps"] == 0
    finally:
        pool.shutdown()
        jax_pool.shutdown()
        pub.close()
        reader.sock.close()
        ctx.term()


def jax_llama_params(jeng):
    import jax

    return jax.tree_util.tree_map(np.asarray, jeng.params)


def test_parse_failures_are_logged_by_events_pool(caplog):
    pool = Pool(PoolConfig(concurrency=1), InMemoryIndex(), ChunkedTokenDatabase(
        TokenProcessorConfig(block_size_tokens=BLOCK)))
    with caplog.at_level(logging.ERROR, logger="llmd_kv_cache_tpu_torch.events.pool"):
        pool._process_raw_batch([model.RawMessage("kv@p@m", 0, b"\xc1"),
                                 model.RawMessage("kv@p@m", 1, b"KZC1")])
    assert [r.getMessage() for r in caplog.records] == [
        "failed to parse message on topic kv@p@m",
        "failed to decode packed frame on topic kv@p@m"]
    assert pool.ingest_messages == 2 and pool.ingest_batches == 1
