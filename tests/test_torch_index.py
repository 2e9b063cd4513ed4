"""The port's index backends, backend selection, indexer and router against
the JAX package's.

Every backend of the port (in-memory, native, cost-aware, Redis on
``tests/fake_redis.py``, instrumented, traced, failover) runs the JAX
contract suite's scenarios beside the JAX backend of the same kind, and the
two transcripts must be equal: keys, entries (in order, ``speculative`` and
group included) and block counts exactly. Scores are held to
``abs <= 1e-12``. Also held against JAX: snapshots across the packages,
``create_index`` and ``IndexerConfig.from_dict`` on JAX's config dicts,
``Indexer.score_tokens`` over the native index (fused chunked path,
residency, the cost-aware tier discount, the data-plane counters), the
index metric families, ``KVAwareRouter`` on a seeded prompt stream, the
multimodal block features and ``parse_bytes``.
"""

import threading

import numpy as np
import pytest

from llmd_kv_cache_tpu.core import BlockExtraFeatures as JaxFeatures
from llmd_kv_cache_tpu.core import KeyType as JaxKeyType
from llmd_kv_cache_tpu.core import PlaceholderRange as JaxRange
from llmd_kv_cache_tpu.core import PodEntry as JaxPodEntry
from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokensConfig
from llmd_kv_cache_tpu.core import compute_block_extra_features as jax_block_features
from llmd_kv_cache_tpu.index import cost_aware as jax_cost_aware
from llmd_kv_cache_tpu.index import in_memory as jax_in_memory
from llmd_kv_cache_tpu.index import instrumented as jax_instrumented
from llmd_kv_cache_tpu.index import native as jax_native
from llmd_kv_cache_tpu.index import redis_index as jax_redis
from llmd_kv_cache_tpu.index.base import create_index as jax_create_index
from llmd_kv_cache_tpu.resilience import failover as jax_failover
from llmd_kv_cache_tpu.scoring import Indexer as JaxIndexer
from llmd_kv_cache_tpu.scoring import IndexerConfig as JaxIndexerConfig
from llmd_kv_cache_tpu.scoring.residency import ResidencyTracker as JaxTracker
from llmd_kv_cache_tpu.scoring.router import KVAwareRouter as JaxRouter
from llmd_kv_cache_tpu.scoring.router import RouterConfig as JaxRouterConfig
from llmd_kv_cache_tpu.utils.humanize import parse_bytes as jax_parse_bytes

from llmd_kv_cache_tpu_torch.core.extra_keys import (
    BlockExtraFeatures,
    PlaceholderRange,
    compute_block_extra_features,
)
from llmd_kv_cache_tpu_torch.core.keys import KeyType, PodEntry
from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
from llmd_kv_cache_tpu_torch.index import cost_aware, in_memory, instrumented, native, redis_index
from llmd_kv_cache_tpu_torch.index.base import IndexConfig, create_index
from llmd_kv_cache_tpu_torch.metrics import collector
from llmd_kv_cache_tpu_torch.resilience import failover
from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig
from llmd_kv_cache_tpu_torch.scoring.residency import ResidencyTracker
from llmd_kv_cache_tpu_torch.scoring.router import KVAwareRouter, RouterConfig
from llmd_kv_cache_tpu_torch.telemetry.flight_recorder import KIND_FAILOVER, flight_recorder
from llmd_kv_cache_tpu_torch.utils.humanize import parse_bytes

from fake_redis import FakeRedis
from torch_telemetry_helpers import (
    private_flight_recorders,
    private_jax_metrics,
    private_port_metrics,
    samples,
)

BLOCK = 4
MODEL = "m"


@pytest.fixture(autouse=True)
def registries(monkeypatch):
    """Both packages' metric families and flight recorders of the test's
    own (the JAX fleet tests later in the worker read the process-wide
    ones)."""
    regs = {"jax": private_jax_metrics(monkeypatch), "port": private_port_metrics(monkeypatch)}
    with private_flight_recorders():
        yield regs


class _Down:
    """A primary whose every call raises (a Redis server that is gone)."""

    def __getattr__(self, name):
        def fail(*args, **kwargs):
            raise ConnectionError("primary down")
        return fail


def backend(kind: str, port: bool):
    """The backend of one kind, from the port or from the JAX package."""
    m = (in_memory, cost_aware, native, redis_index, instrumented, failover) if port else (
        jax_in_memory, jax_cost_aware, jax_native, jax_redis, jax_instrumented, jax_failover)
    mem, cost, nat, red, ins, fo = m
    small = lambda: mem.InMemoryIndex(mem.InMemoryIndexConfig(size=10_000, pod_cache_size=4))
    return {
        "in_memory": small,
        "cost_aware": lambda: cost.CostAwareMemoryIndex(
            cost.CostAwareMemoryIndexConfig(max_cost="64MiB")),
        "native": lambda: nat.NativeIndex(nat.NativeIndexConfig(size=10_000, pod_cache_size=4)),
        "redis": lambda: red.RedisIndex(red.RedisIndexConfig(), client=FakeRedis()),
        "instrumented": lambda: ins.InstrumentedIndex(small()),
        "traced": lambda: ins.TracedIndex(small()),
        "failover": lambda: fo.FailoverIndex(
            red.RedisIndex(red.RedisIndexConfig(), client=FakeRedis()), small()),
        "failover_down": lambda: fo.FailoverIndex(_Down(), small()),
    }[kind]()


BACKENDS = ["in_memory", "native", "cost_aware", "redis", "instrumented", "traced",
            "failover", "failover_down"]


def rows(result):
    return {k: [(e.pod_identifier, e.device_tier, e.speculative, e.has_group, e.group_idx)
                for e in es] for k, es in result.items()}


# Each scenario takes (index, PodEntry, KeyType) and returns a transcript.

def sc_roundtrip_filters_and_gaps(ix, E, K):
    out = []
    ix.add([1, 2, 3], [11, 12, 13], [E("a", "tpu-hbm"), E("b", "cpu")])
    ix.add([4], [14], [E("c", "tpu-hbm")])
    out.append(rows(ix.lookup([11, 12, 13, 14])))
    out.append(rows(ix.lookup([11, 12, 13], {"b"})))
    out.append(rows(ix.lookup([11, 12], set())))
    out.append(rows(ix.lookup([11, 99, 12, 13])))  # an absent key in the chain
    out.append(rows(ix.lookup([11, 12], {"nope"})))
    for bad in (lambda: ix.lookup([]), lambda: ix.add([1], [], [E("a", "t")]),
                lambda: ix.add([1], [1], []), lambda: ix.evict(11, K.REQUEST, [])):
        with pytest.raises(ValueError):
            bad()
    return out


def sc_engine_mappings(ix, E, K):
    e = [E("p", "tpu-hbm")]
    ix.add([1, 2], [21, 22], e)           # 1:1
    ix.add([3, 4, 5, 6], [23, 24], e)     # many:1
    ix.add([7], [25, 26, 27], e)          # 1:many
    return [ix.get_request_key(k) for k in (1, 2, 3, 4, 5, 6, 7, 99)]


def sc_evictions(ix, E, K):
    a, b = E("a", "tpu-hbm"), E("b", "tpu-hbm")
    ix.add([1, 2, 3], [31, 32, 33], [a, b])
    ix.evict(2, K.ENGINE, [a])
    out = [rows(ix.lookup([31, 32, 33]))]
    ix.evict(33, K.REQUEST, [a, b])
    out.append(rows(ix.lookup([31, 32, 33])))
    ix.evict(12345, K.ENGINE, [a])  # unknown engine key: no-op
    ix.evict_batch([31, 32], K.REQUEST, [b])
    out.append(rows(ix.lookup([31, 32, 33])))
    out.append([ix.get_request_key(k) for k in (1, 2, 3)])
    return out


def sc_speculative_and_tiers(ix, E, K):
    ix.add(None, [41, 42], [E("a", "tpu-hbm", speculative=True)])
    ix.add([1, 2], [41, 42], [E("a", "tpu-hbm"), E("a", "cpu"),
                              E("b", "tpu-hbm", has_group=True, group_idx=2)])
    out = [rows(ix.lookup([41, 42]))]
    ix.evict(41, K.REQUEST, [E("a", "tpu-hbm", speculative=True)])
    out.append(rows(ix.lookup([41, 42])))
    out.append(ix.get_request_key(1))
    return out


def sc_clear(ix, E, K):
    ix.add([1, 2], [51, 52], [E("a", "tpu-hbm"), E("a", "cpu"), E("b", "tpu-hbm")])
    ix.add([3], [53], [E("a", "shared_storage")])
    ix.clear("a")
    out = [rows(ix.lookup([51, 52, 53]))]
    ix.clear("nobody")
    out.append(rows(ix.lookup([51, 52])))
    return out


def sc_concurrent_add_evict(ix, E, K):
    e = [E("p", "tpu-hbm")]
    ix.add([1], [61], e)
    stop = threading.Event()

    def storm():
        while not stop.is_set():
            ix.add([2], [62], e)
            ix.evict(2, K.ENGINE, e)

    threads = [threading.Thread(target=storm) for _ in range(2)]
    for t in threads:
        t.start()
    for _ in range(100):
        ix.lookup([61, 62])
    stop.set()
    for t in threads:
        t.join()
    ix.add([2], [62], e)
    return rows(ix.lookup([61, 62]))


def sc_chunked_lookup(ix, E, K):
    keys = list(range(70, 90))
    ix.add(keys[:9], keys[:9], [E("a", "tpu-hbm")])
    ix.add(keys[12:], keys[12:], [E("a", "tpu-hbm")])
    return [rows(ix.lookup_chunked(keys, None, chunk_size=c)) for c in (0, 1, 4, 8, 128)]


SCENARIOS = [sc_roundtrip_filters_and_gaps, sc_engine_mappings, sc_evictions,
             sc_speculative_and_tiers, sc_clear, sc_concurrent_add_evict, sc_chunked_lookup]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
@pytest.mark.parametrize("kind", BACKENDS)
def test_contract_matches_jax_backend(kind, scenario):
    got = scenario(backend(kind, True), PodEntry, KeyType)
    want = scenario(backend(kind, False), JaxPodEntry, JaxKeyType)
    assert got == want


def test_failover_records_and_counts_as_jax():
    ours, ref = backend("failover_down", True), backend("failover_down", False)
    for ix, E in ((ours, PodEntry), (ref, JaxPodEntry)):
        ix.add([1], [11], [E("a", "tpu-hbm")])
        ix.lookup([11])
        ix.get_request_key(1)
    assert ours.failovers == ref.failovers == 2
    recs = [r for r in flight_recorder().export_since(-1)["records"]
            if r["kind"] == KIND_FAILOVER]
    assert [r["data"]["op"] for r in recs] == ["lookup", "get_request_key"]
    assert ours.dump_state() == ref.dump_state()


# --------------------------------------------------------------------------
# snapshots across the packages
# --------------------------------------------------------------------------

def seeded_adds(ix, E, seed=4):
    rng = np.random.default_rng(seed)
    for i in range(30):
        n = int(rng.integers(1, 6))
        rks = [int(k) for k in rng.integers(1, 2**63, n, dtype=np.int64)]
        eks = [int(k) for k in rng.integers(1, 2**63, int(rng.integers(1, 4)), dtype=np.int64)]
        entry = E(f"pod-{i % 3}", ("tpu-hbm", "cpu")[i % 2], speculative=i % 5 == 0,
                  has_group=i % 4 == 0, group_idx=i % 3)
        ix.add(eks if i % 7 else None, rks, [entry])


def canonical(state):
    return ({k: sorted(map(tuple, r)) for k, r in state["entries"]},
            {k: list(v) for k, v in state["mappings"]})


@pytest.mark.parametrize("src,dst", [("in_memory", "native"), ("native", "in_memory"),
                                     ("native", "native")])
def test_dump_restore_round_trips_across_packages(src, dst):
    for src_port in (True, False):
        a = backend(src, src_port)
        seeded_adds(a, PodEntry if src_port else JaxPodEntry)
        state = a.dump_state()
        b = backend(dst, not src_port)
        assert b.restore_state(state) == sum(len(r) for _, r in state["entries"])
        assert canonical(b.dump_state()) == canonical(state)
        keys = [k for k, _ in state["entries"]]
        assert rows(b.lookup(keys)) == rows(a.lookup(keys))
    for kind in ("redis", "cost_aware"):  # no snapshot capability
        assert backend(kind, True).dump_state() is None
        assert backend(kind, True).restore_state(state) == 0


# --------------------------------------------------------------------------
# backend selection and config
# --------------------------------------------------------------------------

def test_create_index_priority_and_wrappers_match_jax():
    from llmd_kv_cache_tpu.index.base import IndexConfig as JaxIndexConfig

    def shape(ix):
        names = []
        while ix is not None:
            names.append(type(ix).__name__)
            ix = getattr(ix, "_inner", getattr(ix, "primary", None))
        return names

    cases = [
        {},
        {"in_memory_config": "mem"},
        {"cost_aware_memory_config": "cost", "native_config": "nat"},
        {"native_config": "nat", "in_memory_config": "mem", "enable_metrics": True},
        {"in_memory_config": "mem", "enable_metrics": True, "enable_tracing": True},
    ]
    for case in cases:
        built = []
        for mods, cls in (((in_memory, cost_aware, native), IndexConfig),
                          ((jax_in_memory, jax_cost_aware, jax_native), JaxIndexConfig)):
            mem, cost, nat = mods
            cfg = {"mem": mem.InMemoryIndexConfig(size=100), "cost":
                   cost.CostAwareMemoryIndexConfig(), "nat": nat.NativeIndexConfig(size=100)}
            kw = {k: cfg.get(v, v) if isinstance(v, str) else v for k, v in case.items()}
            built.append(shape((create_index if cls is IndexConfig else jax_create_index)(
                cls(**kw) if kw else None)))
        assert built[0] == built[1], case
    assert shape(create_index(None)) == ["NativeIndex"]
    assert isinstance(Indexer().kv_block_index, native.NativeIndex)


JAX_CONFIGS = [
    None,
    {},
    {"tokenProcessorConfig": {"blockSizeTokens": 8, "hashSeed": "s", "prefixCacheTokens": 0},
     "lookupChunkSize": 0},
    {"tokenProcessorConfig": {"blockSize": 32}, "kvBlockIndexConfig": {
        "inMemoryConfig": {"size": 500, "podCacheSize": 3}, "enableMetrics": True}},
    {"kvBlockIndexConfig": {"nativeConfig": {"size": 1000, "podCacheSize": 4,
                                             "mappingSize": 2000}},
     "kvBlockScorerConfig": {"scoringStrategy": "LongestPrefix", "backendConfigs": [
         {"name": "tpu-hbm", "weight": 1.0}, {"name": "cpu", "weight": 0.25}]}},
    {"kvBlockIndexConfig": {"costAwareMemoryConfig": {"maxCost": "1MiB"},
                            "enableTracing": True}},
    {"kvBlockIndexConfig": {"valkeyConfig": {"address": "valkey://h:1"}}},
    {"kvBlockIndexConfig": {"redisConfig": {"address": "h:2"},
                            "valkeyConfig": {"address": "valkey://h:1"}}},
]


@pytest.mark.parametrize("d", JAX_CONFIGS, ids=range(len(JAX_CONFIGS)))
def test_indexer_config_from_dict_matches_jax(d):
    ours, ref = IndexerConfig.from_dict(d), JaxIndexerConfig.from_dict(d)
    assert vars(ours.token_processor_config) == vars(ref.token_processor_config)
    assert ours.lookup_chunk_size == ref.lookup_chunk_size
    assert ours.scorer_config.scoring_strategy == ref.scorer_config.scoring_strategy
    assert [vars(b) for b in ours.scorer_config.backend_configs] == \
        [vars(b) for b in ref.scorer_config.backend_configs]
    if ref.index_config is None:
        assert ours.index_config is None
        return
    for name in ("in_memory_config", "cost_aware_memory_config", "native_config"):
        a, b = getattr(ours.index_config, name), getattr(ref.index_config, name)
        assert (a is None) == (b is None) and (a is None or vars(a) == vars(b)), name
    for name in ("redis_config", "enable_metrics", "enable_tracing",
                 "metrics_logging_interval_s", "failover_to_memory"):
        assert getattr(ours.index_config, name) == getattr(ref.index_config, name), name
    if ref.index_config.redis_config is None:
        made = [type(Indexer(ours).kv_block_index).__name__,
                type(JaxIndexer(ref).kv_block_index).__name__]
        assert made[0] == made[1]


@pytest.mark.parametrize("key", ["recoveryConfig", "clusterConfig", "fleetTelemetry"])
def test_indexer_config_refuses_planes_not_ported(key):
    """The fleet-telemetry key (A.8.6) raises; the endpoint and shedding
    keys are taken since the services' port (``tests/test_torch_services.py``).
    The cluster and recovery planes are ported: their keys are taken, as
    JAX takes them (``tests/test_torch_cluster.py`` and
    ``tests/test_torch_recovery.py`` hold the configs against JAX's)."""
    if key == "clusterConfig":
        cfg = IndexerConfig.from_dict({key: {"shardAddresses": ["a:1", "b:2"], "shardId": "a:1"}})
        assert cfg.cluster_config.membership() == ["a:1", "b:2"]
        assert cfg.cluster_config.shard_id == "a:1"
    elif key == "recoveryConfig":
        cfg = IndexerConfig.from_dict({key: {"snapshotDir": "/x"}})
        assert cfg.recovery_config.snapshot_dir == "/x" and cfg.recovery_config.enabled
        assert IndexerConfig.from_dict({key: None}).recovery_config is None
    else:
        with pytest.raises(NotImplementedError, match=r"ROADMAP A\.8\.6"):
            IndexerConfig.from_dict({key: {"snapshotDir": "/x"}})
    assert IndexerConfig.from_dict({key: None}).cluster_config is None


def test_redis_index_needs_a_client_or_the_package():
    with pytest.raises(RuntimeError, match="requires the 'redis' package"):
        redis_index.RedisIndex({"address": "valkey://h:1", "backendType": "valkey"})
    cfg = redis_index.RedisIndexConfig.from_dict({"address": "h:2", "enableRDMA": True})
    assert vars(cfg) == vars(jax_redis.RedisIndexConfig.from_dict(
        {"address": "h:2", "enableRDMA": True}))


def test_redis_prunes_scripted_and_check_then_delete():
    class NoEval:
        def __init__(self):
            self._inner = FakeRedis()

        def __getattr__(self, name):
            if name == "eval":
                raise AttributeError(name)
            return getattr(self._inner, name)

    for client, scripted in ((FakeRedis(), True), (NoEval(), False)):
        ix = redis_index.RedisIndex(redis_index.RedisIndexConfig(), client=client)
        assert ix._scripting is scripted
        ix.add([5], [11, 22], [PodEntry("p", "tpu-hbm")])
        ix.evict(11, KeyType.REQUEST, [PodEntry("p", "tpu-hbm")])
        assert client.hlen("11") == 0 and client.zrange("engine:5", 0, -1)
        ix.evict(5, KeyType.ENGINE, [PodEntry("p", "tpu-hbm")])
        assert client.zrange("engine:5", 0, -1) == [] and ix.get_request_key(5) is None


# --------------------------------------------------------------------------
# the indexer over the native index
# --------------------------------------------------------------------------

def make_indexers(chunk_size=4):
    """(port over native, port over the Python index, JAX over native)."""
    cfg = dict(token_processor_config=TokenProcessorConfig(block_size_tokens=BLOCK),
               lookup_chunk_size=chunk_size)
    jcfg = dict(token_processor_config=JaxTokensConfig(block_size_tokens=BLOCK),
                lookup_chunk_size=chunk_size)
    nat = Indexer(IndexerConfig(**cfg))
    py = Indexer(IndexerConfig(**cfg), index=in_memory.InMemoryIndex())
    ref = JaxIndexer(JaxIndexerConfig(**jcfg),
                     index=jax_native.NativeIndex(jax_native.NativeIndexConfig()))
    assert nat._native_score_chunked is not None and py._native_score_chunked is None
    return nat, py, ref


def seed(indexers, tokens, placements):
    keys = indexers[0].compute_block_keys(tokens, MODEL)
    for pod, n, tier in placements:
        for ix in indexers:
            E = JaxPodEntry if isinstance(ix, JaxIndexer) else PodEntry
            ix.kv_block_index.add(None, keys[:n], [E(pod, tier)])
    return keys


def close(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-12 for k in a)


@pytest.mark.parametrize("chunk_size", [0, 2, 4, 128])
def test_score_tokens_native_equals_python_and_jax(chunk_size):
    ixs = make_indexers(chunk_size)
    rng = np.random.default_rng(chunk_size)
    tokens = rng.integers(0, 50000, 12 * BLOCK + 3).tolist()
    keys = seed(ixs, tokens, [("pod-a", 12, "tpu-hbm"), ("pod-b", 7, "cpu"),
                              ("pod-c", 3, "shared_storage"), ("pod-d", 9, "weird")])
    for ix in ixs:  # a chain hole at block 5 for pod-a
        E, K = (JaxPodEntry, JaxKeyType) if isinstance(ix, JaxIndexer) else (PodEntry, KeyType)
        ix.kv_block_index.evict(keys[5], K.REQUEST, [E("pod-a", "tpu-hbm")])
    for pods in (None, {"pod-a", "pod-c"}, {"nope"}):
        for role in ("", "decode"):
            got = [ix.score_tokens(tokens, MODEL, pods, role=role) for ix in ixs]
            assert close(got[0], got[1]) and close(got[0], got[2]), (pods, role)
    assert ixs[0].data_plane_debug() == ixs[2].data_plane_debug()
    assert ixs[0].data_plane_debug()["native_score_calls"] == 6


def test_residency_and_tier_discount_fold_in_as_jax():
    ixs = make_indexers()
    tokens = list(range(8 * BLOCK))
    keys = seed(ixs, tokens, [("pod-a", 8, "tpu-hbm")])
    for ix in ixs:
        tracker = (JaxTracker if isinstance(ix, JaxIndexer) else ResidencyTracker)(
            in_flight_discount=0.5)
        tracker.on_landed("decode-0", keys[:5])
        tracker.on_transfer_started("decode-1", keys[:8])
        tracker.tier_discount_fn = lambda: 0.25
        ix.attach_residency(tracker)
    details = [{} for _ in ixs]
    got = [ix.score_tokens(tokens, MODEL, role="decode", detail=d)
           for ix, d in zip(ixs, details)]
    assert close(got[0], got[1]) and close(got[0], got[2])
    assert close(details[0]["residency"], details[2]["residency"])
    assert close(details[0]["residency"], details[1]["residency"])
    assert abs(details[0]["residency"]["decode-0"] - 5 * 0.25) <= 1e-12
    assert close(ixs[0].score_tokens(tokens, MODEL), ixs[2].score_tokens(tokens, MODEL))


def test_cost_aware_index_wires_the_tier_discount_as_jax():
    bonus = []
    for port in (True, False):
        mod = cost_aware if port else jax_cost_aware
        idx = mod.CostAwareMemoryIndex(mod.CostAwareMemoryIndexConfig(max_cost="1MiB"))
        ix = (Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
            block_size_tokens=BLOCK)), index=idx) if port else JaxIndexer(JaxIndexerConfig(
                token_processor_config=JaxTokensConfig(block_size_tokens=BLOCK)), index=idx))
        tracker = (ResidencyTracker if port else JaxTracker)()
        ix.attach_residency(tracker)
        tokens = list(range(6 * BLOCK))
        tracker.on_landed("decode-0", ix.compute_block_keys(tokens, MODEL)[:4])
        for s in (0.05, 0.2, 0.01):
            idx.observe_tier_latency("shared_storage", s)
        detail = {}
        ix.score_tokens(tokens, MODEL, role="decode", detail=detail)
        bonus.append((detail["residency"], idx.tier_discount("shared_storage"),
                      idx.total_cost))
    assert close(bonus[0][0], bonus[1][0]) and bonus[0][1:] == bonus[1][1:]
    assert 0.0 < bonus[0][1] < 1.0


def test_native_score_spans_and_families_match_jax(registries):
    from llmd_kv_cache_tpu_torch.telemetry.tracing import (
        install_span_exporter,
        uninstall_span_exporter,
    )

    nat, _, ref = make_indexers(chunk_size=2)
    tokens = list(range(10 * BLOCK))
    keys = seed((nat, ref), tokens, [("pod-a", 10, "tpu-hbm")])
    nat.kv_block_index.evict(keys[5], KeyType.REQUEST, [PodEntry("pod-a", "tpu-hbm")])
    ref.kv_block_index.evict(keys[5], JaxKeyType.REQUEST, [JaxPodEntry("pod-a", "tpu-hbm")])
    exp = install_span_exporter()
    try:
        assert close(nat.score_tokens(tokens, MODEL), ref.score_tokens(tokens, MODEL))
    finally:
        uninstall_span_exporter()
    span = [s for s in exp.spans if s.name == "llm_d.kv_cache.score_tokens"][-1]
    assert span.attributes["native_chunks"] == nat.data_plane_debug()["native_score_chunks"]
    assert nat.data_plane_debug() == ref.data_plane_debug()
    assert nat.data_plane_debug()["native_score_early_exits"] == 1
    from prometheus_client import generate_latest as jax_generate_latest

    from llmd_kv_cache_tpu_torch.metrics import generate_latest

    names = ("kvtpu_native_score_chunks_total", "kvtpu_native_score_early_exits_total")
    got = {k: v for k, v in samples(generate_latest(registries["port"]).decode()).items()
           if k[0] in names}
    want = {k: v for k, v in samples(jax_generate_latest(registries["jax"]).decode()).items()
            if k[0] in names}
    assert got == want and got[("kvtpu_native_score_early_exits_total", ())] == 1


def test_instrumented_index_records_the_families_as_jax(registries, monkeypatch):
    from prometheus_client import generate_latest as jax_generate_latest

    from llmd_kv_cache_tpu.metrics import collector as jax_collector
    from llmd_kv_cache_tpu_torch.metrics import generate_latest

    # The decorators bind the families at import: point them at the clones.
    for mod, col in ((instrumented, collector), (jax_instrumented, jax_collector)):
        for name in vars(mod):
            if name.startswith("INDEX_"):
                monkeypatch.setattr(mod, name, getattr(col, name))
    for port in (True, False):
        ix = backend("instrumented", port)
        E, K = (PodEntry, KeyType) if port else (JaxPodEntry, JaxKeyType)
        ix.add([1, 2, 3], [11, 12, 13], [E("a", "tpu-hbm")])
        ix.add([4], [11], [E("b", "cpu")])
        ix.lookup([11, 12, 13, 99])
        ix.lookup([11], {"b"})
        ix.evict(1, K.ENGINE, [E("a", "tpu-hbm")])
        ix.evict_batch([2, 3], K.ENGINE, [E("a", "tpu-hbm")])
    fams = ("kvcache_index_admissions_total", "kvcache_index_evictions_total",
            "kvcache_index_lookup_requests_total", "kvcache_index_lookup_hits_total",
            "kvcache_index_max_pod_hit_count_total", "kvcache_index_lookup_latency_seconds_count")
    got = {k: v for k, v in samples(generate_latest(registries["port"]).decode()).items()
           if k[0] in fams}
    want = {k: v for k, v in samples(jax_generate_latest(registries["jax"]).decode()).items()
            if k[0] in fams}
    assert got == want and len(got) == len(fams)
    assert got[("kvcache_index_evictions_total", ())] == 3
    collector.start_metrics_logging(3600.0)
    collector.stop_metrics_logging()


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["native", "in_memory"])
def test_router_picks_what_jax_picks_on_a_seeded_stream(kind):
    rng = np.random.default_rng(17)
    prefixes = [rng.integers(0, 50000, 8 * BLOCK).tolist() for _ in range(4)]
    stream = []
    for _ in range(40):
        p = prefixes[int(rng.integers(0, 4))]
        stream.append(p[: int(rng.integers(BLOCK, len(p) + 1))]
                      + rng.integers(0, 50000, int(rng.integers(0, 9))).tolist())
    pods = ["pod-a", "pod-b", "pod-c"]
    picks = []
    for port in (True, False):
        ix = (Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
            block_size_tokens=BLOCK)), index=backend(kind, True)) if port else
              JaxIndexer(JaxIndexerConfig(token_processor_config=JaxTokensConfig(
                  block_size_tokens=BLOCK)), index=backend(kind, False)))
        router = (KVAwareRouter(ix, pods, RouterConfig(speculative_ttl_s=3600.0)) if port
                  else JaxRouter(ix, pods, JaxRouterConfig(speculative_ttl_s=3600.0)))
        out = [router.route(t, MODEL) for t in stream]
        router.set_pods(pods[:2])
        out += [router.route(t, MODEL) for t in stream[:10]]
        out.append(router.scores(stream[0], MODEL))
        router.config.speculative_ttl_s = 0.0
        router._speculative = {k: 0.0 for k in router._speculative}  # all expired
        router.route(stream[1], MODEL)
        out.append(router.scores(stream[0], MODEL))
        picks.append(out)
    assert picks[0] == picks[1]
    assert len(set(picks[0][:40])) == 3
    with pytest.raises(RuntimeError, match="no candidate pods"):
        KVAwareRouter(Indexer(), []).route([1, 2, 3, 4], MODEL)


# --------------------------------------------------------------------------
# multimodal block features, byte sizes, the cost-aware budget
# --------------------------------------------------------------------------

def test_block_extra_features_and_their_keys_match_jax():
    mm = {"image": ["img-1", "img-2"], "audio": ["aud-1"]}
    ranges = {"image": [(2, 5), (14, 3)], "audio": [(9, 6)], "video": [(0, 4)]}
    got = compute_block_extra_features(
        mm, {k: [PlaceholderRange(*r) for r in v] for k, v in ranges.items()}, BLOCK, 23)
    want = jax_block_features(
        mm, {k: [JaxRange(*r) for r in v] for k, v in ranges.items()}, BLOCK, 23)
    assert [None if f is None else f.mm_hashes for f in got] == \
        [None if f is None else f.mm_hashes for f in want]
    assert compute_block_extra_features({}, {}, BLOCK, 8) is None
    tokens = list(range(20))
    nat, _, ref = make_indexers()
    assert nat.compute_block_keys(tokens, MODEL, got) == ref.compute_block_keys(
        tokens, MODEL, want)
    assert isinstance(got[1], BlockExtraFeatures) and isinstance(want[1], JaxFeatures)


@pytest.mark.parametrize("text", ["2GiB", "500 MB", "1.5kb", "7", 3.9, 12, " 64 MiB ",
                                  "1pib", "0.5TB"])
def test_parse_bytes_matches_jax(text):
    assert parse_bytes(text) == jax_parse_bytes(text)


def test_parse_bytes_refusals_match_jax():
    for bad in ("", "12 parsecs", "GiB", "1..2MB"):
        with pytest.raises(ValueError):
            parse_bytes(bad)
        with pytest.raises(ValueError):
            jax_parse_bytes(bad)


def test_cost_aware_budget_eviction_matches_jax():
    out = []
    for port in (True, False):
        mod = cost_aware if port else jax_cost_aware
        E, K = (PodEntry, KeyType) if port else (JaxPodEntry, JaxKeyType)
        ix = mod.CostAwareMemoryIndex(mod.CostAwareMemoryIndexConfig(max_cost=2000))
        costs = []
        for i in range(40):
            ix.add([i], [100 + i], [E(f"pod-{i % 3}", "tpu-hbm")])
            costs.append((ix.total_cost, len(ix)))
        ix.evict(39, K.ENGINE, [E("pod-0", "tpu-hbm")])
        ix.clear("pod-1")
        costs.append((ix.total_cost, len(ix)))
        out.append((costs, rows(ix.lookup(list(range(100, 140))))))
        with pytest.raises(ValueError):
            mod.CostAwareMemoryIndex(mod.CostAwareMemoryIndexConfig(max_cost=0))
    assert out[0] == out[1]
