"""The port's services plane against the JAX package's.

Held exactly: the indexer service's wire classes (bytes of seeded values,
each package decoding the other's, the committed wire fixtures of
``test_wire_fixtures.py``), each package's clients against the other's
gRPC server on the msgpack wire (``GetPodScores``, the shard surface) and
the ``indexer.v1`` protobuf wire over one seeded event stream, the admin
server's routes on the same providers, the OpenMetrics exposition against
``prometheus_client``'s, a tiny CPU engine's ``attach_admin``, the CoDel
shedder's decisions through ``get_pod_scores``, the config keys the
services take, and the retry policy on the ``services.indexer.rpc``
failpoint.
"""

import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import grpc
import msgpack
import numpy as np
import pytest

import wire_spec
from llmd_kv_cache_tpu.core import PodEntry as JaxPodEntry
from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokensConfig
from llmd_kv_cache_tpu.events import model as jax_events
from llmd_kv_cache_tpu.events.pool import PoolConfig as JaxPoolConfig
import importlib
from llmd_kv_cache_tpu.resilience.policy import RetryPolicy as JaxRetryPolicy
from llmd_kv_cache_tpu.resilience.shedding import CoDelShedder as JaxShedder
from llmd_kv_cache_tpu.scoring import IndexerConfig as JaxIndexerConfig
from llmd_kv_cache_tpu.services import admin as jax_admin
from llmd_kv_cache_tpu.services import indexer_service as jax_svc
from llmd_kv_cache_tpu.services.indexerpb import indexer_pb2 as jax_pb
from llmd_kv_cache_tpu_torch.core.keys import PodEntry
from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
from llmd_kv_cache_tpu_torch.events import model as port_events
from llmd_kv_cache_tpu_torch.events.pool import PoolConfig
from llmd_kv_cache_tpu_torch.metrics import registry as mr
from llmd_kv_cache_tpu_torch.resilience.policy import RetryPolicy
from llmd_kv_cache_tpu_torch.resilience.shedding import CoDelShedder
from llmd_kv_cache_tpu_torch.scoring.indexer import IndexerConfig
from llmd_kv_cache_tpu_torch.services import admin as port_admin
from llmd_kv_cache_tpu_torch.services import indexer_service as port_svc
from llmd_kv_cache_tpu_torch.services.indexerpb import indexer_pb2 as port_pb
from torch_telemetry_helpers import private_flight_recorders, private_jax_metrics

WIRE_DIR = pathlib.Path(__file__).parent / "assets" / "wire"
BLOCK = 4
MODEL = "m"
PODS = ("pod-a", "pod-b", "pod-c")
PKGS = ("jax", "port")
SVC = {"jax": jax_svc, "port": port_svc}
FAILPOINTS = {pkg: importlib.import_module(f"{name}.resilience.failpoints") for pkg, name in
              (("jax", "llmd_kv_cache_tpu"), ("port", "llmd_kv_cache_tpu_torch"))}


@pytest.fixture(autouse=True, scope="module")
def _private_globals():
    """JAX's metric families and both flight recorders of this module's
    own: its services record shed decisions and score latencies, which the
    JAX fleet tests later in the worker would otherwise read."""
    with pytest.MonkeyPatch.context() as mp, private_flight_recorders():
        private_jax_metrics(mp)
        yield


def load(name: str) -> bytes:
    return (WIRE_DIR / name).read_bytes()


# --------------------------------------------------------------------------
# wire bytes
# --------------------------------------------------------------------------

def seeded_wire(seed: int) -> dict:
    """One request, response and feedback of each package from the same
    seeded values (negative, wide and zero ints, floats, empty and filled
    maps)."""
    rng = np.random.default_rng(seed)
    pods = [f"pod-{i}" for i in range(int(rng.integers(0, 5)))]
    scores = {p: float(rng.random() * 300) for p in pods}
    residency = {p: float(rng.integers(0, 64)) for p in pods[:2]}
    tokens = [int(t) for t in rng.integers(-2**31, 2**31, int(rng.integers(0, 40)))]
    tokens += [0, 127, 128, 255, 65535, 2**32 - 1, 2**63 - 1][: seed + 1]
    deadline_ms, epoch = int(rng.integers(0, 10**6)), int(rng.integers(0, 2**40))
    resp_epoch, predicted, staleness = int(rng.integers(0, 99)), rng.random() * 9, rng.random()
    out = {}
    for pkg, mod in SVC.items():
        out[pkg] = (
            mod.ScoreRequest(tokens=tokens, model_name=f"model-{seed}", pod_identifiers=pods,
                             shard="s1" if seed % 2 else "", role=("", "decode", "prefill")[seed % 3],
                             deadline_ms=deadline_ms, priority=seed % 3, epoch=epoch),
            mod.ScoreResponse(scores=scores, error="" if seed % 2 else "boom",
                              degraded=bool(seed % 2), traceparent=wire_spec.TRACEPARENT,
                              shard="shard-0", degraded_shards=pods[:1], residency=residency,
                              degraded_reason=("", "brownout", "deadline")[seed % 3],
                              epoch=resp_epoch),
            mod.ScoreFeedback(traceparent=wire_spec.TRACEPARENT, chosen_pod=pods[0] if pods else "",
                              predicted_blocks=float(predicted), total_blocks=seed * 7,
                              scores=scores, residency=residency, staleness_s=float(staleness)),
        )
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", range(3), ids=["request", "response", "feedback"])
def test_wire_bytes_equal_and_cross_decode(seed, kind):
    objs = seeded_wire(seed)
    jax_obj, port_obj = objs["jax"][kind], objs["port"][kind]
    jax_bytes, port_bytes = jax_obj.to_bytes(), port_obj.to_bytes()
    assert port_bytes == jax_bytes
    assert vars(type(port_obj).from_bytes(jax_bytes)) == vars(jax_obj)
    assert vars(type(jax_obj).from_bytes(port_bytes)) == vars(port_obj)


def test_port_decodes_int_map_keys_as_jax_unpacks_them():
    """A dict frame with int keys (JAX's ``_unpack_dict``,
    ``strict_map_key=False``) and a response whose score map was keyed by
    ints decode the same in both packages."""
    frame = msgpack.packb({"keys": [1, 2], 7: {3: [4]}, "pods": []}, use_bin_type=True)
    assert port_svc._unpack_dict(frame) == jax_svc._unpack_dict(frame)
    assert port_svc._pack_dict(port_svc._unpack_dict(frame)) == frame
    odd = msgpack.packb({"scores": {1: 2.0}, "error": ""}, use_bin_type=True)
    assert port_svc.ScoreResponse.from_bytes(odd).scores == {1: 2.0}


SCORE_FIXTURES = sorted(p.name for p in WIRE_DIR.glob("score_*.bin"))


@pytest.mark.parametrize("name", SCORE_FIXTURES)
def test_committed_score_fixtures_decode_as_jax(name):
    """The committed bytes of ``test_wire_fixtures.py`` (legacy peers, shard,
    role, deadline, brownout, epoch, fenced, feedback): the port's class
    decodes them to JAX's fields and re-encodes them to JAX's bytes."""
    cls = {"score_request": "ScoreRequest", "score_response": "ScoreResponse",
           "score_feedback": "ScoreFeedback"}["_".join(name.split("_")[:2])]
    raw = load(name)
    ours, ref = getattr(port_svc, cls).from_bytes(raw), getattr(jax_svc, cls).from_bytes(raw)
    assert vars(ours) == vars(ref)
    assert ours.to_bytes() == ref.to_bytes()
    assert getattr(port_svc, cls).from_bytes(ours.to_bytes()) == ours


def test_feedback_from_response_as_jax():
    raw = load("score_response_residency.bin")
    ours = port_svc.ScoreFeedback.from_response(port_svc.ScoreResponse.from_bytes(raw),
                                                "decode-1", total_blocks=4, staleness_s=0.1)
    ref = jax_svc.ScoreFeedback.from_response(jax_svc.ScoreResponse.from_bytes(raw),
                                              "decode-1", total_blocks=4, staleness_s=0.1)
    assert vars(ours) == vars(ref) and ours.predicted_blocks == 1.5


@pytest.mark.parametrize("name", ["lookup_batch_request.bin", "lookup_request_deadline.bin",
                                  "lookup_request_epoch.bin"])
def test_lookup_frames_through_both_handlers(name):
    """Committed lookup frames (batched, flat with deadline/hedge markers,
    epoch-stamped) through each package's handlers: chunk 0 complete,
    chunk 1 missing key 103 (the server's early exit)."""
    frame = msgpack.unpackb(load(name), raw=False)
    out = {}
    for pkg, mod, entry in (("jax", jax_svc, JaxPodEntry), ("port", port_svc, PodEntry)):
        svc = mod.IndexerService()
        svc.indexer.kv_block_index.add(None, [100, 101, 102], [entry("pod-1", "tpu-hbm")])
        out[pkg] = {"batch": svc.lookup_blocks_batch_rpc(dict(frame)),
                    "flat": svc.lookup_blocks_rpc(dict(frame))}
    for key, rpc in (("batch", "LookupBlocksBatch"), ("flat", "LookupBlocks")):
        assert normalize(rpc, out["port"][key]) == normalize(rpc, out["jax"][key]), key
    if name == "lookup_batch_request.bin":
        assert out["port"]["batch"]["cont"] == [1, 0]


# --------------------------------------------------------------------------
# both packages' servers and clients over one seeded stream
# --------------------------------------------------------------------------

def seeded_events(seed: int = 7):
    """Per pod: a BlockStored chain of the shared 12-block prefix and its
    own suffix (pod-b), half the prefix (pod-c), or all of it (pod-a)."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, 32000, 12 * BLOCK)]
    plan = {"pod-a": (12, 4), "pod-b": (12, 2), "pod-c": (6, 0)}
    streams = {}
    for pod, (shared, own) in plan.items():
        tokens = prefix[: shared * BLOCK] + [int(t) for t in rng.integers(1, 32000, own * BLOCK)]
        hashes = [int(h) for h in rng.integers(1, 2**62, len(tokens) // BLOCK)]
        streams[pod] = (tokens, hashes)
    return prefix, streams


def fill(svc, events_mod, streams):
    for pod, (tokens, hashes) in streams.items():
        svc.pool.process_event_batch(events_mod.EventBatch(timestamp=1.0, events=[
            events_mod.BlockStoredEvent(block_hashes=hashes, tokens=tokens, parent_hash=0,
                                        block_size=BLOCK)]), pod, MODEL)


PROMPTS = {"the prefix": "prefix", "half of it": "half", "unknown": "other"}


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    prefix, streams = seeded_events()
    words = {"prefix": prefix + [5] * BLOCK, "half": prefix[: 6 * BLOCK], "other": [9] * 16}

    def tokenize(prompt, model_name):
        assert model_name == MODEL
        return words[PROMPTS[prompt]]

    out = {"words": words}
    for pkg, mod, cfg, pcfg, ev, tpc in (
            ("jax", jax_svc, JaxIndexerConfig, JaxPoolConfig, jax_events, JaxTokensConfig),
            ("port", port_svc, IndexerConfig, PoolConfig, port_events, TokenProcessorConfig)):
        svc = mod.IndexerService(cfg(token_processor_config=tpc(block_size_tokens=BLOCK)),
                                 pcfg(concurrency=1), tokenize=tokenize)
        svc.start()
        fill(svc, ev, streams)
        sock = str(tmp_path_factory.mktemp(f"indexer-{pkg}") / "indexer.sock")
        out[pkg] = {"svc": svc, "server": mod.serve(sock, svc), "sock": sock}
    yield out
    for pkg in PKGS:
        out[pkg]["server"].stop(grace=None)
        out[pkg]["svc"].stop()


def raw_call(sock, method, frame, pkg):
    """One dict RPC of the shard surface over a plain channel, the frame
    packed and the answer unpacked with ``pkg``'s codec."""
    pack = (lambda d: msgpack.packb(d, use_bin_type=True)) if pkg == "jax" else port_svc._pack_dict
    unpack = jax_svc._unpack_dict if pkg == "jax" else port_svc._unpack_dict
    with grpc.insecure_channel(f"unix:{sock}") as channel:
        return channel.unary_unary(f"/{port_svc.SERVICE_NAME}/{method}",
                                   request_serializer=pack,
                                   response_deserializer=unpack)(frame, timeout=10)


def normalize(method, resp):
    """Responses whose order follows an index's iteration, as sets."""
    resp = dict(resp)
    if method == "LookupBlocks":
        resp["hits"] = {k: sorted(map(tuple, rows)) for k, rows in resp["hits"]}
    elif method == "LookupBlocksBatch":
        resp["chunks"] = [{k: sorted(map(tuple, rows)) for k, rows in c} for c in resp["chunks"]]
    elif method == "GetPodBlocks":
        resp["blocks"] = {k: sorted(map(tuple, rows)) for k, rows in resp["blocks"]}
    return resp


def dict_frames(stacks):
    keys = stacks["port"]["svc"].indexer.compute_block_keys(stacks["words"]["prefix"], MODEL)
    return {
        "LookupBlocks": {"keys": keys, "pods": []},
        "LookupBlocksBatch": {"chunks": [keys[:4], keys[4:8], keys[8:]], "pods": ["pod-a", "pod-b"]},
        "ListPods": {},
        "GetPodDigest": {"pod": "pod-b"},
        "GetPodBlocks": {"pod": "pod-c"},
    }


@pytest.mark.parametrize("server", PKGS)
@pytest.mark.parametrize("client", PKGS)
@pytest.mark.parametrize("method", ["LookupBlocks", "LookupBlocksBatch", "ListPods",
                                    "GetPodDigest", "GetPodBlocks"])
def test_shard_surface_across_packages(stacks, client, server, method):
    frame = dict_frames(stacks)[method]
    got = normalize(method, raw_call(stacks[server]["sock"], method, frame, client))
    ref = normalize(method, raw_call(stacks["jax"]["sock"], method, frame, "jax"))
    assert got == ref
    if method == "LookupBlocksBatch":
        assert got["cont"] == [1, 1, 0]  # the 13th block is no pod's
    if method == "ListPods":
        assert got["pods"] == list(PODS)
    if client == "jax":  # JAX's parsing client (cluster.remote.ShardClient) too
        from llmd_kv_cache_tpu.cluster.remote import ShardClient

        shard = ShardClient(f"unix:{stacks[server]['sock']}", timeout_s=10)
        try:
            call = {"LookupBlocks": lambda: shard.lookup_blocks(frame["keys"]),
                    "LookupBlocksBatch": lambda: shard.lookup_blocks_batch(frame["chunks"],
                                                                          frame["pods"]),
                    "ListPods": shard.list_pods,
                    "GetPodDigest": lambda: shard.pod_digest("pod-b"),
                    "GetPodBlocks": lambda: shard.pod_blocks("pod-c")}[method]
            parsed = call()
        finally:
            shard.close()
        if method == "GetPodDigest":
            assert parsed["digest"] == ref["digest"] and parsed["count"] == ref["count"] == 14


@pytest.mark.parametrize("server", PKGS)
@pytest.mark.parametrize("client", PKGS)
def test_get_pod_scores_across_packages(stacks, client, server):
    """GetPodScores over the msgpack wire (pod filters, an unknown prompt,
    a role) and ``indexer.v1`` protobuf (prompts tokenized server-side,
    highest score first), each package's clients on each server."""
    mod = SVC[client]
    addr = stacks[server]["sock"]
    mp, pb = mod.IndexerServiceClient(addr, timeout_s=10), mod.IndexerPbClient(addr, timeout_s=10)
    try:
        words = stacks["words"]
        got = {
            "all": mp.get_pod_scores(words["prefix"], MODEL),
            "filtered": mp.get_pod_scores(words["prefix"], MODEL, ["pod-b", "pod-c"]),
            "half": mp.get_pod_scores(words["half"], MODEL),
            "cold": mp.get_pod_scores(words["other"], MODEL),
        }
        resp = mp.score(words["prefix"], MODEL, role="decode")
        assert (resp.error, resp.degraded, resp.epoch, resp.shard) == ("", False, 0, "")
        got["decode"] = resp.scores
        for prompt in PROMPTS:
            got[f"pb {prompt}"] = pb.get_pod_scores(prompt, MODEL)
    finally:
        mp.close()
        pb.close()
    ref_svc = stacks["jax"]["svc"]
    for name, scores in got.items():
        words_key = {"all": "prefix", "filtered": "prefix", "decode": "prefix", "half": "half",
                     "cold": "other"}.get(name) or PROMPTS[name[3:]]
        pods = {"pod-b", "pod-c"} if name == "filtered" else None
        ref = ref_svc.indexer.score_tokens(stacks["words"][words_key], MODEL, pods)
        assert set(scores) == set(ref), name
        assert all(abs(scores[p] - ref[p]) <= 1e-12 for p in ref), name
    assert got["all"] == {"pod-a": 12.0, "pod-b": 12.0, "pod-c": 6.0}
    assert got["cold"] == {}


@pytest.mark.parametrize("server", PKGS)
def test_pb_wire_ordering_and_raw_bytes(stacks, server):
    """A foreign client's hand-assembled protobuf bytes, and the response's
    highest-first order read through the other package's stubs."""
    prompt = "half of it".encode()
    raw_req = b"\x0a" + bytes([len(prompt)]) + prompt + b"\x12\x01m"
    assert raw_req == port_pb.GetPodScoresRequest(prompt="half of it",
                                                  model_name=MODEL).SerializeToString()
    with grpc.insecure_channel(f"unix:{stacks[server]['sock']}") as channel:
        raw = channel.unary_unary("/indexer.v1.IndexerService/GetPodScores",
                                  request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)(raw_req, timeout=10)
    other = jax_pb if server == "port" else port_pb
    resp = other.GetPodScoresResponse.FromString(raw)
    assert [(s.pod, s.score) for s in resp.scores] == [("pod-a", 6.0), ("pod-b", 6.0),
                                                       ("pod-c", 6.0)]


def test_pb_stub_descriptor_equals_jax():
    assert port_pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    sd = port_pb.DESCRIPTOR.services_by_name["IndexerService"]
    assert sd.full_name == "indexer.v1.IndexerService"
    assert [f.number for f in port_pb.GetPodScoresRequest.DESCRIPTOR.fields] == [1, 2, 3]


@pytest.mark.parametrize("pkg", PKGS)
def test_pb_without_tokenizer_fails_precondition(tmp_path, pkg):
    mod = SVC[pkg]
    svc = mod.IndexerService()
    svc.start()
    sock = str(tmp_path / "indexer.sock")
    server = mod.serve(sock, svc)
    client = SVC["port" if pkg == "jax" else "jax"].IndexerPbClient(sock, timeout_s=10)
    try:
        with pytest.raises(grpc.RpcError) as ei:
            client.get_pod_scores("x", MODEL)
        assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    finally:
        client.close()
        server.stop(grace=None)
        svc.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_client_retries_on_the_failpoint(stacks, pkg):
    """``services.indexer.rpc`` in error mode: one injected fault is retried
    under a short policy; faults on every attempt surface as
    ``FaultInjected`` after ``max_attempts``."""
    mod = SVC[pkg]
    fps = FAILPOINTS[pkg].failpoints
    policy = (JaxRetryPolicy if pkg == "jax" else RetryPolicy)(
        max_attempts=3, base_delay_s=0.001, max_delay_s=0.002)
    client = mod.IndexerServiceClient(stacks["port" if pkg == "jax" else "jax"]["sock"],
                                      timeout_s=10, retry_policy=policy)
    try:
        fps.arm(mod.FP_INDEXER_RPC, times=1)
        assert client.get_pod_scores(stacks["words"]["half"], MODEL) == {
            p: 6.0 for p in PODS}
        fps.arm(mod.FP_INDEXER_RPC)
        with pytest.raises(FAILPOINTS[pkg].FaultInjected):
            client.get_pod_scores(stacks["words"]["half"], MODEL)
    finally:
        fps.disarm(mod.FP_INDEXER_RPC)
        client.close()


def test_channel_pool_refcounts():
    from llmd_kv_cache_tpu_torch.services import channel_pool

    before = channel_pool.stats()
    a, b = channel_pool.acquire("/tmp/x.sock"), channel_pool.acquire("unix:/tmp/x.sock")
    assert a is b and channel_pool.stats()["unix:/tmp/x.sock"] == 2
    channel_pool.release("/tmp/x.sock")
    channel_pool.release("unix:/tmp/x.sock")
    channel_pool.release("unix:/tmp/x.sock")  # idempotent
    assert channel_pool.stats() == before


@pytest.mark.parametrize("method", ["drain", "install_drain_handler", "attach_digest_source",
                                    "attach_peer_digest_source"])
def test_fleet_plane_methods_raise(method, monkeypatch):
    """The recovery plane's methods on a service with neither
    ``recoveryConfig`` nor ``clusterConfig`` act as JAX's: peer
    anti-entropy raises for want of a shard id, the others work (a drain
    with no manager, a SIGTERM handler, a digest source and its round)."""
    import signal

    from llmd_kv_cache_tpu.recovery import IndexDigestSource as JaxDigestSource
    from llmd_kv_cache_tpu_torch.recovery import IndexDigestSource

    from torch_telemetry_helpers import private_port_metrics

    private_jax_metrics(monkeypatch)  # a drain and a reconcile round record
    private_port_metrics(monkeypatch)
    got = {}
    saved = signal.getsignal(signal.SIGTERM)
    try:
        for pkg, mod, source in (("jax", jax_svc, JaxDigestSource), ("port", port_svc,
                                                                    IndexDigestSource)):
            svc = mod.IndexerService()
            if method == "attach_peer_digest_source":
                with pytest.raises(RuntimeError) as err:
                    svc.attach_peer_digest_source()
                got[pkg] = str(err.value)
            elif method == "attach_digest_source":
                svc.attach_digest_source(source(svc.indexer.kv_block_index))
                got[pkg] = (svc.reconcile_now(), svc.audit_now())
            elif method == "drain":
                report = svc.drain()
                got[pkg] = (report["completed"], report["steps"])
            else:
                coordinator = svc.install_drain_handler()
                got[pkg] = (type(coordinator).__name__, coordinator.deadline_s,
                            signal.getsignal(signal.SIGTERM) is not saved)
            if pkg == "port":
                assert (svc.recovery, svc.membership, svc.shard_index) == (None, None, None)
    finally:
        signal.signal(signal.SIGTERM, saved)
    assert got["port"] == got["jax"]


# --------------------------------------------------------------------------
# the shedder
# --------------------------------------------------------------------------

def test_shedder_decisions_equal_jax(monkeypatch):
    """Both services' CoDel shedders, each on a fake clock of its own, fed
    the same delays: the scripted ``observe_delay`` sequence, and as each
    scoring call's own serving time (``score_tokens`` advances the clock).
    Every ``get_pod_scores`` at each priority answers alike (admit,
    brownout with the residency fold skipped, shed), and the shedders'
    stats agree."""
    import types

    prefix, streams = seeded_events()
    services, clocks = {}, {}
    for pkg, mod, cfg, pcfg, ev, tpc, shedder in (
            ("jax", jax_svc, JaxIndexerConfig, JaxPoolConfig, jax_events, JaxTokensConfig,
             JaxShedder),
            ("port", port_svc, IndexerConfig, PoolConfig, port_events, TokenProcessorConfig,
             CoDelShedder)):
        now = clocks[pkg] = [0.0, 0.0]  # the time, the delay a score call takes
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda n=now: n[0]))
        svc = mod.IndexerService(cfg(token_processor_config=tpc(block_size_tokens=BLOCK),
                                     shed_target_delay_s=0.05, shed_interval_s=0.1),
                                 pcfg(concurrency=1))
        svc.shedder = shedder("indexer.score", 0.05, 0.1, clock=lambda n=now: n[0])

        def slow_score(*args, _inner=svc.indexer.score_tokens, _now=now, **kwargs):
            _now[0] += _now[1]
            return _inner(*args, **kwargs)

        svc.indexer.score_tokens = slow_score
        fill(svc, ev, streams)
        services[pkg] = svc
    delays = [0.01, 0.2, 0.2, 0.3, 0.2, 0.4, 0.2, 0.2, 0.2, 0.2, 0.01, 0.3, 0.3, 0.02]
    trace = {pkg: [] for pkg in PKGS}
    for step, delay in enumerate(delays):
        for pkg, svc in services.items():
            clocks[pkg][0] += 0.03
            clocks[pkg][1] = delay
            svc.shedder.observe_delay(delay)
            for priority in (2, 1, 0):
                req = SVC[pkg].ScoreRequest(tokens=prefix + [5] * BLOCK, model_name=MODEL,
                                            priority=priority, role="decode")
                trace[pkg].append((step, priority, svc.get_pod_scores(req).to_bytes()))
            trace[pkg].append(svc.shedder.stats())
    assert trace["port"] == trace["jax"]
    stats = trace["port"][-1]
    assert stats["sheds"] > 0 and stats["brownouts"] > 0 and stats["admitted"] > 0


@pytest.mark.parametrize("key,value,field", [
    ("metricsPort", 9101, "metrics_port"), ("metrics_port", 9102, "metrics_port"),
    ("adminPort", 9201, "admin_port"), ("admin_port", 0, "admin_port"),
    ("adminHost", "0.0.0.0", "admin_host"), ("admin_host", "", "admin_host"),
    ("shedTargetDelayS", 0.25, "shed_target_delay_s"),
    ("shed_target_delay_s", None, "shed_target_delay_s"),
    ("shedIntervalS", 0.5, "shed_interval_s"), ("shed_interval_s", 0, "shed_interval_s")])
def test_indexer_config_takes_the_service_keys(key, value, field):
    ours, ref = IndexerConfig.from_dict({key: value}), JaxIndexerConfig.from_dict({key: value})
    assert getattr(ours, field) == getattr(ref, field)
    assert (ours.metrics_port, ours.admin_port, ours.admin_host, ours.shed_target_delay_s,
            ours.shed_interval_s) == (ref.metrics_port, ref.admin_port, ref.admin_host,
                                      ref.shed_target_delay_s, ref.shed_interval_s)


# --------------------------------------------------------------------------
# the admin server
# --------------------------------------------------------------------------

def fetch(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def action(params):
    if params.get("fail") == "value":
        raise ValueError("bad value")
    if params.get("fail") == "other":
        raise RuntimeError("broken")
    return {"params": params}


ROUTES = [("GET", p) for p in (
    "/healthz", "/debug/lag", "/debug/broken", "/debug/vars", "/debug/nope", "/nope",
    "/debug/spans", "/debug/spans?since=3", "/debug/spans?since=x", "/debug/pyprof",
    "/debug/pyprof?since=1", "/debug/workingset", "/debug/workingset?since=0", "/debug/slo",
    "/debug/slo?since=2", "/debug/audit", "/debug/audit?since=1", "/debug/pyprof/capture",
    "/debug/pyprof/capture?seconds=x", "/debug/profile", "/debug/flight-recorder?since=-1",
    "/debug/flight-recorder?since=oops")] + [("POST", p) for p in (
        "/debug/role?x=1&x=2&y=3", "/debug/role?fail=value", "/debug/role?fail=other",
        "/debug/drain", "/metrics")]


def admin_pair(configured: bool):
    """Both packages' servers, each with the same providers (and, when
    ``configured``, the same sources, action and pyprof capture)."""
    servers = {}
    for pkg, mod in (("jax", jax_admin), ("port", port_admin)):
        srv = mod.AdminServer(port=0)
        srv.register_debug("lag", lambda: {"pods": {"pod-a": {"messages": 3}}})
        srv.register_debug("broken", lambda: 1 / 0)
        if configured:
            srv.register_spans_source(lambda since: {"spans": [], "next_seq": since + 1})
            srv.register_pyprof_source(lambda since: {"windows": [since]})
            srv.register_workingset_source(lambda since: {"ws": since})
            srv.register_slo_source(lambda since: {"edges": [since]})
            srv.register_audit_source(lambda since: {"records": [since]})
            srv.register_pyprof_capture(lambda seconds: {"seconds": seconds})
            srv.register_action("role", action)
        srv.start()
        servers[pkg] = srv
    return servers


def stop_all(servers) -> None:
    """Stop admin servers side by side (a JAX server's stop waits up to its
    0.5 s poll interval)."""
    threads = [threading.Thread(target=srv.stop) for srv in servers]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


def untimed(body: bytes):
    """A JSON body with the flight recorder's records and clock fields cut
    to their kinds and keys."""
    doc = json.loads(body)
    if isinstance(doc, dict) and "flight_recorder" in doc:
        doc["flight_recorder"] = [r["kind"] for r in doc["flight_recorder"]]
    if isinstance(doc, dict) and "records" in doc and "next_seq" in doc:
        doc["records"] = [r["kind"] for r in doc["records"]]
    return doc


@pytest.mark.parametrize("configured", [False, True], ids=["unregistered", "registered"])
def test_admin_routes_equal_jax(configured):
    with private_flight_recorders():
        for pkg in ("llmd_kv_cache_tpu", "llmd_kv_cache_tpu_torch"):
            recorder = importlib.import_module(f"{pkg}.telemetry.flight_recorder")
            for i in range(3):
                recorder.record("score", {"pods": i})
            recorder.record("shed", {"site": "x"})
        check_admin_routes(configured)


def check_admin_routes(configured):
    servers = admin_pair(configured)
    try:
        for method, path in ROUTES:
            got = {pkg: fetch(srv.port, path, method) for pkg, srv in servers.items()}
            (s_j, t_j, b_j), (s_p, t_p, b_p) = got["jax"], got["port"]
            assert (s_p, t_p) == (s_j, t_j), (method, path)
            assert untimed(b_p) == untimed(b_j), (method, path)
        times = {pkg: json.loads(fetch(srv.port, "/debug/time")[2]) for pkg, srv in
                 servers.items()}
        assert set(times["port"]) == set(times["jax"]) == {"wall", "mono", "pid"}
        for pkg, srv in servers.items():  # the metrics routes: both formats
            status, ctype, body = fetch(srv.port, "/metrics")
            assert status == 200 and body
            om_status, om_type, om = fetch(srv.port, "/metrics?format=openmetrics")
            assert om_status == 200 and om.endswith(b"# EOF\n")
        assert fetch(servers["port"].port, "/metrics")[1] == fetch(servers["jax"].port,
                                                                   "/metrics")[1]
        assert fetch(servers["port"].port, "/metrics?format=openmetrics")[1] == fetch(
            servers["jax"].port, "/metrics?format=openmetrics")[1]
    finally:
        stop_all(servers.values())


def test_metrics_only_server_and_health_provider():
    """``start_observability_servers`` with two ports: a debug server and a
    metrics-only one (404 on ``/debug/*``), both serving the health
    provider's payload, 503 while it is not ok."""
    state = {"status": "warming"}
    out, started = {}, []
    try:
        for pkg, mod in (("jax", jax_admin), ("port", port_admin)):
            servers = mod.start_observability_servers(free_port(), free_port(), providers={
                "lag": lambda: {"x": 1}}, health=lambda: dict(state))
            started += servers
            admin, metrics = servers
            out[pkg] = [fetch(admin.port, "/debug/lag")[0], fetch(metrics.port, "/debug/vars")[0],
                        fetch(metrics.port, "/healthz")[:2], fetch(admin.port, "/healthz")[2]]
            assert mod.start_observability_servers(0, 0) == []
    finally:
        stop_all(started)
    assert out["port"] == out["jax"]
    assert out["port"][:3] == [200, 404, (503, "application/json")]


def test_openmetrics_equals_prometheus_client():
    """The port's OpenMetrics text against ``prometheus_client``'s on the
    same families and calls: counters with and without children and
    labels, gauges, histograms with ``_created`` after each child's sum,
    and a bucket histogram family with trace-id exemplars, ``# EOF``
    last."""
    import re

    import prometheus_client as pc
    from prometheus_client.core import Exemplar, HistogramMetricFamily
    from prometheus_client.openmetrics.exposition import generate_latest as pc_openmetrics

    def drive(mod, kw):
        mod.Counter("kvtpu_a_total", 'A counter\\ with "q"\nnl', **kw).inc()
        mod.Counter("kvtpu_b_total", "B", ["outcome"], **kw).labels('x"y\\z\nw').inc(2.5)
        mod.Counter("kvtpu_e_total", "E", ["outcome"], **kw)
        c = mod.Counter("kv_offload_bytes", "bytes", ["medium", "direction"], **kw)
        c.labels("S", "store").inc(1024)
        c.labels("S", "load").inc(3)
        mod.Gauge("kvtpu_g", "G", **kw).set(3)
        mod.Gauge("kvtpu_g2", "G2", ["group"], **kw)
        mod.Histogram("kvtpu_he", "HE", ["x"], buckets=(1.0,), **kw)
        h = mod.Histogram("kvtpu_h_seconds", "H", buckets=(1e-5, 1e-3, 1.0, 5.0, 1e7), **kw)
        for x in (0.002, 1e9, 1e-5):
            h.observe(x)
        h2 = mod.Histogram("kvtpu_h2", "H2", ["tier"], buckets=(0.1, 1), **kw)
        h2.labels("t").observe(0.5)
        h2.labels("u").observe(0.05)

    ts = 1792323418.929977
    buckets = [("0.001", 1, ("ab" * 16, 0.0005)), ("0.01", 3, None), ("+Inf", 4, ("cd" * 16, 2.5))]

    class Exemplary:
        def collect(self):
            fam = HistogramMetricFamily("kvtpu_bh_seconds", "BH")
            fam.add_metric([], buckets=[(le, n, Exemplar({"trace_id": ex[0]}, ex[1], ts))
                                        if ex else (le, n) for le, n, ex in buckets],
                           sum_value=3.1)
            yield fam

    def exemplary():
        samples = [("kvtpu_bh_seconds_bucket", {"le": le}, n) for le, n, _ in buckets]
        samples += [("kvtpu_bh_seconds_count", {}, 4), ("kvtpu_bh_seconds_sum", {}, 3.1)]
        yield mr.MetricFamily("kvtpu_bh_seconds", "histogram", "BH", samples, {
            i: ({"trace_id": ex[0]}, ex[1], ts) for i, (_, _, ex) in enumerate(buckets) if ex})

    ref, port = pc.CollectorRegistry(), mr.Registry()
    drive(pc, {"registry": ref})
    drive(mr, {"registry": port})
    ref.register(Exemplary())
    port.register(mr.CustomCollector(exemplary))
    untime = lambda text: re.sub(r"(_created(\{[^}]*\})?) \S+", r"\1 T", text)  # noqa: E731
    ours = mr.generate_openmetrics(port).decode()
    assert untime(ours) == untime(pc_openmetrics(ref).decode())
    assert ours.endswith("# EOF\n") and f'# {{trace_id="{"ab" * 16}"}} 0.0005 {ts}' in ours
    assert untime(mr.generate_latest(port).decode()) == untime(pc.generate_latest(ref).decode())


def test_bucket_histogram_exemplars_and_ledger_families_as_jax(monkeypatch):
    """The collectors themselves: a bucket histogram observed with trace
    ids, and the cache-ledger bridge (registered twice: last writer wins),
    rendered by each package's OpenMetrics writer, equal."""
    import prometheus_client as pc
    from prometheus_client.openmetrics.exposition import generate_latest as pc_openmetrics

    from llmd_kv_cache_tpu.metrics import collector as jax_col
    from llmd_kv_cache_tpu_torch.metrics import collector as port_col

    jax_reg, port_reg = pc.CollectorRegistry(), mr.Registry()
    monkeypatch.setattr(jax_col, "_BUCKET_HISTOGRAMS", {})
    monkeypatch.setattr(jax_col, "_bucket_collector_registered", False)
    monkeypatch.setattr(port_col, "_BUCKET_HISTOGRAMS", {})
    port_reg.register(mr.CustomCollector(port_col._collect_bucket_histograms))
    monkeypatch.setattr(jax_col, "REGISTRY", jax_reg)
    monkeypatch.setattr(jax_col, "_ledger_collector", None)
    monkeypatch.setattr(port_col, "REGISTRY", port_reg)
    monkeypatch.setattr(port_col, "_ledger_collector", None)
    snap = {"pods": {"pod-a": {"appearances": 3, "wins": 2, "score_total": 7.5,
                               "stored_blocks": 9, "evicted_blocks": 4}}}
    for col in (jax_col, port_col):
        h = col.bucket_histogram("kvtpu_x_seconds", "X", (0.001, 0.01, 0.1))
        for value, trace in ((0.0005, "a" * 32), (0.05, None), (0.07, "b" * 32), (3.0, "c" * 32)):
            h.observe(value, trace_id=trace)
        col.register_cache_ledger(lambda: {"pods": {}})
        col.register_cache_ledger(lambda: snap)  # last writer wins, no raise
    import re

    untime = lambda text: re.sub(r"(\} \S+) \S+\n", r"\1 T\n", text)  # noqa: E731
    assert untime(mr.generate_openmetrics(port_reg).decode()) == untime(
        pc_openmetrics(jax_reg).decode())
    assert mr.generate_latest(port_reg).decode() == pc.generate_latest(jax_reg).decode()
    assert b"kvtpu_cache_ledger_stored_blocks" in mr.generate_latest(port_reg)


# --------------------------------------------------------------------------
# an engine's admin endpoint
# --------------------------------------------------------------------------

def tiny_engine(profile_dir: str):
    import torch

    from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig, init_params
    from llmd_kv_cache_tpu_torch.telemetry import EngineTelemetryConfig

    model = LlamaConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                        num_kv_heads=2, head_dim=8, intermediate_size=64, page_size=4,
                        dtype=torch.float32)
    return MiniEngine(EngineConfig(model=model, num_pages=32, max_pages_per_seq=8,
                                   max_prefill_tokens=16, pod_identifier="pod-e",
                                   telemetry=EngineTelemetryConfig(profile_dir=profile_dir)),
                      params=init_params(model, seed=0, device="cpu"), device="cpu")


def test_engine_attach_admin_serves_engine_and_profile(tmp_path):
    eng = tiny_engine(str(tmp_path / "prof"))
    eng.generate("r0", list(range(1, 10)), max_new_tokens=3)
    srv = port_admin.AdminServer(port=0)
    eng.telemetry.attach_admin(srv)
    srv.start()
    try:
        status, _, body = fetch(srv.port, "/debug/engine")
        engine_view = json.loads(body)
        assert status == 200 and engine_view["phases"]["ttft_seconds"]["count"] >= 1
        assert set(engine_view) == set(eng.telemetry.debug_vars())
        assert fetch(srv.port, "/debug/profile?duration_s=0")[0] == 400
        assert fetch(srv.port, "/debug/profile?duration_s=abc")[0] == 400
        first = {}
        th = threading.Thread(target=lambda: first.update(
            zip(("status", "type", "body"), fetch(srv.port, "/debug/profile?duration_s=0.5"))))
        th.start()
        deadline = time.monotonic() + 10
        while not eng.telemetry.profiler._lock.locked() and time.monotonic() < deadline:
            time.sleep(0.001)
        second = fetch(srv.port, "/debug/profile?duration_s=0.2")
        while th.is_alive():
            eng.generate(f"r{time.monotonic()}", list(range(1, 9)), max_new_tokens=2)
            th.join(0.01)
        assert second[0] == 409 and b"already running" in second[2]
        summary = json.loads(first["body"])
        assert first["status"] == 200 and pathlib.Path(summary["trace"]).exists()
        assert json.loads(fetch(srv.port, "/debug/vars")[2])["engine"]["last_profile"][
            "trace"] == summary["trace"]
    finally:
        srv.stop()
    bare = port_admin.AdminServer(port=0)
    tiny_engine("").telemetry.attach_admin(bare)
    bare.start()
    try:
        assert fetch(bare.port, "/debug/profile?duration_s=1")[0] == 404
        assert fetch(bare.port, "/debug/engine")[0] == 200
    finally:
        bare.stop()


def test_service_admin_endpoint_serves_the_planes(stacks):
    """A port service started with ``adminPort`` and a distinct
    ``metricsPort`` (the config keys the port took since the services'
    port): lag, ledger, data plane, the ledger families and the score
    records, and the metrics-only server's 404 on ``/debug/vars``."""
    from llmd_kv_cache_tpu_torch.events.publisher import encode_batch

    cfg = IndexerConfig.from_dict({"tokenProcessorConfig": {"blockSize": BLOCK},
                                   "adminPort": free_port(), "metricsPort": free_port(),
                                   "shedTargetDelayS": 0.5})
    svc = port_svc.IndexerService(cfg, PoolConfig(concurrency=1))
    svc.start()
    try:
        for seq, (pod, (tokens, hashes)) in enumerate(seeded_events()[1].items()):
            svc.pool.add_task(port_events.RawMessage(f"kv@{pod}@{MODEL}", seq, encode_batch(
                [port_events.BlockStoredEvent(block_hashes=hashes, tokens=tokens, parent_hash=0,
                                              block_size=BLOCK)], time.time())))
        svc.pool.join()
        resp = svc.get_pod_scores(port_svc.ScoreRequest(stacks["words"]["prefix"], MODEL))
        assert resp.scores == {"pod-a": 12.0, "pod-b": 12.0, "pod-c": 6.0}
        admin, metrics = svc._observability_servers
        assert (admin.port, metrics.port) == (cfg.admin_port, cfg.metrics_port)
        view = json.loads(fetch(admin.port, "/debug/vars")[2])
        assert set(view["lag"]["pods"]) == set(PODS)
        assert view["ledger"]["score_calls"] >= 1 and view["shed"]["admitted"] >= 1
        assert json.loads(fetch(admin.port, "/debug/data_plane")[2]) == json.loads(
            json.dumps(svc._data_plane_debug()))
        assert any(r["kind"] == "score" for r in view["flight_recorder"])
        text = fetch(metrics.port, "/metrics")[2].decode()
        assert 'kvtpu_cache_ledger_stored_blocks{pod="pod-a"} 16.0' in text
        assert fetch(metrics.port, "/debug/vars")[0] == 404
    finally:
        svc.stop()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
