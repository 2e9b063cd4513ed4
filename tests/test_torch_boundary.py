"""The port's import boundary.

``llmd_kv_cache_tpu_torch`` and ``chip_smoke.py`` run where there is no
JAX, ``ml_dtypes``, ``msgpack``, ``zmq``, ``prometheus_client``, ``boto3``,
``transformers``, ``safetensors``, ``orbax``, ``redis``, ``grpc`` or
``google.protobuf``: importing every
port module in a fresh interpreter must leave JAX, those packages and the
JAX package (``llmd_kv_cache_tpu``, whose name the port's own name starts
with) out of ``sys.modules``. (The port reads checkpoints with code of its
own.) Nor may importing them build a library: the native index compiles
``csrc/kvindex`` at first use, never at import.

``offload.vllm_spec`` is the one module whose import needs ``vllm`` (the
shim adapts vLLM's own base classes, and without them it raises
``ImportError`` by contract), and neither machine has vLLM: the probe
registers ``chip_smoke``'s vLLM double in ``sys.modules`` before it walks
the package, as the shim's tests do, so the walk imports that module too.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, os, pkgutil, sys, tempfile
from pathlib import Path
import chip_smoke
# The vLLM double offload.vllm_spec imports (see the module docstring).
sys.modules.update(chip_smoke.vllm_double_modules())
import llmd_kv_cache_tpu_torch as port
from llmd_kv_cache_tpu_torch.index import native
native.BUILD_ROOT = Path(tempfile.mkdtemp())  # where a build at import would land
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "ml_dtypes", "msgpack", "zmq", "prometheus_client",
          "boto3", "transformers", "safetensors", "orbax", "redis", "grpc",
          "google.protobuf", "llmd_kv_cache_tpu")
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in banned))
built = os.listdir(native.BUILD_ROOT) + ([] if native._lib is None else ["loaded"])
os.rmdir(native.BUILD_ROOT)
print(len(names), built, leaked)
"""


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, built, leaked = out.stdout.split(" ", 2)
    assert int(n_modules) >= 20  # every subpackage and module was imported
    assert built == "[]"  # no library built or loaded by an import
    assert leaked.strip() == "[]"


WIRE_PROBE = r"""
import os, sys, tempfile, time
for name in ("zmq", "msgpack"):
    sys.modules[name] = None  # importing either now raises ImportError
from llmd_kv_cache_tpu_torch.core.token_processor import ChunkedTokenDatabase, TokenProcessorConfig
from llmd_kv_cache_tpu_torch.events import BlockStoredEvent, Pool, PoolConfig, RawMessage
from llmd_kv_cache_tpu_torch.events.packed import encode_packed_batch
from llmd_kv_cache_tpu_torch.events.publisher import encode_batch
from llmd_kv_cache_tpu_torch.events.shm_ring import ShmRing
from llmd_kv_cache_tpu_torch.index.in_memory import InMemoryIndex

ring_path = tempfile.mkdtemp() + "/ring"
ring = ShmRing(ring_path, create=True)
index = InMemoryIndex()
tp = ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=4))
pool = Pool(PoolConfig(concurrency=2, shm_ring_path=ring_path), index, tp)
pool.start()
stored = BlockStoredEvent(block_hashes=[1, 2], tokens=list(range(8)), block_size=4)
pool.add_task(RawMessage("kv@pod-m@m", 0, encode_batch([stored], time.time())))
pool.add_task(RawMessage("kv@pod-k@m", 0, encode_packed_batch(
    "pod-k", "m", [3, 4], list(range(8)), timestamp=time.time(), block_size=4)))
ring.write(encode_packed_batch("pod-r", "m", [5, 6], list(range(8)),
                               timestamp=time.time(), block_size=4))
deadline = time.monotonic() + 30
while pool.shm_messages < 1 and time.monotonic() < deadline:
    time.sleep(0.005)
pool.join()
pool.shutdown()
keys = tp.tokens_to_kv_block_keys(0, list(range(8)), "m")
pods = sorted({e.pod_identifier for es in index.lookup(keys).values() for e in es})
ring.close()
ring.unlink()
os.rmdir(os.path.dirname(ring_path))
print(pods, pool.ingest_messages, pool.zerocopy_batches, pool.shm_messages,
      sorted(m for m in sys.modules if m in ("zmq", "msgpack") and sys.modules[m] is not None))
"""


def test_the_event_plane_runs_with_zmq_and_msgpack_blocked():
    """The card's path (both wires into a started ``Pool`` and a ring) needs
    neither ``zmq`` nor ``msgpack``: both are blocked in the probe."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", WIRE_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['pod-k', 'pod-m', 'pod-r'] 3 2 1 []"


SERVICES_PROBE = r"""
import json, sys, time, urllib.request
for name in ("grpc", "google.protobuf", "msgpack", "zmq"):
    sys.modules[name] = None  # importing any of them now raises ImportError
from llmd_kv_cache_tpu_torch.events import BlockStoredEvent, PoolConfig, RawMessage
from llmd_kv_cache_tpu_torch.events.publisher import encode_batch
from llmd_kv_cache_tpu_torch.scoring.indexer import IndexerConfig
from llmd_kv_cache_tpu_torch.services.admin import AdminServer
from llmd_kv_cache_tpu_torch.services.indexer_service import (
    IndexerService, ScoreRequest, ScoreResponse)
from llmd_kv_cache_tpu_torch.services.tokenizer.messages import TokenizeRequest
from llmd_kv_cache_tpu_torch.services.tokenizer.service import TokenizerService

tokens = TokenizerService().tokenize(TokenizeRequest("simple", "a b c d e f g")).token_ids
svc = IndexerService(IndexerConfig.from_dict({"tokenProcessorConfig": {"blockSize": 4},
                                              "shedTargetDelayS": 0.5}),
                     PoolConfig(concurrency=1))
svc.start()
stored = BlockStoredEvent(block_hashes=[1, 2], tokens=tokens[:8], block_size=4)
svc.pool.add_task(RawMessage("kv@pod-m@simple", 0, encode_batch([stored], time.time())))
svc.pool.join()
wire = ScoreRequest(tokens=tokens, model_name="simple").to_bytes()
resp = ScoreResponse.from_bytes(svc.get_pod_scores(ScoreRequest.from_bytes(wire)).to_bytes())
admin = AdminServer()
admin.register_debug("lag", svc.pool.lag_stats)
admin.start()
with urllib.request.urlopen(f"http://127.0.0.1:{admin.port}/debug/lag", timeout=10) as r:
    lag = json.load(r)
with urllib.request.urlopen(f"http://127.0.0.1:{admin.port}/metrics", timeout=10) as r:
    metrics = r.read()
admin.stop()
svc.stop()
print(resp.scores, resp.error == "", sorted(lag["pods"]), b"kvcache_" in metrics,
      sorted(m for m in sys.modules if m in ("grpc", "google.protobuf", "msgpack", "zmq")
             and sys.modules[m] is not None))
"""


def test_the_services_run_with_grpc_protobuf_msgpack_and_zmq_blocked():
    """The card's services path (scores over the msgpack wire in-process, an
    admin GET, ``SimpleTokenizer``) needs none of the wire libraries."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SERVICES_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "{'pod-m': 2.0} True ['pod-m'] True []"


FLEET_PROBE = r"""
import sys, tempfile, time
for name in ("grpc", "zmq", "msgpack", "boto3"):
    sys.modules[name] = None  # importing any of them now raises ImportError
import os
from llmd_kv_cache_tpu_torch.cluster import ClusterConfig, MembershipTable, ShardRouter
from llmd_kv_cache_tpu_torch.cluster.remote import LocalShardClient
from llmd_kv_cache_tpu_torch.events import BlockStoredEvent, EventBatch, PoolConfig
from llmd_kv_cache_tpu_torch.events.publisher import encode_batch
from llmd_kv_cache_tpu_torch.evictor import Evictor, EvictorConfig
from llmd_kv_cache_tpu_torch.offload.file_mapper import FileMapper, FileMapperConfig
from llmd_kv_cache_tpu_torch.offload.object_store import S3ObjectStoreClient
from chip_smoke import S3Stub
from llmd_kv_cache_tpu_torch.resilience import HedgeBudget, LatencyQuantileTracker
from llmd_kv_cache_tpu_torch.scoring.indexer import IndexerConfig
from llmd_kv_cache_tpu_torch.services.indexer_service import IndexerService

stub = S3Stub(credentials={"AK": "SK"})
s3 = S3ObjectStoreClient("b", endpoint_url=stub.url, access_key="AK", secret_key="SK")
s3.put("kv/x", b"payload")
s3_ok = s3.get("kv/x") == b"payload" and s3.list_keys("kv/") == ["kv/x"]
stub.close()

shards = ["s0", "s1", "s2"]
svcs = {}
tokens = list(range(1, 33))
for sid in shards:
    cfg = IndexerConfig.from_dict({"tokenProcessorConfig": {"blockSize": 4},
                                   "kvBlockIndexConfig": {"inMemoryConfig": {}},
                                   "clusterConfig": {"shardAddresses": shards, "shardId": sid,
                                                     "fenceMode": "reject"}})
    svcs[sid] = svc = IndexerService(cfg, PoolConfig(concurrency=1))
    svc.pool.process_event_batch(EventBatch(timestamp=0.0, events=[BlockStoredEvent(
        block_hashes=list(range(8)), tokens=tokens, parent_hash=0, block_size=4)]), "pod-a", "m")
router = ShardRouter(ClusterConfig(shard_addresses=shards, fanout_chunk_blocks=2),
                     svcs["s0"].indexer.config.token_processor_config,
                     clients={sid: LocalShardClient(svc) for sid, svc in svcs.items()})
scores = router.score(tokens, "m").scores
router.close()
svcs["s1"].membership.observe_epoch(3)
svcs["s1"].pool.process_event_batch(EventBatch(timestamp=0.0, events=[], epoch=2), "pod-b", "m")

root = tempfile.mkdtemp()
mapper = FileMapper(FileMapperConfig(root=root, model_name="m"))
for h in (1, 2, 3):
    path = mapper.block_path(h)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "wb").write(b"x")
removed = []

class Publisher:
    def publish_block_removed(self, hashes):
        removed.append(encode_batch([], time.time()) and sorted(hashes))

ev = Evictor(EvictorConfig(store_root=root, num_crawlers=1, min_idle_seconds=0),
             publisher=Publisher(), usage_fn=lambda: 0.99)
ev.activator_pass()
ev.crawl_and_delete_pass(0)
budget = HedgeBudget()
tracker = LatencyQuantileTracker()
print(s3_ok, scores, svcs["s1"].pool.fenced_batches, removed, budget.spend(),
      sorted(m for m in sys.modules if m in ("grpc", "zmq", "msgpack", "boto3")
             and sys.modules[m] is not None))
"""


def test_the_fleet_runs_with_grpc_zmq_msgpack_and_boto3_blocked():
    """The card's fleet path (the S3 HTTP client against a signing stub, a
    router over in-process replicas with their epoch fence, the evictor,
    the hedging primitives) needs none of the wire or cloud libraries."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", FLEET_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True {'pod-a': 8.0} 1 [[1, 2, 3]] True []"


RECOVERY_PROBE = r"""
import json, sys, tempfile, time, urllib.request
for name in ("grpc", "google.protobuf", "zmq", "msgpack", "prometheus_client", "jax"):
    sys.modules[name] = None  # importing any of them now raises ImportError
from llmd_kv_cache_tpu_torch import control, recovery
from llmd_kv_cache_tpu_torch.control import ControllerConfig
from llmd_kv_cache_tpu_torch.events import BlockStoredEvent, PoolConfig, RawMessage
from llmd_kv_cache_tpu_torch.events.publisher import encode_batch
from llmd_kv_cache_tpu_torch.scoring.indexer import IndexerConfig
from llmd_kv_cache_tpu_torch.services.admin import AdminServer
from llmd_kv_cache_tpu_torch.services.fleet_controller import (
    FleetControllerService, FleetControllerServiceConfig)
from llmd_kv_cache_tpu_torch.services.indexer_service import IndexerService, ScoreRequest
from llmd_kv_cache_tpu_torch.telemetry.slo import SLOConfig, SLORegistry

snaps = tempfile.mkdtemp()
cfg = IndexerConfig.from_dict({"tokenProcessorConfig": {"blockSize": 4},
                               "recoveryConfig": {"snapshotDir": snaps, "snapshotIntervalS": 0}})
svc = IndexerService(cfg, PoolConfig(concurrency=1))
svc.start()
stored = BlockStoredEvent(block_hashes=[1, 2], tokens=list(range(8)), block_size=4)
svc.pool.add_task(RawMessage("kv@pod-m@m", 1, encode_batch([stored], time.time())))
svc.pool.join()
svc.stop()  # the final snapshot
svc2 = IndexerService(cfg, PoolConfig(concurrency=1))
svc2.start()
restored = svc2.recovery.restored_entries
svc2.attach_digest_source(recovery.IndexDigestSource(svc.indexer.kv_block_index))
audit = svc2.audit_now()["divergent"]
scores = svc2.get_pod_scores(ScoreRequest(tokens=list(range(8)), model_name="m")).scores
report = svc2.drain()["completed"]

slo = SLORegistry()
slo.add(SLOConfig(name="ttft"))
collector = AdminServer(port=0)
collector.register_debug("slo", slo.debug_view)
collector.register_slo_source(slo.export_edges_since)
role = ["decode"]
pod = AdminServer(port=0)
pod.register_debug("role", lambda: {"role": role[0], "starvation": {
    "mix": {"prefill_fraction": 0.9, "samples": 5}}})
pod.register_action("role", lambda q: {"previous": role[0], "role": role.__setitem__(0, q["set"])})
prefill = AdminServer(port=0)
prefill.register_debug("role", lambda: {"role": "prefill"})
addresses = {}
for name, server in (("collector", collector), ("d-0", pod), ("p-0", prefill)):
    addresses[name] = f"127.0.0.1:{server.start()}"
svc_cfg = FleetControllerServiceConfig(
    collector_address=addresses["collector"],
    pod_admin={"d-0": addresses["d-0"], "p-0": addresses["p-0"], "d-1": addresses["d-0"]},
    controller=ControllerConfig(confirm_rounds=1))
fleet = FleetControllerService(svc_cfg)
summary = fleet.controller.reconcile_once()
for server in (collector, pod, prefill):
    server.stop()
print(restored, audit, scores, report, summary["settled"], role[0],
      sorted(m for m in sys.modules if sys.modules[m] is not None and any(
          m == b or m.startswith(b + ".") for b in ("grpc", "google.protobuf", "zmq", "msgpack",
                                                     "prometheus_client", "jax",
                                                     "llmd_kv_cache_tpu"))))
"""


def test_recovery_and_control_run_with_the_wire_libraries_blocked():
    """``recovery/``, ``control/``, ``telemetry/slo.py`` and
    ``services/fleet_controller.py`` import nothing of the JAX package and
    no jax, msgpack, grpc, protobuf, zmq or prometheus_client: with all of
    them blocked a service snapshots, warm-restarts, audits and drains, and
    a fleet controller re-roles a pod over its admin plane."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RECOVERY_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == \
        "2 {} {'pod-m': 2.0} True ['set_role:d-1:1'] prefill []"
