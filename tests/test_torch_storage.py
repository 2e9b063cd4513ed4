"""The port's storage pieces against the JAX package's: the S3 client over
HTTP, the vLLM ``OffloadingSpec`` shim and the storage evictor.

Host code, so every comparison is exact. The S3 cases of
``test_object_store.py`` run each package's client against an in-process
stub that verifies every SigV4 signature (``chip_smoke.S3Stub``): the same
answers and the same objects, and each package reads the other's. The
``test_vllm_spec.py`` cases run both shims under ``chip_smoke``'s vLLM double
in ``sys.modules`` (the reference's CPU pattern): the same manager answers,
byte-equal files from equal pools, and each package's load handler
restoring the other's files. The ``test_evictor.py`` cases run both
evictors on seeded stores: the same candidates in the same order, the
same deletions, and ``BlockRemoved`` payloads byte-equal to JAX's.
"""

import dataclasses
import importlib
import os
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GPULoadStoreSpec, OffloadKey, S3Stub, vllm_config, vllm_double_modules
from llmd_kv_cache_tpu.offload import object_store as jax_os
from llmd_kv_cache_tpu.offload.spec import SharedStorageOffloadSpec as JaxSpec
from llmd_kv_cache_tpu_torch.offload import object_store as port_os
from llmd_kv_cache_tpu_torch.offload.spec import SharedStorageOffloadSpec as PortSpec

PKGS = ("jax", "port")
NAMES = {"jax": "llmd_kv_cache_tpu", "port": "llmd_kv_cache_tpu_torch"}
OS = {"jax": jax_os, "port": port_os}
SPEC = {"jax": JaxSpec, "port": PortSpec}
CREDS = {"AK": "SK", "ENVAK": "ENVSK"}


def wait_results(handlers, job_id, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for res in handlers.get_finished():
            if res.job_id == job_id:
                return res
        time.sleep(0.005)
    raise TimeoutError("job did not finish")


def pools(pkg, seed, shape, zero=False):
    """Equal float32 pools in either package (numpy draws from a seed)."""
    rng = np.random.default_rng(seed)
    k, v = (np.zeros(shape, np.float32) if zero else
            rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if pkg == "jax":
        return jnp.asarray(k), jnp.asarray(v)
    return torch.from_numpy(k.copy()), torch.from_numpy(v.copy())


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# S3 over HTTP
# --------------------------------------------------------------------------

@pytest.fixture()
def s3_stub():
    stub = S3Stub(credentials=CREDS, page=2)
    yield stub
    stub.close()


def s3(pkg, stub, **kw):
    kw.setdefault("access_key", "AK")
    kw.setdefault("secret_key", "SK")
    return OS[pkg].S3ObjectStoreClient("kv-bucket", endpoint_url=stub.url, transport="http", **kw)


def on_both(stub, fn):
    """``fn(pkg)`` for each package on an emptied stub: equal answers and
    equal stored objects, every request signed and verified."""
    out = {}
    for pkg in PKGS:
        stub.store.clear()
        rejected = stub.rejected
        out[pkg] = (fn(pkg), dict(stub.store))
        assert stub.rejected == rejected
    assert out["port"] == out["jax"]
    return out["port"][0]


def test_s3_put_get_exists_delete(s3_stub):
    def run(pkg):
        c = s3(pkg, s3_stub)
        steps = [c.exists("a/b"), c.get("a/b")]
        c.put("a/b", b"hello world")
        steps += [c.exists("a/b"), c.get("a/b"), c.delete("a/b"), c.exists("a/b")]
        c.put("a/keep", b"\x00" * 3)
        return steps
    assert on_both(s3_stub, run) == [False, None, True, b"hello world", True, False]


def test_s3_get_range(s3_stub):
    def run(pkg):
        c = s3(pkg, s3_stub)
        c.put("k", bytes(range(64)))
        return [c.get_range("k", 8, 16), c.get_range("missing", 0, 4), c.get_range("k", 60, 16)]
    assert on_both(s3_stub, run) == [bytes(range(8, 24)), None, None]


def test_s3_list_keys_paginates(s3_stub):
    def run(pkg):
        c = s3(pkg, s3_stub)
        for i in range(5):
            c.put(f"kv/p{i}", b"x")
        c.put("other/q", b"y")
        return c.list_keys("kv/"), c.list_keys("nope/")
    assert on_both(s3_stub, run) == ([f"kv/p{i}" for i in range(5)], [])


def test_s3_signed_requests_verified_and_cross_read(s3_stub):
    """Both packages sign alike: the stub verifies every request, a wrong
    secret is refused and raises, and each package reads the other's
    objects; unsigned requests to a signing endpoint are refused too."""
    for writer, reader in (("jax", "port"), ("port", "jax")):
        s3(writer, s3_stub).put(f"signed/{writer}", writer.encode() * 7)
        assert s3(reader, s3_stub).get(f"signed/{writer}") == writer.encode() * 7
    before = s3_stub.signed
    assert s3_stub.rejected == 0 and before >= 4
    for pkg in PKGS:
        with pytest.raises(IOError, match="HTTP 403"):
            s3(pkg, s3_stub, secret_key="WRONG").put("x", b"y")
        with pytest.raises(IOError, match="HTTP 403"):
            OS[pkg].S3ObjectStoreClient("kv-bucket", endpoint_url=s3_stub.url,
                                        transport="http").get("signed/jax")
    assert s3_stub.rejected == 4 and "x" not in s3_stub.store


def test_s3_failures_raise_never_fall_back(tmp_path):
    """A refused or unreachable endpoint raises from the port's client."""
    stub = S3Stub(credentials=CREDS)
    url = stub.url
    stub.close()
    c = port_os.S3ObjectStoreClient("b", endpoint_url=url, access_key="AK", secret_key="SK",
                                    transport="http")
    with pytest.raises(OSError):
        c.put("k", b"v")
    with pytest.raises(OSError):
        c.get("k")
    with pytest.raises(ValueError, match="needs endpoint_url"):
        port_os.S3ObjectStoreClient("b", transport="http")


def test_s3_unknown_transport_rejected(s3_stub):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match="unknown transport") as exc:
            OS[pkg].S3ObjectStoreClient("b", endpoint_url=s3_stub.url, transport="boto")
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_s3_pathful_endpoint():
    stub = S3Stub(credentials=CREDS, prefix="gateway")
    try:
        def run(pkg):
            c = OS[pkg]._HttpS3("kv-bucket", stub.url, access_key="AK", secret_key="SK")
            c.put("p/x", b"data")
            return c.get("p/x"), c.exists("p/x"), c.get_range("p/x", 1, 2)
        assert on_both(stub, run) == (b"data", True, b"at")
    finally:
        stub.close()


def test_s3_env_credentials_reach_http_transport(s3_stub, monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "ENVAK")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "ENVSK")

    def run(pkg):
        c = OS[pkg].S3ObjectStoreClient("b", endpoint_url=s3_stub.url, transport="http")
        assert isinstance(c._impl, OS[pkg]._HttpS3)
        c.put("e/k", b"v")
        return c._impl.access_key, c._impl.secret_key, c._impl.region, c.get("e/k")
    assert on_both(s3_stub, run) == ("ENVAK", "ENVSK", "us-east-1", b"v")


def test_s3_object_backend_round_trip_across_packages(s3_stub):
    """The offload spec's object backend over real HTTP: each package's
    handlers store equal pools as byte-equal objects, and each package's
    handlers load the other's objects back bit-equal."""
    shape = (2, 8, 2, 4, 8)

    def spec(pkg):
        return SPEC[pkg](root="unused", model_name="m", page_size=4, num_layers=2, kv_heads=2,
                         head_dim=8, dtype="float32", io_threads=2, backend="object",
                         object_store_client=s3(pkg, s3_stub))

    objects = {}
    for pkg in PKGS:
        s3_stub.store.clear()
        handlers = spec(pkg).get_handlers(*pools(pkg, 3, shape))
        try:
            assert wait_results(handlers, handlers.async_store_blocks(
                [(0xF00, [1]), (0xBA5, [2])])).success
        finally:
            handlers.shutdown()
        assert spec(pkg).get_manager().lookup([0xF00, 0xBA5]) == 2
        objects[pkg] = dict(s3_stub.store)
    assert objects["port"] == objects["jax"] and len(objects["port"]) == 2
    k_src = host(pools("jax", 3, shape)[0])
    for writer, reader in (("jax", "port"), ("port", "jax")):
        s3_stub.store.clear()
        s3_stub.store.update(objects[writer])
        h2 = spec(reader).get_handlers(*pools(reader, 0, shape, zero=True))
        try:
            assert wait_results(h2, h2.async_load_blocks([(0xF00, [5]), (0xBA5, [6])])).success
            k2 = host(h2.copier.k_cache)
        finally:
            h2.shutdown()
        np.testing.assert_array_equal(k2[:, 5], k_src[:, 1])
        np.testing.assert_array_equal(k2[:, 6], k_src[:, 2])
    assert s3_stub.rejected == 0


# --------------------------------------------------------------------------
# the vLLM OffloadingSpec shim
# --------------------------------------------------------------------------

@pytest.fixture()
def vllm(monkeypatch):
    """Both packages' ``offload.vllm_spec`` under one vLLM double."""
    for name, mod in vllm_double_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    mods = {}
    for pkg in PKGS:
        sys.modules.pop(f"{NAMES[pkg]}.offload.vllm_spec", None)
        mods[pkg] = importlib.import_module(f"{NAMES[pkg]}.offload.vllm_spec")
    yield types.SimpleNamespace(
        mods=mods,
        Spec={"jax": mods["jax"].TPUStorageOffloadingSpec,
              "port": mods["port"].CUDAStorageOffloadingSpec},
        Storage={"jax": mods["jax"].TPUSharedStorageLoadStoreSpec,
                 "port": mods["port"].CUDASharedStorageLoadStoreSpec})
    for pkg in PKGS:
        sys.modules.pop(f"{NAMES[pkg]}.offload.vllm_spec", None)


LAYERS, PAGES, KV_HEADS, PAGE_SIZE, HEAD_DIM = 2, 32, 2, 4, 8
SHAPE = (LAYERS, PAGES, KV_HEADS, PAGE_SIZE, HEAD_DIM)


def make_spec(vllm, pkg, root, **extra):
    cfg_extra = {"shared_storage_path": str(root), "block_size": 8, "num_layers": LAYERS,
                 "kv_heads": KV_HEADS, "head_dim": HEAD_DIM, "dtype": "float32",
                 "io_threads": 2, "page_size": PAGE_SIZE}
    cfg_extra.update(extra)
    return vllm.Spec[pkg](vllm_config(cfg_extra, model="meta-llama/Llama-3.1-8B-Instruct"),
                          kv_cache_config=None)


def drain(handler, job_id, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for res in handler.get_finished():
            if res.job_id == job_id:
                return res
        time.sleep(0.005)
    raise TimeoutError("transfer did not finish")


def keys(*hashes, group=0):
    return [OffloadKey(group, h) for h in hashes]


def tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def per_pkg(tmp_path, fn):
    out = {pkg: fn(pkg, tmp_path / pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def test_vllm_manager_cycle(vllm, tmp_path):
    def run(pkg, root):
        mgr = make_spec(vllm, pkg, root).get_manager()
        (k1,) = keys(0xAB)
        out = mgr.prepare_store(keys(0xAB, 0xCD), None)
        load_spec = mgr.prepare_load(keys(0xAB), None)
        mgr.touch(keys(0xAB), None)
        mgr.complete_load(keys(0xAB), None)
        mgr.shutdown()
        return (mgr.lookup(k1, None), [k.block_hash for k in out.keys_to_store], out.evicted_keys,
                out.store_spec.keys == out.keys_to_store, out.store_spec.medium(),
                [k.block_hash for k in load_spec.keys], type(load_spec) is vllm.Storage[pkg])
    assert per_pkg(tmp_path, run) == (False, [0xAB, 0xCD], [], True, "SHARED_STORAGE", [0xAB], True)


@pytest.mark.parametrize("groups", [(0,), (0, 1)], ids=["one-group", "per-group"])
def test_vllm_prepare_store_skips_existing_files(vllm, tmp_path, groups):
    def run(pkg, root):
        spec = make_spec(vllm, pkg, root)
        mgr = spec.get_manager()
        path = spec.inner.build_mapper().block_path(0xAB, 0)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"x")
        asked = [k for g in groups for k in keys(0xAB, 0xCD, group=g)]
        out = mgr.prepare_store(asked, None)
        return ([(k.group_idx, k.block_hash) for k in out.keys_to_store],
                mgr.lookup(keys(0xAB)[0], None), os.path.relpath(path, root))
    got = per_pkg(tmp_path, run)
    assert got[0] == [(g, h) for g in groups for h in (0xAB, 0xCD) if (g, h) != (0, 0xAB)]


def test_vllm_block_size_must_divide(vllm, tmp_path):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match="multiple of") as exc:
            make_spec(vllm, pkg, tmp_path, block_size=6, page_size=4)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_vllm_store_files_byte_equal_and_cross_load(vllm, tmp_path):
    """Equal pools through each package's store handler give byte-equal
    files at equal paths; each package's load handler restores the
    other's files into a zeroed pool, bit-equal to the source pages."""
    def store(pkg, root):
        spec = make_spec(vllm, pkg, root)
        pairs = list(spec.get_handlers(pools(pkg, 0, SHAPE)))
        assert len(pairs) == 2
        (src_t, dst_t, store_h), (src_t2, dst_t2, _load_h) = pairs
        assert (src_t, dst_t) == (vllm.mods[pkg].GPULoadStoreSpec, vllm.Storage[pkg])
        assert (src_t2, dst_t2) == (dst_t, src_t)
        gpu = GPULoadStoreSpec([3, 4, 7, 8])
        assert store_h.transfer_async(17, (gpu, vllm.Storage[pkg](keys(0xA, 0xB)))) is True
        res = drain(store_h, 17)
        spec._handlers.shutdown()
        return res.success, res.transfer_size, res.transfer_type, tree(root)
    written = per_pkg(tmp_path, store)
    assert written[0] and written[1] > 0 and written[2] == ("gpu", "storage")
    assert len([p for p in written[3] if p.endswith(".bin")]) == 2
    k_src = host(pools("jax", 0, SHAPE)[0])
    for writer, reader in (("jax", "port"), ("port", "jax")):
        spec2 = make_spec(vllm, reader, tmp_path / writer)
        load_h = list(spec2.get_handlers(pools(reader, 0, SHAPE, zero=True)))[1][2]
        gpu2 = GPULoadStoreSpec([10, 11, 20, 21])
        assert load_h.transfer_async(99, (vllm.Storage[reader](keys(0xA, 0xB)), gpu2)) is True
        assert drain(load_h, 99).success
        k2 = host(spec2._handlers.copiers[0].k_cache)
        spec2._handlers.shutdown()
        for dst, src in ((10, 3), (11, 4), (20, 7), (21, 8)):
            np.testing.assert_array_equal(k2[:, dst], k_src[:, src])


def test_vllm_failed_transfers_report_failure(vllm, tmp_path):
    """A spec whose lengths disagree is refused at submit; a load of a
    missing file completes with ``success=False``."""
    def run(pkg, root):
        spec = make_spec(vllm, pkg, root)
        (_, _, store_h), (_, _, load_h) = list(spec.get_handlers(pools(pkg, 0, SHAPE)))
        refused = store_h.transfer_async(1, (GPULoadStoreSpec([3, 4, 7]),
                                             vllm.Storage[pkg](keys(1, 2))))
        assert load_h.transfer_async(5, (vllm.Storage[pkg](keys(0xDEAD)),
                                         GPULoadStoreSpec([0, 1]))) is True
        res = drain(load_h, 5)
        spec._handlers.shutdown()
        return refused, res.success, res.job_id, res.transfer_type
    assert per_pkg(tmp_path, run) == (False, False, 5, ("storage", "gpu"))


def test_vllm_wait_blocks_until_done_and_applies_scatter(vllm, tmp_path):
    def run(pkg, root):
        spec = make_spec(vllm, pkg, root)
        store_h = list(spec.get_handlers(pools(pkg, 0, SHAPE)))[0][2]
        assert store_h.transfer_async(4, (GPULoadStoreSpec([1, 2]),
                                          vllm.Storage[pkg](keys(0x31)))) is True
        store_h.wait([4])
        spec2 = make_spec(vllm, pkg, root)
        load_h = list(spec2.get_handlers(pools(pkg, 0, SHAPE, zero=True)))[1][2]
        assert load_h.transfer_async(8, (vllm.Storage[pkg](keys(0x31)),
                                         GPULoadStoreSpec([9, 12]))) is True
        load_h.wait([8])
        k2 = host(spec2._handlers.copiers[0].k_cache)
        results = [(r.job_id, r.success) for r in load_h.get_finished()]
        load_h.wait([8, 1234])
        for s in (spec, spec2):
            s._handlers.shutdown()
        return k2[:, [9, 12]].tobytes(), results
    got = per_pkg(tmp_path, run)
    assert got[1] == [(8, True)]
    assert got[0] == host(pools("jax", 0, SHAPE)[0])[:, [1, 2]].tobytes()


def test_vllm_manager_handler_agree_via_files(vllm, tmp_path):
    def run(pkg, root):
        spec = make_spec(vllm, pkg, root)
        store_h = list(spec.get_handlers(pools(pkg, 0, SHAPE)))[0][2]
        mgr = spec.get_manager()
        (key,) = keys(0x77)
        steps = [mgr.lookup(key, None)]
        out = mgr.prepare_store([key], None)
        assert store_h.transfer_async(3, (GPULoadStoreSpec([5, 6]), out.store_spec)) is True
        steps.append(drain(store_h, 3).success)
        mgr.complete_store([key], None)
        steps += [mgr.lookup(key, None), mgr.prepare_store([key], None).keys_to_store]
        spec._handlers.shutdown()
        return steps
    assert per_pkg(tmp_path, run) == [False, True, True, []]


def test_vllm_second_group_gets_its_own_copier(vllm, tmp_path):
    """A pair per cache group: group 1's transfers read and write its own
    pool (the port binds a ``CUDABlockCopier``, JAX a ``TPUBlockCopier``)."""
    def run(pkg, root):
        spec = make_spec(vllm, pkg, root)
        g0, g1 = pools(pkg, 0, SHAPE), pools(pkg, 5, SHAPE)
        store_h = list(spec.get_handlers([g0, g1]))[0][2]
        assert type(spec._handlers.copiers[1]).__name__ == (
            "TPUBlockCopier" if pkg == "jax" else "CUDABlockCopier")
        assert store_h.transfer_async(2, (GPULoadStoreSpec([6, 7]),
                                          vllm.Storage[pkg](keys(0x55, group=1)))) is True
        res = drain(store_h, 2)
        spec._handlers.shutdown()
        return res.success, tree(root)
    ok, files = per_pkg(tmp_path, run)
    assert ok and len(files) >= 1


def test_vllm_import_without_vllm_raises_clear_error(monkeypatch):
    for name in list(sys.modules):
        if name == "vllm" or name.startswith("vllm."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "vllm", None)
    for pkg in PKGS:
        sys.modules.pop(f"{NAMES[pkg]}.offload.vllm_spec", None)
        try:
            with pytest.raises(ImportError, match="requires vllm"):
                importlib.import_module(f"{NAMES[pkg]}.offload.vllm_spec")
        finally:
            sys.modules.pop(f"{NAMES[pkg]}.offload.vllm_spec", None)


# --------------------------------------------------------------------------
# the evictor
# --------------------------------------------------------------------------

EV = {pkg: types.SimpleNamespace(
    evictor=importlib.import_module(f"{NAMES[pkg]}.evictor"),
    stages=importlib.import_module(f"{NAMES[pkg]}.evictor.evictor"),
    fm=importlib.import_module(f"{NAMES[pkg]}.offload.file_mapper"),
    publisher=importlib.import_module(f"{NAMES[pkg]}.events.publisher"),
) for pkg in PKGS}
HEX = list("0123456789abcdef")


def make_store(pkg, root, n=8):
    """8 block files with staggered atimes (oldest 2 h), as JAX's fixture."""
    e = EV[pkg]
    mapper = e.fm.FileMapper(e.fm.FileMapperConfig(root=str(root), model_name="m"))
    now = time.time()
    hashes = [(0x100000000000000 * (i + 1)) | i for i in range(n)]
    for i, h in enumerate(hashes):
        path = mapper.block_path(h)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"x" * 64)
        age = 7200 - i * 900
        os.utime(path, (now - age, now - age))
    return mapper, hashes, now


class FakeSocket:
    def __init__(self):
        self.frames = []

    def setsockopt(self, *a):
        pass

    def connect(self, _endpoint):
        pass

    bind = connect

    def send_multipart(self, frames):
        self.frames.append(list(frames))

    def close(self):
        pass


class FakeContext:
    def __init__(self):
        self.sock = FakeSocket()

    def socket(self, _kind):
        return self.sock


def storage_publisher(pkg, monkeypatch):
    """Each package's own ``StorageEventPublisher`` on a socket double, its
    clock fixed so payloads compare byte for byte."""
    mod = EV[pkg].publisher
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.25))
    ctx = FakeContext()
    return mod.StorageEventPublisher("tcp://127.0.0.1:1", "m", context=ctx), ctx.sock


def rel(paths, root):
    return [os.path.relpath(p, root) for p in paths]


def test_evictor_crawler_partitions_and_orders_as_jax(tmp_path):
    def run(pkg, root):
        st = EV[pkg].stages
        mapper, hashes, now = make_store(pkg, root)
        orphan = mapper.block_path(hashes[0]) + ".tmp.deadpid"
        with open(orphan, "wb") as f:
            f.write(b"partial")
        os.utime(orphan, (now - 7200, now - 7200))
        buckets = [st.crawler_buckets(i, n) for n in (1, 2, 3) for i in range(n)]
        full = list(st.crawl_candidates(str(root), HEX, min_idle_seconds=3600, now=now))
        bounded = list(st.crawl_candidates(str(root), HEX, min_idle_seconds=3600,
                                           max_candidates=2, now=now))
        assert bounded == full[:2] and [a for a, _ in full] == sorted(a for a, _ in full)
        published = []
        st.delete_batch([orphan], publish=published.append)
        return (buckets, [(round(now - a), os.path.relpath(p, root)) for a, p in full], published,
                list(st.crawl_candidates(str(root / "nope"), ["0"], 0)))
    got = per_pkg(tmp_path, run)
    assert len(got[1]) == 6 and got[2] == [] and got[3] == []


def test_evictor_deletes_publish_block_removed_byte_equal(tmp_path, monkeypatch):
    """``delete_batch`` parses the hashes from the paths; each package's
    ``StorageEventPublisher`` frames the same ``BlockRemoved`` bytes."""
    def run(pkg, root):
        st = EV[pkg].stages
        mapper, hashes, _ = make_store(pkg, root)
        pub, sock = storage_publisher(pkg, monkeypatch)
        paths = [mapper.block_path(h) for h in hashes[:3]]
        n = st.delete_batch(paths + [str(root / "gone.bin")], publish=pub.publish_block_removed)
        assert not any(os.path.exists(p) for p in paths)
        return n, sock.frames
    n, frames = per_pkg(tmp_path, run)
    assert n == 3 and len(frames) == 1 and frames[0][0] == b"kv@SHARED_STORAGE@m"


def test_evictor_folder_cleaner_as_jax(tmp_path):
    def run(pkg, root):
        stale = root / "model" / "abc" / "de_g0"
        stale.mkdir(parents=True)
        os.utime(stale, (time.time() - 10_000,) * 2)
        fresh = root / "model" / "fff" / "11_g0"
        fresh.mkdir(parents=True)
        removed = EV[pkg].stages.clean_empty_dirs(str(root), ttl_seconds=600)
        return removed, stale.exists(), fresh.exists()
    removed, stale, fresh = per_pkg(tmp_path, run)
    assert removed >= 1 and not stale and fresh


def test_evictor_hysteresis_as_jax(tmp_path):
    def run(pkg, root):
        usage = {"v": 0.5}
        ev = EV[pkg].evictor.Evictor(EV[pkg].evictor.EvictorConfig(store_root=str(root)),
                                     usage_fn=lambda: usage["v"])
        out = []
        for v in (0.5, 0.9, 0.8, 0.6, 0.85, 0.7):
            usage["v"] = v
            out.append(ev.activator_pass())
        return out
    assert per_pkg(tmp_path, run) == [False, True, True, False, True, False]


@pytest.mark.parametrize("batch", [1, 2, 100])
def test_evictor_pass_takes_the_oldest_first_as_jax(tmp_path, monkeypatch, batch):
    """One crawl-and-delete pass on a seeded store: the same files deleted
    in the same order, and the same ``BlockRemoved`` payload bytes; with
    usage falling below the target after the first batch, both stop."""
    def run(pkg, root):
        mapper, hashes, _ = make_store(pkg, root)
        pub, sock = storage_publisher(pkg, monkeypatch)
        cfg = EV[pkg].evictor.EvictorConfig(store_root=str(root), num_crawlers=1,
                                            min_idle_seconds=3600, delete_batch_size=batch)
        calls = {"n": 0}

        def usage():
            calls["n"] += 1
            return 0.95 if calls["n"] <= 1 or batch > 1 else 0.5
        ev = EV[pkg].evictor.Evictor(cfg, publisher=pub, usage_fn=usage)
        ev.activator_pass()
        deleted = ev.crawl_and_delete_pass(0, max_batches=10)
        left = sorted(h for h in hashes if os.path.exists(mapper.block_path(h)))
        return deleted, ev.total_deleted, left, sock.frames
    deleted, total, left, frames = per_pkg(tmp_path, run)
    assert deleted == total == (1 if batch == 1 else 5)
    assert len(left) == 8 - deleted


def test_evictor_supervised_threads_restart_a_crashed_worker(tmp_path):
    """The supervised loops delete every idle file, through two crashes of
    the usage probe, and stop; both packages delete the same files."""
    def run(pkg, root):
        mapper, hashes, _ = make_store(pkg, root)
        calls = {"n": 0}

        def flaky_usage():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("transient disk-stat failure")
            return 0.95
        cfg = EV[pkg].evictor.EvictorConfig(store_root=str(root), num_crawlers=2,
                                            min_idle_seconds=3600, poll_interval_s=0.05)
        ev = EV[pkg].evictor.Evictor(cfg, usage_fn=flaky_usage)
        ev.start()
        ev.start()  # idempotent
        try:
            deadline = time.monotonic() + 10
            while ev.total_deleted < 5 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            ev.stop()
        return ev.total_deleted, sorted(h for h in hashes if os.path.exists(mapper.block_path(h)))
    assert per_pkg(tmp_path, run)[0] == 5


def test_evictor_config_from_env_as_jax():
    env = {"KVTPU_EVICTOR_STORE_ROOT": "/data", "KVTPU_EVICTOR_CLEANUP_THRESHOLD": "0.9",
           "KVTPU_EVICTOR_NUM_CRAWLERS": "4", "KVTPU_EVICTOR_EVENTS_ENDPOINT": "tcp://x:1"}
    cfgs = [dataclasses.asdict(EV[pkg].evictor.EvictorConfig.from_env(env)) for pkg in PKGS]
    assert cfgs[0] == cfgs[1] and cfgs[1]["num_crawlers"] == 4
    assert [dataclasses.asdict(EV[pkg].evictor.EvictorConfig()) for pkg in PKGS][0] == \
        dataclasses.asdict(EV["port"].evictor.EvictorConfig())


# --------------------------------------------------------------------------
# engines on a vLLM-shaped store (storage blocks of several pages)
# --------------------------------------------------------------------------

PPB = 4  # pages a storage block (a vLLM block of 4 pages of the tiny model)


def tiny_pod(root=None, pod="pod-t", ppb=PPB, **cfg_kw):
    from llmd_kv_cache_tpu_torch.models import engine, llama

    tiny = llama.LlamaConfig.tiny()
    offload = None if root is None else PortSpec(
        root=str(root), model_name="tiny", page_size=tiny.page_size,
        num_layers=tiny.num_layers, kv_heads=tiny.num_kv_heads, head_dim=tiny.head_dim,
        io_threads=2, pages_per_block=ppb)
    return engine.MiniEngine(engine.EngineConfig(
        model=tiny, num_pages=96, max_pages_per_seq=24, model_name="tiny",
        pod_identifier=pod, **cfg_kw), device="cpu", seed=0, offload_spec=offload)


def vllm_extra(root):
    from llmd_kv_cache_tpu_torch.models import llama

    tiny = llama.LlamaConfig.tiny()
    return {"shared_storage_path": str(root), "block_size": PPB * tiny.page_size,
            "page_size": tiny.page_size, "num_layers": tiny.num_layers,
            "kv_heads": tiny.num_kv_heads, "head_dim": tiny.head_dim, "dtype": "bfloat16",
            "io_threads": 2}


def vllm_spec_of(vllm, pkg, root):
    return vllm.Spec[pkg](vllm_config(vllm_extra(root), model="tiny"), None)


def as_pkg_pools(pkg, eng):
    if pkg == "port":
        return eng.k_cache, eng.v_cache
    return tuple(jnp.asarray(x.view(torch.uint16).numpy()).view(jnp.bfloat16)
                 for x in (eng.k_cache, eng.v_cache))


def page_words(x, pages) -> bytes:
    if isinstance(x, torch.Tensor):
        return x[:, pages].contiguous().view(torch.uint16).numpy().tobytes()
    return np.asarray(x[:, np.asarray(pages)].view(jnp.uint16)).tobytes()


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("deferred", [False, True], ids=["add_request", "enqueue"])
def test_engine_restores_a_vllm_store_of_whole_storage_blocks(vllm, tmp_path, writer, deferred):
    """A pod's prompt stored through a vLLM shim (either package's) as
    files of 4 pages keyed by each block's last page hash; a port engine
    whose spec has the same root and geometry restores the whole blocks
    (8 pages of a 34-token prompt), its tokens those of the cold pod."""
    src = tiny_pod()
    prompt = np.random.default_rng(5).integers(1, 256, 34).tolist()  # 8 pages + 2
    req = src.add_request("cold", prompt, max_new_tokens=4)
    while not req.done:
        src.step()
    hashes = req.block_hashes
    pages = [src.block_manager.blocks[h].page for h in hashes]
    vspec = vllm_spec_of(vllm, writer, tmp_path)
    store_h = list(vspec.get_handlers(as_pkg_pools(writer, src)))[0][2]
    keys_ = keys(hashes[PPB - 1], hashes[2 * PPB - 1])
    assert vspec.get_manager().prepare_store(keys_, None).keys_to_store == keys_
    assert store_h.transfer_async(1, (GPULoadStoreSpec(pages[:2 * PPB]),
                                      vllm.Storage[writer](keys_))) is True
    store_h.wait([1])
    assert [r.success for r in store_h.get_finished()] == [True]
    vspec._handlers.shutdown()

    dst = tiny_pod(tmp_path, pod="pod-d")
    assert dst.offload_manager.lookup([hashes[PPB - 1], hashes[2 * PPB - 1]]) == 2
    assert dst.offload_handlers.mapper.fingerprint == vspec.inner.build_mapper().fingerprint
    got = (dst.enqueue if deferred else dst.add_request)("warm", prompt, max_new_tokens=4)
    while not got.done:
        dst.step()
    assert got.cached_len == 2 * PPB * 4 and got.restored_blocks == 2 * PPB
    assert got.output == req.output
    dst_pages = [dst.block_manager.blocks[h].page for h in hashes[:2 * PPB]]
    assert page_words(dst.k_cache, dst_pages) == page_words(src.k_cache, pages[:2 * PPB])
    # A pod whose HBM prefix ends inside a storage block recomputes the
    # rest: a restore starts at a storage-block boundary only.
    part = tiny_pod(tmp_path, pod="pod-p")
    part.generate("head", prompt[:6 * 4 + 1], max_new_tokens=1)
    mid = part.add_request("mid", prompt, max_new_tokens=4)
    assert mid.restored_blocks == 0
    for pod in (dst, part):
        pod.offload_handlers.shutdown()


def test_engine_write_through_is_read_by_both_vllm_load_handlers(vllm, tmp_path):
    """A port engine on a spec of 4 pages a storage block writes whole
    blocks keyed by their last page's hash; both packages' vLLM load
    handlers read them into zeroed pools, bit-equal to the engine's pages."""
    eng = tiny_pod(tmp_path)
    prompt = np.random.default_rng(6).integers(1, 256, 37).tolist()  # 9 pages + 1
    req = eng.add_request("w", prompt, max_new_tokens=2)
    eng.flush_offload()
    hashes = req.block_hashes
    keys_ = keys(hashes[PPB - 1], hashes[2 * PPB - 1])
    files = tree(tmp_path)
    assert sorted(p for p in files if p.endswith(".bin")) == sorted(
        os.path.relpath(eng.offload_handlers.mapper.block_path(k.block_hash), tmp_path)
        for k in keys_)
    pages = [eng.block_manager.blocks[h].page for h in hashes[:2 * PPB]]
    for pkg in PKGS:
        vspec = vllm_spec_of(vllm, pkg, tmp_path)
        mgr = vspec.get_manager()
        assert all(mgr.lookup(k, None) for k in keys_)
        shape = tuple(eng.k_cache.shape)
        fresh = tuple(torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2))
        pools_ = fresh if pkg == "port" else tuple(
            jnp.zeros(shape, jnp.bfloat16) for _ in range(2))
        load_h = list(vspec.get_handlers(pools_))[1][2]
        dst = list(range(40, 40 + 2 * PPB))
        assert load_h.transfer_async(7, (vllm.Storage[pkg](keys_), GPULoadStoreSpec(dst))) is True
        load_h.wait([7])
        assert [r.success for r in load_h.get_finished()] == [True]
        loaded = vspec._handlers.copiers[0]
        assert page_words(loaded.k_cache, dst) == page_words(eng.k_cache, pages)
        assert page_words(loaded.v_cache, dst) == page_words(eng.v_cache, pages)
        vspec._handlers.shutdown()
    eng.offload_handlers.shutdown()


def test_engine_refuses_storage_blocks_with_roles_or_hybrid(tmp_path):
    from llmd_kv_cache_tpu_torch.models import engine, llama

    with pytest.raises(ValueError, match="pages a storage block"):
        tiny_pod(tmp_path, role="prefill")
    eng = tiny_pod(tmp_path)
    with pytest.raises(ValueError, match="pages a storage block"):
        eng.set_role("decode")
    eng.offload_handlers.shutdown()
    hybrid = llama.LlamaConfig.tiny()
    hybrid = dataclasses.replace(hybrid, sliding_window=8, swa_layers=(1,))
    with pytest.raises(ValueError, match="does not take a hybrid model"):
        engine.MiniEngine(engine.EngineConfig(model=hybrid, num_pages=32, max_pages_per_seq=16,
                                              model_name="tiny"), device="cpu",
                          offload_spec=PortSpec(root=str(tmp_path), model_name="tiny",
                                                page_size=4, num_layers=2, kv_heads=2,
                                                head_dim=16, sliding_window=8, swa_layers=(1,),
                                                pages_per_block=PPB))
