"""The port's sharded control plane against the JAX package's.

Every case runs both packages on the same seeded inputs and holds the
port's result to JAX's exactly (this is host code): the consistent-hash
ring (tables, owners, versions, fingerprints over seeded memberships,
joins, leaves and epoch bumps), ``ShardedIndex`` and ``ShardFilterIndex``
(the keys each stores), the ``ShardRouter`` over fake shard clients (the
early exit, failover, degraded serving, breakers, the plan cache, the
batched wire and its fallback to the old wire, hedging past a slow shard),
the hedging primitives, the epoch fence (``TestEpochWireCompat`` and
``TestZombieFencing``'s scripted sequences: decisions, ``fenced_batches``,
index state), the indexer service's stamping and fencing with
``clusterConfig``, and the metric families' names, help and labels. The
JAX cases carried over are those of ``test_cluster_sharding.py``, the
hedging cases of ``test_resilience.py``, ``TestEpochWireCompat`` of
``test_wire_fixtures.py`` and ``TestZombieFencing`` and
``TestSlowShardGrayFailure`` of ``test_failure_recovery.py``.
"""

import dataclasses
import importlib
import os
import pathlib
import random
import subprocess
import sys
import time
import types

import msgpack
import pytest

from torch_telemetry_helpers import (
    private_flight_recorders,
    private_jax_metrics,
    private_port_metrics,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIRE_DIR = ROOT / "tests" / "assets" / "wire"
PKGS = ("jax", "port")
NAMES = {"jax": "llmd_kv_cache_tpu", "port": "llmd_kv_cache_tpu_torch"}
BLOCK = 4
MODEL = "m"


def _side(pkg: str) -> types.SimpleNamespace:
    root = NAMES[pkg]

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    tp = mod("core.token_processor")
    keys = mod("core.keys")
    im = mod("index.in_memory")
    events = mod("events.model")
    return types.SimpleNamespace(
        pkg=pkg, cluster=mod("cluster"), ring=mod("cluster.ring"),
        config=mod("cluster.config"), membership=mod("cluster.membership"),
        router=mod("cluster.router"), remote=mod("cluster.remote"),
        resilience=mod("resilience"),
        failpoints=mod("resilience.failpoints").failpoints,
        Tokens=tp.ChunkedTokenDatabase, TokensConfig=tp.TokenProcessorConfig,
        PodEntry=keys.PodEntry, KeyType=keys.KeyType,
        InMemoryIndex=im.InMemoryIndex, InMemoryIndexConfig=im.InMemoryIndexConfig,
        pool=mod("events.pool"), events=events, svc=mod("services.indexer_service"),
        IndexerConfig=mod("scoring.indexer").IndexerConfig,
        collector=mod("metrics.collector"), reconcile=mod("recovery.reconcile"),
    )


SIDES = {pkg: _side(pkg) for pkg in PKGS}


@pytest.fixture(autouse=True)
def _private_state(monkeypatch):
    """Fresh metric families, flight recorders and failpoints in both
    packages: the JAX package's own tests later in the worker see nothing
    of what these cases drove."""
    private_jax_metrics(monkeypatch)
    private_port_metrics(monkeypatch)
    for s in SIDES.values():
        s.failpoints.reset(seed=1337)
    with private_flight_recorders():
        yield
    for s in SIDES.values():
        s.failpoints.reset()


def both(fn, *args, **kwargs):
    """``fn(side, ...)`` on each package; the two results must be equal."""
    out = {pkg: fn(SIDES[pkg], *args, **kwargs) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def sample_keys(n=2000, seed=0x9E3779B97F4A7C15):
    """Deterministic pseudo-random 64-bit keys (the JAX tests' generator)."""
    keys, x = [], seed
    for _ in range(n):
        x = (x * 6364136223846793005 + 1442695040888963407) & ((1 << 64) - 1)
        keys.append(x)
    return keys


def entry(s, pod="pod-1", tier="gpu"):
    return s.PodEntry(pod_identifier=pod, device_tier=tier)


def ring_view(s, ring) -> dict:
    return {
        "table": list(ring._table), "prefs": [list(p) for p in ring._prefs],
        "version": ring.version, "capacity": ring.capacity, "load": ring.load(),
        "describe": ring.describe(),
        "fingerprint": s.ring.assignment_fingerprint(ring),
    }


# --------------------------------------------------------------------------
# the ring
# --------------------------------------------------------------------------

MEMBERSHIPS = [
    [f"shard-{i}" for i in range(2)],
    [f"shard-{i}" for i in range(4)],
    [f"shard-{i}" for i in range(8)],
    [f"10.0.0.{i}:50051" for i in range(1, 5)],
    ["s3", "s1", "s0", "s2"],
]


@pytest.mark.parametrize("members", MEMBERSHIPS, ids=lambda m: f"{len(m)}-{m[0]}")
def test_ring_tables_and_balance_equal_jax(members):
    """Tables, preference lists, versions and fingerprints are JAX's; the
    bounded-load cap holds and no shard starves."""
    def run(s):
        ring = s.ring.HashRing(members)
        load = ring.load()
        assert sum(load.values()) == ring.partitions
        assert all(0 < c <= ring.capacity for c in load.values()), load
        keys = sample_keys()
        counts = {sh: 0 for sh in ring.shards}
        for k in keys:
            counts[ring.owner(k)] += 1
        assert all(c / len(keys) <= ring.capacity / ring.partitions * 1.2
                   for c in counts.values()), counts
        return ring_view(s, ring), [ring.owners(k, 3) for k in keys[:300]], counts
    both(run)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("change", ["join", "leave"])
def test_ring_join_leave_moves_less_than_2_over_n(n, change):
    def run(s):
        shards = [f"shard-{i}" for i in range(n + (change == "leave"))]
        old = s.ring.HashRing(shards)
        new = s.ring.HashRing(shards + [f"shard-{n}"] if change == "join" else shards[:-1])
        keys = sample_keys()
        moved = sum(1 for k in keys if old.owner(k) != new.owner(k))
        assert moved / len(keys) < 2 / n
        return moved, s.ring.moved_partitions(old, new), ring_view(s, new)["fingerprint"]
    both(run)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_ring_back_to_back_join_then_leave_round_trips(n):
    def run(s):
        shards = [f"shard-{i}" for i in range(n)]
        base, grown = s.ring.HashRing(shards), s.ring.HashRing(shards + [f"shard-{n}"])
        shrunk = s.ring.HashRing(shards)
        assert s.ring.assignment_fingerprint(shrunk) == s.ring.assignment_fingerprint(base)
        hops = [s.ring.moved_partitions(a, b) for a, b in ((base, grown), (grown, shrunk))]
        assert all(h / base.partitions < 2 / n for h in hops)
        return hops, s.ring.moved_partitions(base, shrunk)
    both(run)


def test_ring_movement_composition_and_validation():
    def run(s):
        R = s.ring.HashRing
        base, joined = R(["s0", "s1", "s2", "s3"]), R(["s0", "s1", "s2", "s3", "s4"])
        replaced = R(["s0", "s1", "s2", "s4"])
        hops = (s.ring.moved_partitions(base, joined), s.ring.moved_partitions(joined, replaced))
        composed = s.ring.moved_partitions(base, replaced)
        assert composed <= sum(hops) and composed >= base.load()["s3"]
        a, b = R(["a", "b", "c", "d"]), R(["a", "b", "c", "d", "e"])
        expect = sum(1 for p in range(a.partitions)
                     if a.owner_of_partition(p) != b.owner_of_partition(p))
        assert s.ring.moved_partitions(a, b) == expect
        errors = []
        for bad in (lambda: R([]), lambda: R(["a"], load_factor=0.9),
                    lambda: R(["a"], virtual_nodes=0), lambda: R(["a"], epoch=-1),
                    lambda: s.ring.moved_partitions(a, R(["a", "b"], partitions=256))):
            with pytest.raises(ValueError) as exc:
                bad()
            errors.append(str(exc.value))
        return hops, composed, expect, errors
    both(run)


def test_ring_epochs_change_fingerprint_not_placement():
    def run(s):
        R = s.ring.HashRing
        shards = [f"shard-{i}" for i in range(4)]
        base, grown, shrunk = R(shards, epoch=1), R(shards + ["shard-4"], epoch=2), R(shards, epoch=3)
        assert s.ring.moved_partitions(base, shrunk) == 0
        assert len({s.ring.assignment_fingerprint(r) for r in (base, grown, shrunk)}) == 3
        bumped = base.with_epoch(5)
        assert bumped.shards == base.shards and s.ring.moved_partitions(base, bumped) == 0
        legacy = R(["s0", "s1", "s2"])
        assert s.ring.assignment_fingerprint(legacy) == s.ring.assignment_fingerprint(
            R(["s0", "s1", "s2"], epoch=0))
        assert R(["s0", "s1"]).version != R(["s0", "s1"], virtual_nodes=32).version
        return [ring_view(s, r) for r in (base, grown, shrunk, bumped, legacy)]
    both(run)


def test_ring_plans_track_membership_across_join_leave():
    def run(s):
        R = s.ring.HashRing
        keys = sample_keys(400)
        base, grown, shrunk = R(["s0", "s1", "s2"]), R(["s0", "s1", "s2", "s3"]), R(["s0", "s1", "s2"])
        plans = [s.ring.plan_owners(r, keys) for r in (base, grown, shrunk)]
        assert plans[2] == plans[0]
        assert {b for a, b in zip(plans[0], plans[1]) if a != b} == {"s3"}
        assert plans[0] == tuple(base.owner(k) for k in keys)
        return plans
    both(run)


def test_ring_cross_process_assignment_identical():
    """Fresh interpreters with different hash seeds derive the port's ring
    byte-identically, equal to JAX's in this process."""
    code = ("from llmd_kv_cache_tpu_torch.cluster import HashRing, assignment_fingerprint\n"
            "print(assignment_fingerprint(HashRing(['s0', 's1', 's2', 's3'])))\n")
    prints = []
    for seed in ("1", "31337"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONHASHSEED"] = seed
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120, env=env, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        prints.append(int(out.stdout.strip()))
    jax = SIDES["jax"].ring
    assert prints[0] == prints[1] == jax.assignment_fingerprint(jax.HashRing(["s0", "s1", "s2", "s3"]))


# --------------------------------------------------------------------------
# the indexes
# --------------------------------------------------------------------------

def make_children(s, shards):
    return {sh: s.InMemoryIndex(s.InMemoryIndexConfig(size=10_000)) for sh in shards}


def state_of(index) -> dict:
    st = index.dump_state()
    return {"entries": sorted((int(k), sorted(map(list, rows))) for k, rows in st["entries"]),
            "mappings": sorted((int(k), list(v)) for k, v in st["mappings"])}


@pytest.mark.parametrize("op", ["add_lookup", "engine_evict", "engine_evict_batch", "clear",
                                "dump_restore"])
def test_sharded_index_routes_as_jax(op):
    def run(s):
        ring = s.ring.HashRing(["s0", "s1", "s2"])
        children = make_children(s, ring.shards)
        index = s.cluster.ShardedIndex(children, ring)
        with pytest.raises(ValueError):
            s.cluster.ShardedIndex({"s0": children["s0"]}, ring)
        keys = sample_keys(50)
        e = [entry(s)]
        if op == "add_lookup":
            index.add(None, keys, e)
            for k in keys:
                assert children[ring.owner(k)].lookup([k])
            assert set(index.lookup(keys)) == set(keys)
        elif op == "engine_evict":
            index.add([1234567], keys[:1], e)
            assert index.get_request_key(1234567) == keys[0]
            index.evict(1234567, s.KeyType.ENGINE, e)
            assert index.lookup(keys[:1]) == {}
        elif op == "engine_evict_batch":
            index.add(list(range(1, 21)), keys[:20], e)
            index.evict_batch(list(range(1, 21)), s.KeyType.ENGINE, e)
            assert index.lookup(keys[:20]) == {}
        elif op == "clear":
            index.add(None, keys, e)
            index.clear("pod-1")
            assert index.lookup(keys) == {}
        else:
            index.add(list(range(40)), keys[:40], e)
            fresh = s.cluster.ShardedIndex(make_children(s, ring.shards), ring)
            fresh.restore_state(index.dump_state())
            assert set(fresh.lookup(keys[:40])) == set(keys[:40])
            assert fresh.get_request_key(7) == index.get_request_key(7)
        return {sh: state_of(c) for sh, c in children.items()}
    both(run)


@pytest.mark.parametrize("rf", [1, 2])
def test_shard_filter_index_stores_owned_keys_as_jax(rf):
    def run(s):
        ring = s.ring.HashRing(["s0", "s1", "s2", "s3"])
        inner = s.InMemoryIndex(s.InMemoryIndexConfig(size=10_000))
        filt = s.cluster.ShardFilterIndex(inner, ring, "s0", replication_factor=rf)
        with pytest.raises(ValueError):
            s.cluster.ShardFilterIndex(inner, ring, "nope")
        keys, eks = sample_keys(200), list(range(1, 201))
        filt.add(eks, keys, [entry(s)])
        owned = [k for k in keys if filt.owns(k)]
        assert 0 < len(owned) < len(keys)
        assert all(filt.get_request_key(ek) is not None for ek in eks)
        assert (filt.owned_writes, filt.filtered_writes) == (len(owned), len(keys) - len(owned))
        filt.evict_batch(eks[:10], s.KeyType.ENGINE, [entry(s)])
        view = filt.debug_view()
        assert view["shard_id"] == "s0" and view["ring"]["shards"] == list(ring.shards)
        return state_of(inner), view, sum(1 for k in sample_keys(500) if filt.owns(k))
    both(run)


# --------------------------------------------------------------------------
# the router over fake shard clients
# --------------------------------------------------------------------------

class FakeShardClient:
    """In-process stand-in for ``cluster.remote.ShardClient`` (the JAX
    tests' double)."""

    def __init__(self, shard, store):
        self.shard, self.store = shard, store
        self.fail = False
        self.calls = 0

    def lookup_blocks(self, keys, pods=None, timeout=None):
        self.calls += 1
        if self.fail:
            raise ConnectionError(f"{self.shard} down")
        return {"hits": {k: self.store[k] for k in keys if k in self.store},
                "degraded": False, "shard": self.shard}

    def close(self):
        pass


class FakeBatchShardClient(FakeShardClient):
    """Batch-capable stand-in with the server's per-chunk early exit."""

    def __init__(self, shard, store):
        super().__init__(shard, store)
        self.batch_calls = 0
        self.unimplemented = False

    def lookup_blocks_batch(self, chunks, pods=None, timeout=None, deadline=None, hedge=False):
        self.calls += 1
        if self.fail:
            raise ConnectionError(f"{self.shard} down")
        if self.unimplemented:
            raise NotImplementedError("old shard: no batch frame")
        self.batch_calls += 1
        hits, cont = {}, []
        for ckeys in chunks:
            chunk_hits = {k: self.store[k] for k in ckeys if k in self.store}
            hits.update(chunk_hits)
            cont.append(len(chunk_hits) == len(ckeys))
            if len(chunk_hits) < len(ckeys):
                break
        return {"hits": hits, "cont": cont, "degraded": False, "shard": self.shard}


def make_router(s, cfg=None, rf=2, client_cls=FakeShardClient, **cfg_kw):
    cfg = cfg or s.config.ClusterConfig(shard_addresses=["s0", "s1", "s2", "s3"],
                                        replication_factor=rf, fanout_chunk_blocks=4, **cfg_kw)
    tp = s.Tokens(s.TokensConfig(block_size_tokens=BLOCK))
    tokens = list(range(1, 65))  # 16 blocks of 4
    keys = tp.tokens_to_kv_block_keys(0, tokens, MODEL)
    ring = cfg.build_ring()
    stores = {sh: {} for sh in ring.shards}
    for k in keys:
        for owner in ring.owners(k, cfg.replication_factor):
            stores[owner][k] = [entry(s)]
    clients = {sh: client_cls(sh, stores[sh]) for sh in ring.shards}
    router = s.cluster.ShardRouter(cfg, token_processor_config=s.TokensConfig(block_size_tokens=BLOCK),
                                   clients=clients)
    return router, clients, tokens, keys, stores


def score_view(res, rpcs=True) -> dict:
    d = dataclasses.asdict(res)
    d.pop("hedges"), d.pop("hedge_wins")
    if not rpcs:
        d.pop("rpcs")
    return d


ROUTER_CASES = ["full_hit", "early_exit", "failover", "all_down", "fail_mode", "breaker",
                "plan_cache", "empty", "debug_view"]


@pytest.mark.parametrize("case", ROUTER_CASES)
def test_router_scores_equal_jax(case):
    """The JAX ``TestShardRouter`` cases: each ``RouterScore`` (hedge
    counts aside: hedging never fires on an instant double, but a loaded
    host may let one through) equals JAX's."""
    def run(s):
        cfg = None
        if case == "fail_mode":
            cfg = s.config.ClusterConfig(shard_addresses=["s0", "s1", "s2", "s3"], replication_factor=1,
                                         fanout_chunk_blocks=0, degraded_serve_mode="fail")
        elif case == "breaker":
            cfg = s.config.ClusterConfig(shard_addresses=["s0", "s1", "s2", "s3"], replication_factor=2,
                                         fanout_chunk_blocks=0, breaker_failure_threshold=2,
                                         breaker_reset_timeout_s=60.0)
        router, clients, tokens, keys, stores = make_router(s, cfg=cfg, rf=1 if cfg and case == "fail_mode" else 2)
        try:
            if case == "full_hit":
                res = router.score(tokens, MODEL)
                assert res.hit_blocks == len(keys) and not res.degraded
                return score_view(res)
            if case == "early_exit":
                for k in keys[4:]:
                    for store in stores.values():
                        store.pop(k, None)
                res = router.score(tokens, MODEL)
                plan = router.plan(keys)
                assert res.hit_blocks == 4
                assert res.rpcs == sum(c.calls for c in clients.values())
                assert res.rpcs <= len(set(plan[:4])) + len(set(plan[4:8]))
                return score_view(res)
            if case == "failover":
                clients["s1"].fail = True
                res = router.score(tokens, MODEL)
                assert res.hit_blocks == len(keys) and res.degraded_shards == []
                return score_view(res, rpcs=False)
            if case == "all_down":
                for c in clients.values():
                    c.fail = True
                res = router.score(tokens, MODEL)
                assert res.scores == {} and res.degraded
                assert set(res.degraded_shards) >= {router.ring.owner(k) for k in keys[:4]}
                return score_view(res, rpcs=False)
            if case == "fail_mode":
                victim = router.ring.owner(keys[0])
                clients[victim].fail = True
                with pytest.raises(s.cluster.DegradedShardError) as exc:
                    router.score(tokens, MODEL)
                assert victim in exc.value.shards
                return exc.value.shards
            if case == "breaker":
                victim = router.ring.owner(keys[0])
                clients[victim].fail = True
                views = [score_view(router.score(tokens, MODEL), rpcs=False) for _ in range(3)]
                assert router.breakers[victim].state == "open"
                calls = clients[victim].calls
                views.append(score_view(router.score(tokens, MODEL), rpcs=False))
                assert clients[victim].calls == calls
                return views, {sh: b.state for sh, b in router.breakers.items()}
            if case == "plan_cache":
                plan1 = router.plan(keys)
                plan2 = router.plan(keys)
                assert plan1 == plan2 == s.ring.plan_owners(router.ring, keys)
                return plan1, router.plan_hits, router.plan_misses
            if case == "empty":
                return score_view(router.score([], MODEL))
            view = router.debug_view()
            assert view["data_plane"]["batch_capable"] is False
            return view
        finally:
            router.close()
    both(run)


BATCH_CASES = ["engaged", "truncate-4", "truncate-6", "unimplemented", "mixed_legacy",
               "failover", "disabled", "debug_view"]


@pytest.mark.parametrize("case", BATCH_CASES)
def test_router_batched_wire_equals_jax(case):
    """The JAX ``TestBatchedFanout`` cases: the framed multi-chunk wire,
    its early-exit truncation, and the fallback to the old wire."""
    def run(s):
        kw = {"fanout_batch_chunks": 0} if case == "disabled" else {}
        router, clients, tokens, keys, stores = make_router(s, client_cls=FakeBatchShardClient, **kw)
        try:
            if case.startswith("truncate"):
                keep = int(case.split("-")[1])
                for k in keys[keep:]:
                    for store in stores.values():
                        store.pop(k, None)
                res = router.score(tokens, MODEL)
                assert res.hit_blocks == keep
                return score_view(res)
            if case == "debug_view":
                return router.debug_view()["data_plane"]
            if case == "unimplemented":
                for c in clients.values():
                    c.unimplemented = True
            if case in ("mixed_legacy", "failover"):
                victim = router.ring.owner(keys[0])
                if case == "mixed_legacy":
                    clients[victim].unimplemented = True
                else:
                    clients[victim].fail = True
            res = router.score(tokens, MODEL)
            assert res.hit_blocks == len(keys) and not res.degraded_shards
            out = [score_view(res, rpcs=case != "failover"), router.batch_rpcs,
                   router.batch_fallbacks, sorted(router._legacy_shards)]
            if case == "unimplemented":
                assert all(b.state == "closed" for b in router.breakers.values())
                before = sum(c.batch_calls for c in clients.values())
                router.score(tokens, MODEL)
                assert sum(c.batch_calls for c in clients.values()) == before
                out.append(router.batch_fallbacks)
            if case == "engaged":
                assert res.rpcs == len(set(router.plan(keys))) == sum(
                    c.batch_calls for c in clients.values())
            if case == "disabled":
                assert not router._batch_capable and router.batch_rpcs == 0
            return out
        finally:
            router.close()
    both(run)


def test_router_unimplemented_grpc_status_without_importing_grpc():
    """The port recognises an ``UNIMPLEMENTED`` status only from an
    imported ``grpc``; any other error is not a cue for the old wire."""
    import grpc

    class Unimplemented(grpc.RpcError):
        def code(self):
            return grpc.StatusCode.UNIMPLEMENTED

    for s in SIDES.values():
        assert s.router.ShardRouter._unimplemented(Unimplemented())
        assert s.router.ShardRouter._unimplemented(NotImplementedError())
        assert not s.router.ShardRouter._unimplemented(ConnectionError())


def test_router_epoch_pinning_and_residency_equal_jax():
    """``attach_membership`` swaps the ring on an epoch bump and stamps
    every RPC; a newer epoch on a response is learned and serves the score
    degraded-not-fatal; ``role="decode"`` adds the residency bonus."""
    def run(s):
        router, clients, tokens, keys, _ = make_router(s)
        stamps = []

        def stamped(client):
            inner = client.lookup_blocks

            def lookup_blocks(keys, pods=None, timeout=None, deadline=None, hedge=False, epoch=0):
                stamps.append(epoch)
                res = inner(keys, pods, timeout)
                res["epoch"] = 9 if client.shard == "s2" else epoch
                return res
            client.lookup_blocks = lookup_blocks
        for c in clients.values():
            stamped(c)
        try:
            table = s.membership.MembershipTable(epoch=4)
            router.attach_membership(table)
            assert router.ring.epoch == 4
            res = router.score(tokens, MODEL)

            class Residency:
                def bonus(self, keys, pods):
                    return {"pod-9": 2.5, "pod-1": 1.0}
            router.attach_residency(Residency())
            res2 = router.score(tokens, MODEL, role="decode")
            return (score_view(res), score_view(res2, rpcs=False), table.epoch, router.ring.epoch,
                    sorted(set(stamps)), router.debug_view()["epoch"])
        finally:
            router.close()
    out = both(run)
    assert out[0]["cross_epoch"] > 0 and out[2] == 9


def test_router_hedging_rides_out_one_slow_shard():
    """``TestSlowShardGrayFailure``: one of four shards answers 10x slow
    through a delay failpoint; hedges to the rf=2 replica owner win and
    keep every score exact with no breaker opening, in both packages."""
    healthy_s, slow_s = 0.002, 0.05

    def run(s):
        class Delayed(FakeShardClient):
            hedge_calls = 0

            def lookup_blocks(self, keys, pods=None, timeout=None, deadline=None, hedge=False):
                self.calls += 1
                self.hedge_calls += int(hedge)
                time.sleep(healthy_s)
                s.failpoints.hit(f"chaos.shard.lookup.{self.shard}")
                return {"hits": {k: self.store[k] for k in keys if k in self.store},
                        "degraded": False, "shard": self.shard}
        router, clients, tokens, keys, _ = make_router(
            s, client_cls=Delayed, fanout_timeout_s=2.0, hedge_min_delay_s=0.005,
            hedge_budget_rate=1.0, hedge_budget_burst=64.0)
        try:
            for _ in range(10):
                assert router.score(tokens, MODEL).hit_blocks == len(keys)
            s.failpoints.arm("chaos.shard.lookup.s1", mode="delay", delay_s=slow_s)
            hedged, won, views = 0, 0, []
            for _ in range(8):
                res = router.score(tokens, MODEL)
                hedged, won = hedged + res.hedges, won + res.hedge_wins
                views.append(score_view(res, rpcs=False))
            # A won hedge is a score answered before the slow shard did
            # (the availability the JAX case times on the wall clock).
            assert hedged > 0 and won > 0
            assert all(b.state == "closed" for b in router.breakers.values())
            assert sum(c.hedge_calls for c in clients.values()) > 0
            return views
        finally:
            router.close()
    views = both(run)
    assert all(v["hit_blocks"] == 16 and not v["degraded"] for v in views)


def test_cluster_config_equal_jax():
    d = {"shardAddresses": ["a:1", "b:1"], "shardIds": ["s-a", "s-b"], "shardId": "s-a",
         "virtualNodes": 32, "partitions": 256, "loadFactor": 1.5, "replicationFactor": 3,
         "fanoutTimeoutS": 0.5, "fanoutChunkBlocks": 64, "fanoutBatchChunks": 4,
         "degradedServeMode": "fail", "planCacheSize": 16, "breakerFailureThreshold": 7,
         "breakerResetTimeoutS": 1.5, "hedgeEnabled": False, "hedgeQuantile": 0.9,
         "fenceMode": "reject", "leaseTtlS": 12.0, "leaseRenewS": 3.0}

    def run(s):
        C = s.config.ClusterConfig
        cfg = C.from_dict(d)
        assert cfg.address_of("s-b") == "b:1" and cfg.build_ring().partitions == 256
        with pytest.raises(KeyError):
            cfg.address_of("nope")
        with pytest.raises(ValueError):
            C(shard_addresses=["a:1", "b:1"], shard_count=3).build_ring()
        with pytest.raises(ValueError):
            C(shard_addresses=["a:1"], shard_ids=["x", "y"]).membership()
        assert not C().enabled and dataclasses.asdict(C.from_dict(None)) == dataclasses.asdict(C())
        with pytest.raises(ValueError):
            s.cluster.ShardRouter(C())
        icfg = s.IndexerConfig.from_dict({"clusterConfig": d})
        return dataclasses.asdict(cfg), dataclasses.asdict(icfg.cluster_config)
    both(run)


# --------------------------------------------------------------------------
# hedging primitives (test_resilience.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cold", "upper_tail", "independent", "invalid"])
def test_latency_quantile_tracker_equal_jax(case):
    def run(s):
        T = s.resilience.LatencyQuantileTracker
        if case == "cold":
            t = T(quantile=0.95, min_samples=8)
            vals = [t.value("shard-0")]
            for _ in range(8):
                t.observe("shard-0", 0.01)
                vals.append(t.value("shard-0"))
            assert vals[7] is None and vals[8] is not None
            return vals
        if case == "upper_tail":
            t = T(quantile=0.9, min_samples=8)
            rng = random.Random(42)
            samples = [rng.uniform(0.001, 0.01) for _ in range(2000)]
            for x in samples:
                t.observe("s", x)
            est = t.value("s")
            assert 0.75 <= sum(1 for x in samples if x <= est) / len(samples) <= 1.0
            return est
        if case == "independent":
            t = T(quantile=0.9, min_samples=4)
            for _ in range(16):
                t.observe("fast", 0.001)
                t.observe("slow", 0.1)
            assert t.value("slow") > t.value("fast") * 10
            return t.snapshot()
        msgs = []
        for q in (0.3, 1.0):
            with pytest.raises(ValueError) as exc:
                T(quantile=q)
            msgs.append(str(exc.value))
        return msgs
    both(run)


@pytest.mark.parametrize("case", ["capped", "burst", "denied", "invalid"])
def test_hedge_budget_equal_jax(case):
    def run(s):
        B = s.resilience.HedgeBudget
        if case == "capped":
            b = B(rate=0.1, burst=8.0)
            granted = 0
            for _ in range(200):
                b.on_primary()
                granted += b.spend()
            assert granted <= 21 and b.hedge_rate() <= 0.15
            return granted, b.stats(), b.hedge_rate()
        if case == "burst":
            b = B(rate=1.0, burst=4.0)
            b.on_primary(1000)
            granted = sum(1 for _ in range(100) if b.spend())
            assert granted == 4
            return b.stats()
        if case == "denied":
            b = B(rate=0.0, burst=1.0)
            assert b.spend() and not b.spend()
            return b.stats()
        with pytest.raises(ValueError) as exc:
            B(rate=-0.1)
        return str(exc.value)
    both(run)


# --------------------------------------------------------------------------
# the epoch fence
# --------------------------------------------------------------------------

def _load(name):
    return (WIRE_DIR / name).read_bytes()


@pytest.mark.parametrize("fixture", ["score_request_legacy.bin", "score_request_epoch.bin"])
def test_epoch_wire_requests_decode_as_jax(fixture):
    """``TestEpochWireCompat``: legacy bytes decode unstamped (epoch 0),
    stamped ones keep their epoch and drop unknown keys, in both packages."""
    def run(s):
        req = s.svc.ScoreRequest.from_bytes(_load(fixture))
        again = s.svc.ScoreRequest.from_bytes(req.to_bytes())
        return dataclasses.asdict(req), dataclasses.asdict(again), req.to_bytes()
    out = both(run)
    assert out[0]["epoch"] == (7 if "epoch" in fixture else 0)


@pytest.mark.parametrize("fixture", ["score_response_legacy.bin", "score_response_fenced.bin"])
def test_epoch_wire_responses_decode_as_jax(fixture):
    def run(s):
        resp = s.svc.ScoreResponse.from_bytes(_load(fixture))
        assert s.svc.ScoreResponse.from_bytes(resp.to_bytes()) == resp
        return dataclasses.asdict(resp), resp.to_bytes()
    out = both(run)
    if "fenced" in fixture:
        assert (out[0]["degraded_reason"], out[0]["epoch"]) == ("fenced", 7)


def test_epoch_wire_frames_and_event_batch():
    """The stamped lookup frame an old shard projects, and the KV-event
    batch's element [4] through each package's vLLM adapter."""
    d = msgpack.unpackb(_load("lookup_request_epoch.bin"), raw=False)
    assert (d["keys"], d["epoch"]) == ([100, 101], 7)
    # The port's ShardClient frame packs byte-equal to msgpack's.
    frame = {"keys": [100, 101], "pods": ["pod-1"], "epoch": 7}
    assert SIDES["port"].remote._pack(frame) == msgpack.packb(frame, use_bin_type=True)

    def run(s):
        adapters = importlib.import_module(f"{NAMES[s.pkg]}.events.adapters.vllm")
        out = []
        for name in ("vllm_epoch_stamped.bin", "vllm_block_stored_full.bin"):
            _, _, batch = adapters.VLLMAdapter().parse_message(
                s.events.RawMessage(topic="kv@pod-1@m", sequence=0, payload=_load(name)))
            out.append((batch.epoch, batch.traceparent))
        return out
    assert both(run)[0][0] == 7


def test_epoch_warn_mode_interop_with_old_peers():
    def run(s):
        table = s.membership.MembershipTable(fence_mode="warn", epoch=7)
        out = [table.check_request(0, "score"), table.check_request(6, "score"),
               table.check_request(7, "score"), table.check_request(9, "score")]
        assert out[0].allowed and not out[0].flagged and out[1].allowed and out[1].flagged
        view = table.debug_view()
        for r in view["recent_rejections"]:
            r.pop("ts")
        return [dataclasses.asdict(d) for d in out], view, table.epoch
    both(run)


def test_membership_validation_and_leases_equal_jax():
    def run(s):
        M = s.membership.MembershipTable
        msgs = []
        for kw in ({"fence_mode": "loud"}, {"lease_ttl_s": 0}, {"lease_ttl_s": 5, "lease_renew_s": 5}):
            with pytest.raises(ValueError) as exc:
                M(**kw)
            msgs.append(str(exc.value))
        clk = [100.0]
        table = M(fence_mode="reject", lease_ttl_s=30.0, lease_renew_s=10.0, clock=lambda: clk[0])
        bumps = []
        table.add_epoch_listener(bumps.append)
        table.grant("pod-a")
        table.grant("pod-b")
        clk[0] += 20
        steps = [table.renew("pod-a"), table.renew("pod-x")]
        clk[0] += 20  # pod-b is 40 s past its grant
        steps += [table.lease_valid("pod-a"), table.lease_valid("pod-b"), table.renew("pod-b")]
        steps += [dataclasses.asdict(table.check_write("pod-b", 0, "events.ingest")),
                  dataclasses.asdict(table.check_write("pod-a", 0, "events.ingest")),
                  table.observe_epoch(3, "ctl"), table.observe_epoch(2, "ctl"),
                  dataclasses.asdict(table.check_request(2, "score")),
                  table.readmit("pod-b"), table.lease_valid("pod-b")]
        view = table.debug_view()
        for r in view["recent_rejections"]:
            r.pop("ts")
        return msgs, steps, bumps, view
    both(run)


def _zombie_stack(s):
    processor = s.Tokens(s.TokensConfig(block_size_tokens=BLOCK))
    index = s.InMemoryIndex(s.InMemoryIndexConfig(size=10_000))
    pool = s.pool.Pool(s.pool.PoolConfig(concurrency=1), index, processor)
    pool.start()
    clk = [1000.0]
    table = s.membership.MembershipTable(fence_mode="reject", lease_ttl_s=30.0,
                                         lease_renew_s=10.0, clock=lambda: clk[0])
    pool.attach_membership(table)
    return processor, index, pool, table


def _zbatch(s, tokens, hashes, epoch=0):
    return s.events.EventBatch(timestamp=0.0, events=[s.events.BlockStoredEvent(
        block_hashes=hashes, tokens=tokens, parent_hash=0, block_size=BLOCK)], epoch=epoch)


def _rejections(table):
    view = table.debug_view()
    for r in view["recent_rejections"]:
        r.pop("ts")
    return view


def test_zombie_lapsed_lease_writes_dropped_before_index():
    """``TestZombieFencing``: a pod paused past its TTL (the pause failpoint
    ages the lease) gets its post-resume batches dropped before the index;
    the index's digest of the pod stays the pre-pause truth."""
    def run(s):
        processor, index, pool, table = _zombie_stack(s)
        try:
            table.grant("pod-z")
            assert table.renew("pod-z") is True
            before = list(range(8))
            rks_before = processor.tokens_to_kv_block_keys(0, before, MODEL)
            pool.process_event_batch(_zbatch(s, before, [1, 2]), "pod-z", MODEL)
            assert index.lookup(rks_before) != {}
            rc = s.reconcile
            truth = rc.digest_from_blocks(rc.pod_blocks_from_state(index.dump_state(), "pod-z"))
            s.failpoints.arm(s.membership.FP_RENEW_PREFIX + "pod-z", mode="pause", pause_s=45.0)
            decisions = [table.renew("pod-z"), table.lease_valid("pod-z")]
            after = list(range(100, 108))
            rks_after = processor.tokens_to_kv_block_keys(0, after, MODEL)
            for _ in range(3):
                pool.process_event_batch(_zbatch(s, after, [7, 8]), "pod-z", MODEL)
            assert index.lookup(rks_after) == {}
            assert pool.data_plane_debug()["fenced_batches"] == 3 and table.rejections == 3
            digest = rc.digest_from_blocks(rc.pod_blocks_from_state(index.dump_state(), "pod-z"))
            assert digest == truth
            # A stale stamp from a pod with a valid lease is fenced too.
            table.grant("pod-y")
            table.observe_epoch(5, "ctl")
            pool.process_event_batch(_zbatch(s, after, [9], epoch=4), "pod-y", MODEL)
            pool.process_event_batch(_zbatch(s, after, [9], epoch=5), "pod-y", MODEL)
            return (decisions, pool.data_plane_debug(), state_of(index), _rejections(table),
                    digest)
        finally:
            pool.shutdown()
    out = both(run)
    assert out[1]["fenced_batches"] == 4 and out[3]["recent_rejections"][0]["reason"] == "lease_lapsed"


def test_zombie_readmission_requires_warm_restart_gate():
    def run(s):
        processor, index, pool, table = _zombie_stack(s)
        try:
            table.grant("pod-z")
            s.failpoints.arm(s.membership.FP_RENEW_PREFIX + "pod-z", mode="pause",
                             pause_s=60.0, times=1)
            steps = [table.renew("pod-z"), table.renew("pod-z")]

            class Gate:
                def __init__(self, ready):
                    self.ready = ready
            steps.append(table.readmit("pod-z", Gate(ready=False)))
            tokens = list(range(200, 208))
            rks = processor.tokens_to_kv_block_keys(0, tokens, MODEL)
            pool.process_event_batch(_zbatch(s, tokens, [11, 12]), "pod-z", MODEL)
            assert index.lookup(rks) == {}
            steps += [table.readmit("pod-z", Gate(ready=True)), table.lease_valid("pod-z")]
            pool.process_event_batch(_zbatch(s, tokens, [11, 12]), "pod-z", MODEL)
            assert index.lookup(rks) != {}
            return steps, pool.data_plane_debug(), state_of(index), _rejections(table)
        finally:
            pool.shutdown()
    assert both(run)[0] == [False, False, False, True, True]


# --------------------------------------------------------------------------
# the service with clusterConfig
# --------------------------------------------------------------------------

def _fleet_cfg(s, shard_id, fence="reject"):
    return s.IndexerConfig.from_dict({
        "tokenProcessorConfig": {"blockSize": BLOCK},
        "kvBlockIndexConfig": {"inMemoryConfig": {"size": 10_000}},
        "clusterConfig": {"shardAddresses": ["s0", "s1", "s2"], "shardId": shard_id,
                          "replicationFactor": 2, "fenceMode": fence},
    })


def test_service_stamps_and_fences_epochs_as_jax():
    """A replica built with ``clusterConfig``: its ``ShardFilterIndex``
    keeps the keys it owns of a broadcast stream, its membership fences
    the ingest, scores and both shard lookups, and every answer carries
    its epoch, as JAX's service does."""
    def run(s):
        svc = s.svc.IndexerService(_fleet_cfg(s, "s1"), s.pool.PoolConfig(concurrency=1))
        assert svc.shard_id == "s1" and svc.process_name == "s1"
        assert svc.pool.membership is svc.membership
        tokens = list(range(1, 41))
        keys = svc.indexer.token_processor.tokens_to_kv_block_keys(0, tokens, MODEL)
        for i, pod in enumerate(("pod-a", "pod-b")):
            svc.pool.process_event_batch(s.events.EventBatch(timestamp=0.0, events=[
                s.events.BlockStoredEvent(block_hashes=list(range(100 * i, 100 * i + 10)),
                                          tokens=tokens, parent_hash=0, block_size=BLOCK)]),
                pod, MODEL)
        owned = svc.indexer.kv_block_index.lookup(keys)
        assert 0 < len(owned) < len(keys)
        out = [state_of(svc.indexer.kv_block_index), svc.shard_index.debug_view(),
               svc.membership.debug_view()]
        svc.membership.observe_epoch(4, "ctl")
        for epoch in (0, 4, 3, 6):
            resp = svc.get_pod_scores(s.svc.ScoreRequest(tokens=tokens, model_name=MODEL,
                                                          epoch=epoch))
            d = dataclasses.asdict(resp)
            d.pop("traceparent")
            out.append(d)
        for epoch in (6, 5, 7):
            out.append(svc.lookup_blocks_rpc({"keys": keys[:6], "epoch": epoch}))
            out.append(svc.lookup_blocks_batch_rpc({"chunks": [keys[:4], keys[4:8]],
                                                    "epoch": epoch}))
        svc.pool.process_event_batch(s.events.EventBatch(timestamp=0.0, events=[
            s.events.BlockStoredEvent(block_hashes=[900], tokens=list(range(500, 504)),
                                      parent_hash=0, block_size=BLOCK)], epoch=2), "pod-c", MODEL)
        out += [svc.pool.fenced_batches, svc._epoch_stamp(), _rejections(svc.membership)]
        return out
    out = both(run)
    assert out[-3] == 1 and out[-2] == 7


def test_service_client_learns_the_served_epoch():
    """``IndexerServiceClient(membership=...)`` stamps its epoch and learns
    a newer one from the response (a fake channel stands in for grpc)."""
    def run(s):
        svc = s.svc.IndexerService(_fleet_cfg(s, "s0", fence="warn"), s.pool.PoolConfig(concurrency=1))
        svc.membership.observe_epoch(6, "ctl")
        client = s.svc.IndexerServiceClient.__new__(s.svc.IndexerServiceClient)
        sent = []

        def rpc(req, timeout=None, metadata=None):
            sent.append(req.epoch)
            return s.svc.ScoreResponse.from_bytes(svc.get_pod_scores(
                s.svc.ScoreRequest.from_bytes(req.to_bytes())).to_bytes())
        client.address, client._timeout = "fake", 1.0
        client.retry_policy = s.svc.DEFAULT_RPC_RETRY_POLICY
        client._get_pod_scores = rpc
        client.membership = s.membership.MembershipTable(epoch=2)
        client.score([1, 2, 3, 4, 5], MODEL)
        client.score([1, 2, 3, 4, 5], MODEL)
        return sent, client.membership.epoch
    assert both(run) == ([2, 6], 6)


def test_local_shard_clients_route_as_an_unsharded_indexer():
    """Three port replicas behind ``LocalShardClient``s (the frames a
    ``ShardClient`` puts on the wire, in-process): the router's scores
    equal an unsharded indexer's, on the batched and the per-chunk wire,
    and a failed replica is served by its replica owner."""
    s = SIDES["port"]
    shards = ["s0", "s1", "s2"]
    svcs = {sh: s.svc.IndexerService(_fleet_cfg(s, sh), s.pool.PoolConfig(concurrency=1))
            for sh in shards}
    control = s.svc.IndexerService(s.IndexerConfig.from_dict(
        {"tokenProcessorConfig": {"blockSize": BLOCK}}), s.pool.PoolConfig(concurrency=1))
    rng = random.Random(7)
    prompts = {pod: [rng.randrange(1, 5000) for _ in range(4 * n)] for pod, n in
               (("pod-a", 24), ("pod-b", 9))}
    for target in list(svcs.values()) + [control]:
        for i, (pod, tokens) in enumerate(prompts.items()):
            target.pool.process_event_batch(s.events.EventBatch(timestamp=0.0, events=[
                s.events.BlockStoredEvent(block_hashes=list(range(1000 * i, 1000 * i + len(tokens) // BLOCK)),
                                          tokens=tokens, parent_hash=0, block_size=BLOCK)]), pod, MODEL)
    query = prompts["pod-a"][:60] + prompts["pod-b"]
    want = control.indexer.score_tokens(prompts["pod-a"], MODEL)
    for batch in (8, 0):
        cfg = s.config.ClusterConfig(shard_addresses=shards, replication_factor=2,
                                     fanout_chunk_blocks=4, fanout_batch_chunks=batch)
        clients = {sh: s.remote.LocalShardClient(svcs[sh]) for sh in shards}
        router = s.cluster.ShardRouter(cfg, s.TokensConfig(block_size_tokens=BLOCK), clients=clients)
        try:
            res = router.score(prompts["pod-a"], MODEL)
            assert res.scores == want and not res.degraded
            assert router.score(query, MODEL).scores == control.indexer.score_tokens(query, MODEL)
            assert (router.batch_rpcs > 0) == (batch > 0)
            assert all(c.frames > 0 for c in clients.values())
            svcs["s1"].lookup_blocks_rpc = svcs["s1"].lookup_blocks_batch_rpc = _raise
            clients = {sh: s.remote.LocalShardClient(svcs[sh]) for sh in shards}
            router2 = s.cluster.ShardRouter(cfg, s.TokensConfig(block_size_tokens=BLOCK),
                                            clients=clients)
            res = router2.score(prompts["pod-a"], MODEL)
            assert res.scores == want and not res.degraded and res.degraded_shards == []
            router2.close()
            del svcs["s1"].lookup_blocks_rpc, svcs["s1"].lookup_blocks_batch_rpc
        finally:
            router.close()


def _raise(*_a, **_k):
    raise ConnectionError("replica down")


def test_metric_families_equal_jax():
    """The cluster plane's families keep JAX's names, help and labels."""
    names = ["SHARD_BATCH_RPCS", "SHARD_FANOUT_LATENCY", "SHARD_RPCS", "SHARD_DEGRADED_LOOKUPS",
             "SHARD_RING_PARTITIONS", "SHARD_PLAN_CACHE", "HEDGE_ATTEMPTS", "FENCE_REJECTIONS",
             "TOPOLOGY_EPOCH", "LEASE_ACTIVE", "LEASE_RENEWALS", "LEASE_EXPIRED",
             "LEASE_READMISSIONS"]
    for name in names:
        fams = [getattr(SIDES[p].collector, name) for p in PKGS]
        assert [(f._name, f._documentation, tuple(f._labelnames), type(f).__name__) for f in fams][0] \
            == [(f._name, f._documentation, tuple(f._labelnames), type(f).__name__) for f in fams][1]
    assert list(SIDES["port"].collector.SHARD_FANOUT_LATENCY._bounds) == list(
        SIDES["jax"].collector.SHARD_FANOUT_LATENCY._upper_bounds[:-1])


def test_remote_digest_source_over_local_clients_equals_jax():
    """``RemoteShardDigestSource`` over two replicas' ``LocalShardClient``s
    (ListPods, GetPodBlocks through the shard surface's frames) merges and
    digests what JAX's class merges over the same peers; a dead peer is
    skipped by both."""
    s = SIDES["port"]
    shards = ["s0", "s1", "s2"]
    svcs = {sh: s.svc.IndexerService(_fleet_cfg(s, sh), s.pool.PoolConfig(concurrency=1))
            for sh in shards}
    tokens = list(range(1, 65))
    for svc in svcs.values():
        for i, pod in enumerate(("pod-a", "pod-b")):
            svc.pool.process_event_batch(s.events.EventBatch(timestamp=0.0, events=[
                s.events.BlockStoredEvent(block_hashes=list(range(100 * i, 100 * i + 16)),
                                          tokens=tokens[:4 * (16 - 4 * i)], parent_hash=0,
                                          block_size=BLOCK)]), pod, MODEL)
    peers = [s.remote.LocalShardClient(svcs[sh]) for sh in ("s1", "s2")]
    svcs["s2"].pod_blocks_rpc = _raise
    dead = s.remote.LocalShardClient(svcs["s2"])
    ring = s.ring.HashRing(shards)
    out = []
    for side in PKGS:
        src = SIDES[side].remote.RemoteShardDigestSource(peers + [dead], ring, "s0")
        out.append((src.pods(), {p: src.blocks(p) for p in src.pods()},
                    {p: src.digest(p) for p in src.pods()}))
    assert out[0] == out[1]
    assert out[0][0] == ["pod-a", "pod-b"] and all(out[0][1].values())
