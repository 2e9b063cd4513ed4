"""The port's native index plane against the JAX package's.

Both packages bind the one ``csrc/kvindex`` source: the JAX package builds
it beside the source (its ``make``), the port into ``build/kvindex/<hash>``
at first use. Held here, on numpy-seeded inputs, with exact equality for
keys, entries and block counts and ``abs <= 1e-12`` for float scores:

- the native hash chain against JAX's ``hash_chain`` and both packages'
  Python chains (block sizes, CBOR head boundaries, a partial tail,
  multimodal taint, ``hash_calls``);
- ``NativeIndex`` lookups, fused ``score`` and ``score_chunked`` (chunk
  sizes, a chain hole, residency claims, the tier discount, buffer
  growth) against the Python scorer and against JAX's ``NativeIndex`` fed
  the same adds;
- the array add and the event pool's packed (KZC1) path over it;
- the build: beside the checkout, one library for concurrent first uses,
  and a missing compiler raising with no fall back to the Python index.
"""

import os
import threading

import numpy as np
import pytest

from llmd_kv_cache_tpu.core import BlockExtraFeatures as JaxFeatures
from llmd_kv_cache_tpu.core import ChunkedTokenDatabase as JaxTokens
from llmd_kv_cache_tpu.core import KeyType as JaxKeyType
from llmd_kv_cache_tpu.core import PodEntry as JaxPodEntry
from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokensConfig
from llmd_kv_cache_tpu.index import native as jax_native
from llmd_kv_cache_tpu.scoring.residency import ResidencyTracker as JaxTracker
from llmd_kv_cache_tpu.scoring.scorer import LongestPrefixScorer as JaxScorer

from llmd_kv_cache_tpu_torch.core.extra_keys import BlockExtraFeatures
from llmd_kv_cache_tpu_torch.core.keys import KeyType, PodEntry
from llmd_kv_cache_tpu_torch.core.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llmd_kv_cache_tpu_torch.events import Pool, PoolConfig, RawMessage
from llmd_kv_cache_tpu_torch.events.packed import encode_packed_batch
from llmd_kv_cache_tpu_torch.events.publisher import encode_batch
from llmd_kv_cache_tpu_torch.events.model import BlockStoredEvent
from llmd_kv_cache_tpu_torch.index import native
from llmd_kv_cache_tpu_torch.index.base import create_index
from llmd_kv_cache_tpu_torch.index.in_memory import InMemoryIndex
from llmd_kv_cache_tpu_torch.index.native import NativeIndex, NativeIndexConfig
from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer
from llmd_kv_cache_tpu_torch.scoring.residency import ResidencyTracker
from llmd_kv_cache_tpu_torch.scoring.scorer import LongestPrefixScorer

from torch_telemetry_helpers import (
    private_flight_recorders,
    private_jax_metrics,
    private_port_metrics,
)

WEIGHTS = {"tpu-hbm": 1.0, "cpu": 0.8, "shared_storage": 0.5}
TIERS = list(WEIGHTS) + ["weird-tier"]


@pytest.fixture(autouse=True)
def _private_globals(monkeypatch):
    """Both packages' metric families and flight recorders of the test's
    own: the indexers record score latencies and decisions, which the JAX
    fleet tests later in the worker would otherwise read."""
    private_jax_metrics(monkeypatch)
    private_port_metrics(monkeypatch)
    with private_flight_recorders():
        yield


def tokens_pair(block_size, seed="s", **kw):
    """(port native, port Python, JAX native, JAX Python) processors."""
    port = [ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=block_size,
                                                      hash_seed=seed, **kw), use_native=n)
            for n in (True, False)]
    ref = [JaxTokens(JaxTokensConfig(block_size_tokens=block_size, hash_seed=seed, **kw),
                     use_native=n) for n in (True, False)]
    assert port[0]._native is native and ref[0]._native is not None
    return port + ref


# --------------------------------------------------------------------------
# the hash chain
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", ["", "42", "some-seed"])
@pytest.mark.parametrize("model", ["m", "meta-llama/Llama-3.1-8B"])
def test_init_hash_matches_jax_and_python(seed, model):
    got = native.hash_init(seed, model)
    assert got == jax_native.hash_init(seed, model)
    for tp in tokens_pair(16, seed):
        assert tp._get_init_hash(model) == got


@pytest.mark.parametrize("block_size", [1, 4, 16, 64])
def test_chain_matches_jax_and_python_chains(block_size):
    rng = np.random.default_rng(7 + block_size)
    tokens = rng.integers(0, 2**32 - 1, 256 + 3).tolist()  # a partial tail
    procs = tokens_pair(block_size, prefix_cache_tokens=0)
    for parent in (0, 12345, 2**64 - 1):
        keys = [tp.tokens_to_kv_block_keys(parent, tokens, "m") for tp in procs]
        assert all(k == keys[0] for k in keys[1:]), parent
        assert len(keys[0]) == len(tokens) // block_size
    root = procs[0]._get_init_hash("m")
    got, arr = native.hash_chain_with_array(root, np.asarray(tokens, np.uint32), block_size)
    assert got == jax_native.hash_chain(root, tokens, block_size)
    assert got == procs[1].tokens_to_kv_block_keys(0, tokens, "m")
    assert arr.dtype == np.uint64 and arr.tolist() == got


def test_boundary_token_values():
    """CBOR heads widen at 24, 2^8, 2^16 and 2^32."""
    tokens = [0, 23, 24, 255, 256, 65535, 65536, 2**32 - 1] * 3
    procs = tokens_pair(8, prefix_cache_tokens=0)
    keys = [tp.tokens_to_kv_block_keys(0, tokens, "m") for tp in procs]
    assert len(keys[0]) == 3 and all(k == keys[0] for k in keys)


def test_mm_taint_stays_on_the_python_encoder():
    procs = tokens_pair(4)
    tokens = list(range(12))
    feats = [None, ["h1"], ["h2", "h3"]]
    port_f = [None if f is None else BlockExtraFeatures(mm_hashes=f) for f in feats]
    jax_f = [None if f is None else JaxFeatures(mm_hashes=f) for f in feats]
    keys = [tp.tokens_to_kv_block_keys(0, tokens, "m", port_f if i < 2 else jax_f)
            for i, tp in enumerate(procs)]
    assert all(k == keys[0] for k in keys)
    assert keys[0] != procs[0].tokens_to_kv_block_keys(0, tokens, "m")
    with pytest.raises(ValueError, match="does not match"):
        procs[0].tokens_to_kv_block_keys(0, list(range(8)), "m", [None])


def test_hash_calls_and_prefix_cache_count_as_jax():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 50000, 96).tolist()
    calls = [base, base, base + rng.integers(0, 50000, 40).tolist(), base[:50], base[:7]]
    port, _, ref, _ = tokens_pair(16)
    for toks in calls:
        got = port.tokens_to_kv_block_keys_with_array(0, toks, "m")
        want = ref.tokens_to_kv_block_keys_with_array(0, toks, "m")
        assert got[0] == want[0]
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            assert got[1].tolist() == want[1].tolist() == got[0]
        assert port.hash_calls == ref.hash_calls
    assert port.prefix_cache_stats() == ref.prefix_cache_stats()


# --------------------------------------------------------------------------
# NativeIndex against the Python scorer and JAX's NativeIndex
# --------------------------------------------------------------------------

def populated(seed, n_keys=48, n_pods=5, hole=None):
    """The same seeded adds into the port's and JAX's native index."""
    rng = np.random.default_rng(seed)
    ours = NativeIndex(NativeIndexConfig(size=10_000))
    ref = jax_native.NativeIndex(jax_native.NativeIndexConfig(size=10_000))
    keys = [int(k) for k in rng.integers(1, 2**63, n_keys, dtype=np.int64)]
    for p in range(n_pods):
        prefix_len = int(rng.integers(0, n_keys + 1))
        for k in keys[:prefix_len]:
            tier = TIERS[int(rng.integers(0, len(TIERS)))]
            ours.add([k], [k], [PodEntry(f"pod-{p}", tier)])
            ref.add([k], [k], [JaxPodEntry(f"pod-{p}", tier)])
    if hole is not None:
        ours.evict(keys[hole], KeyType.ENGINE, [PodEntry("pod-0", "tpu-hbm")])
        ref.evict(keys[hole], JaxKeyType.ENGINE, [JaxPodEntry("pod-0", "tpu-hbm")])
    return ours, ref, keys


def as_rows(result):
    return {k: [(e.pod_identifier, e.device_tier, e.speculative, e.has_group, e.group_idx)
                for e in es] for k, es in result.items()}


def close(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-12 for k in a)


@pytest.mark.parametrize("seed,hole", [(3, None), (5, 7), (11, 0)])
def test_lookup_and_fused_score_match_python_scorer_and_jax(seed, hole):
    ours, ref, keys = populated(seed, hole=hole)
    scorer = LongestPrefixScorer(WEIGHTS)
    for filt in (None, {"pod-1", "pod-3"}, {"nope"}):
        found = ours.lookup(keys, filt)
        assert as_rows(found) == as_rows(ref.lookup(keys, filt))
        fused, hits = ours.score(keys, WEIGHTS, filt)
        ref_fused, ref_hits = ref.score(keys, WEIGHTS, filt)
        assert close(fused, scorer.score(keys, found)) and close(fused, ref_fused)
        assert hits == ref_hits == len(ours.lookup(keys))
        early, _ = ours.score(keys, WEIGHTS, filt, early_exit=True)
        assert close(early, fused)
    assert len(ours) == len(ref)


@pytest.mark.parametrize("chunk_size", [0, 1, 4, 16, 64])
def test_score_chunked_matches_python_scorer_and_jax(chunk_size):
    ours, ref, keys = populated(11, hole=9)
    scorer = LongestPrefixScorer(WEIGHTS)
    for filt in (None, {"pod-1", "pod-3"}, {"nope"}):
        got = ours.score_chunked(keys, WEIGHTS, filt, chunk_size=chunk_size)
        want = ref.score_chunked(keys, WEIGHTS, filt, chunk_size=chunk_size)
        assert close(got[0], scorer.score(keys, ours.lookup(keys, filt)))
        assert close(got[0], want[0]) and got[1:] == want[1:]
        assert got[2] == {}
        if chunk_size > 0:
            assert got[3]["chunks"] >= 1


def test_score_chunked_residency_and_tier_discount_match_trackers_and_jax():
    ours, ref, keys = populated(9)
    trackers = (ResidencyTracker(landed_weight=1.0, in_flight_discount=0.5),
                JaxTracker(landed_weight=1.0, in_flight_discount=0.5))
    for t in trackers:
        t.on_landed("decode-0", keys[:7])
        t.on_transfer_started("decode-1", keys[:12])
        t.on_landed("decode-1", keys[:3])
        t.on_landed("decode-2", keys[1:5])  # no run from 0
    for filt in (None, {"decode-0", "pod-1"}):
        for discount in (1.0, 0.5, 0.125):
            claims = trackers[0].claim_rows(keys, filt)
            assert claims == trackers[1].claim_rows(keys, filt)
            got = ours.score_chunked(keys, WEIGHTS, filt, chunk_size=8, claims=claims,
                                     landed_weight=1.0, in_flight_discount=0.5,
                                     tier_discount=discount)
            want = ref.score_chunked(keys, WEIGHTS, filt, chunk_size=8, claims=claims,
                                     landed_weight=1.0, in_flight_discount=0.5,
                                     tier_discount=discount)
            bonus = {p: b * discount for p, b in trackers[0].bonus(keys, filt).items()}
            assert close(got[2], bonus) and close(got[2], want[2])
            assert close(got[0], JaxScorer(WEIGHTS).score(keys, ref.lookup(keys, filt)))
            assert close(got[0], want[0]) and got[1] == want[1] and got[3] == want[3]


def test_early_exit_stops_at_the_chunk_boundary():
    ours = NativeIndex(NativeIndexConfig(size=10_000))
    keys = list(range(1, 33))
    for k in keys:
        ours.add([k], [k], [PodEntry("p", "tpu-hbm")])
    ours.evict(11, KeyType.ENGINE, [PodEntry("p", "tpu-hbm")])
    scores, hits, _, stats = ours.score_chunked(keys, {"tpu-hbm": 1.0}, chunk_size=8)
    assert scores == {"p": 10.0} and hits == 15
    assert stats == {"chunks": 2, "early_exited": 1}


def test_buffer_overflow_retries_and_lookup_growth():
    ours = NativeIndex(NativeIndexConfig(size=100_000, pod_cache_size=3000))
    ours.add([1], [1], [PodEntry(f"pod-{i}", "tpu-hbm") for i in range(2000)])
    scores, hits = ours.score([1], {"tpu-hbm": 1.0})
    assert len(scores) == 2000 and hits == 1 and set(scores.values()) == {1.0}
    chunked = ours.score_chunked([1], {"tpu-hbm": 1.0}, chunk_size=4)
    assert chunked[0] == scores and chunked[1] == 1
    small = NativeIndex(NativeIndexConfig(size=100_000))
    small._lookup_cap = 2  # force growth
    keys = list(range(1, 200))
    small.add(keys, keys, [PodEntry("p", "tpu-hbm")])
    assert len(small.lookup(keys)) == len(keys)
    assert ours.score_chunked([], WEIGHTS) == ({}, 0, {}, {"chunks": 0, "early_exited": 0})


def test_pod_cache_bound_outer_lru_and_entry_identity():
    ours = NativeIndex(NativeIndexConfig(size=4, pod_cache_size=2))
    ref = jax_native.NativeIndex(jax_native.NativeIndexConfig(size=4, pod_cache_size=2))
    ours.add([1], [1], [PodEntry(f"p{i}", "tpu-hbm") for i in range(3)])
    ref.add([1], [1], [JaxPodEntry(f"p{i}", "tpu-hbm") for i in range(3)])
    for i in range(2, 10):
        ours.add([i], [i], [PodEntry("p", "cpu", speculative=i % 2 == 0,
                                     has_group=i % 3 == 0, group_idx=i % 3)])
        ref.add([i], [i], [JaxPodEntry("p", "cpu", speculative=i % 2 == 0,
                                       has_group=i % 3 == 0, group_idx=i % 3)])
    keys = list(range(1, 10))
    assert as_rows(ours.lookup(keys)) == as_rows(ref.lookup(keys))
    assert len(ours) == len(ref) == 4
    first, second = ours.lookup([9]), ours.lookup([9])
    assert first[9][0] is second[9][0]  # memoised PodEntry


def test_array_add_equals_list_add():
    assert NativeIndex.accepts_key_arrays is True
    entries = [PodEntry("pod-z", "tpu-hbm")]
    eks, rks = [101, 102, 103], [11, 12, 13]
    via_list, via_arr = NativeIndex(), NativeIndex()
    via_list.add(eks, rks, entries)
    via_arr.add(np.asarray(eks, np.uint64), np.asarray(rks, np.uint64), entries)
    assert as_rows(via_arr.lookup(rks)) == as_rows(via_list.lookup(rks))
    assert [via_arr.get_request_key(e) for e in eks] == [via_list.get_request_key(e) for e in eks]
    with pytest.raises(ValueError):
        via_arr.add(None, np.empty(0, np.uint64), entries)


def test_packed_frames_take_the_array_add_and_match_the_msgpack_wire():
    """KZC1 frames through the native chain and the array add leave the
    native index equal to a control fed the same stores over msgpack."""
    rng = np.random.default_rng(21)
    tp = ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=4))
    packed_idx, wire_idx = NativeIndex(), InMemoryIndex()
    pools = [Pool(PoolConfig(concurrency=1), idx, tp) for idx in (packed_idx, wire_idx)]
    parent = 0
    for i in range(6):
        tokens = rng.integers(0, 2**32 - 1, 12).tolist()
        eks = [int(k) for k in rng.integers(1, 2**63, 3, dtype=np.int64)]
        pools[0]._process_raw_batch([RawMessage(f"kv@pod-{i % 2}@m", i, encode_packed_batch(
            f"pod-{i % 2}", "m", eks, tokens, parent_hash=parent, timestamp=0.0,
            block_size=4))])
        pools[1]._process_raw_batch([RawMessage(f"kv@pod-{i % 2}@m", i, encode_batch(
            [BlockStoredEvent(block_hashes=eks, tokens=tokens, block_size=4,
                              parent_hash=parent)], 0.0))])
        parent = eks[-1] if i % 3 else 0
    assert pools[0].array_adds == 6 and pools[1].array_adds == 0
    dumps = [idx.dump_state() for idx in (packed_idx, wire_idx)]
    assert {k: rows for k, rows in dumps[0]["entries"]} == \
        {k: rows for k, rows in dumps[1]["entries"]}
    assert {k: v for k, v in dumps[0]["mappings"]} == {k: v for k, v in dumps[1]["mappings"]}


# --------------------------------------------------------------------------
# the build
# --------------------------------------------------------------------------

def test_library_builds_beside_the_checkout_not_in_csrc():
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parent.name == "build" and native.CSRC.name == "kvindex"
    assert lib.name == "libkvindex.so" and lib.exists()
    assert native.build() == lib  # keyed by a hash: built once


def test_concurrent_first_uses_yield_one_library(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    paths, errors = [], []

    def first_use():
        try:
            paths.append(native.build())
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(paths) == 2 and paths[0] == paths[1]
    built = [os.path.relpath(os.path.join(d, f), tmp_path)
             for d, _, files in os.walk(tmp_path) for f in files]
    assert built == [os.path.relpath(paths[0], tmp_path)]


def test_missing_compiler_raises_with_no_python_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the compiler"):
        create_index(None)
    for make in (Indexer, lambda: ChunkedTokenDatabase(TokenProcessorConfig())):
        with pytest.raises(RuntimeError, match="building kvindex failed"):
            make()
    assert native.native_available() is False and native._load_failed
    assert list(tmp_path.rglob("*.so")) == []
