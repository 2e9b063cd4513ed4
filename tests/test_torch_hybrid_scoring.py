"""Window-aware routing in the port, against the JAX package.

``HybridAwareScorer`` and ``create_scorer``'s ``HybridAware`` strategy are
held against the JAX scorer on every case of ``tests/test_hybrid_scoring.py``
and on random presence maps over cataloged and uncataloged groups (scores
equal). ``Indexer.attach_group_catalog`` wires a ``Pool``'s catalog into the
scorer: each package's hybrid engine feeds its own Pool and Indexer, and the
scores of one event stream are equal. At the shapes of ``chip_smoke.py``'s
hybrid pods (page 16, window 1024, chunks of 2048, a 4160-token prompt) the
stream's score is derived here: a prompt continuing the served one scores
the window, 64 blocks, and one that shares only its 4096-token prefix
scores nothing, since the pod cannot resume there (it admits it with
``cached_len`` 0), where the longest-prefix rule would give 256.
"""

import importlib
import itertools

import numpy as np
import pytest

from llmd_kv_cache_tpu.core import GroupCatalog as JaxCatalog
from llmd_kv_cache_tpu.core import GroupMetadata as JaxMeta
from llmd_kv_cache_tpu.core import PodEntry as JaxEntry
from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTPC
from llmd_kv_cache_tpu.events.model import EventBatch as JaxBatch
from llmd_kv_cache_tpu.events.pool import Pool as JaxPool
from llmd_kv_cache_tpu.events.pool import PoolConfig
from llmd_kv_cache_tpu.scoring import Indexer as JaxIndexer
from llmd_kv_cache_tpu.scoring import IndexerConfig as JaxIndexerConfig
from llmd_kv_cache_tpu.scoring import scorer as jax_scorer
from llmd_kv_cache_tpu.scoring.scorer import KVBlockScorerConfig as JaxScorerConfig
from llmd_kv_cache_tpu_torch.core.hma import GroupCatalog, GroupMetadata
from llmd_kv_cache_tpu_torch.core.keys import PodEntry
from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
from llmd_kv_cache_tpu_torch.events.model import EventBatch
from llmd_kv_cache_tpu_torch.events.pool import Pool
from llmd_kv_cache_tpu_torch.events.pool import PoolConfig as PortPoolConfig
from llmd_kv_cache_tpu_torch.scoring import scorer
from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig

from tests.test_torch_swa import TINY, Pair

BLOCK = 4


class _Unrecorded:
    def observe(self, *args, **kwargs):
        pass


@pytest.fixture(autouse=True)
def jax_score_latency(monkeypatch):
    """The JAX indexers' score latencies go nowhere, not into the JAX
    package's process-wide histogram: a fleet test later in the same
    process reads it against a 0.1 s score-latency objective, and these
    tests score 4224-token prompts."""
    collector = importlib.import_module("llmd_kv_cache_tpu.metrics.collector")
    monkeypatch.setattr(collector, "bucket_histogram", lambda *args, **kwargs: _Unrecorded())


WEIGHTS = {"tpu-hbm": 1.0, "cpu": 0.8, "shared_storage": 0.5}

# The cases of tests/test_hybrid_scoring.py: (catalog entries (pod, group,
# kind, window)), key -> [(pod, tier, group or None)], keys, JAX's expected
# scores.
SWA = ("sliding_window", 8)
CASES = {
    "full-unchanged": ((), {1: [("a", None)], 2: [("a", None)]}, [1, 2, 3], {"a": 2.0}),
    "swa-missing-early": ((("s", 0, *SWA),), {3: [("s", 0)], 4: [("s", 0)]}, [1, 2, 3, 4],
                          {"s": 2.0}),
    "swa-capped": ((("s", 0, *SWA),), {k: [("s", 0)] for k in (1, 2, 3, 4)}, [1, 2, 3, 4],
                   {"s": 2.0}),
    "swa-hole": ((("s", 0, *SWA),), {2: [("s", 0)], 3: [("s", 0)]}, [1, 2, 3, 4], {"s": 2.0}),
    "swa-isolated": ((("s", 0, *SWA),), {1: [("s", 0)], 3: [("s", 0)]}, [1, 2, 3, 4],
                     {"s": 1.0}),
    "swa-orphan": ((("s", 0, *SWA),), {3: [("s", 0)]}, [1, 2, 3, 4], {}),
    "mixed-fleet": ((("s", 0, *SWA),), {1: [("f", None)], 2: [("f", None)], 3: [("s", 0)],
                                        4: [("s", 0)]}, [1, 2, 3, 4], {"f": 2.0, "s": 2.0}),
    "hybrid-conservative": ((("h", 0, "full_attention", None), ("h", 1, *SWA)),
                            {1: [("h", 0)], 2: [("h", 0)], 3: [("h", 1)], 4: [("h", 1)]},
                            [1, 2, 3, 4], {"h": 2.0}),
    "hybrid-full-gap": ((("h", 0, "full_attention", None), ("h", 1, *SWA)),
                        {3: [("h", 1)], 4: [("h", 1)]}, [1, 2, 3, 4], {}),
    "uncataloged-tagged": ((), {1: [("s", 0)], 2: [("s", 0)]}, [1, 2, 3], {"s": 2.0}),
    "orphan-group-tag": ((("h", 0, "full_attention", None),),
                         {1: [("h", 0)], 2: [("h", 0)], 3: [("h", 7)]}, [1, 2, 3],
                         {"h": 3.0}),
    "sink-full-is-prefix": ((("k", 0, "sink_full_attention", 8),),
                            {3: [("k", 0)], 4: [("k", 0)]}, [1, 2, 3, 4], {}),
    "untagged-tier-update": ((("h", 0, "full_attention", None), ("h", 1, *SWA)),
                             {1: [("h", None)], 2: [("h", 0)], 3: [("h", 1)],
                              4: [("h", 1)]}, [1, 2, 3, 4], {"h": 2.0}),
}


def build(entries, key_to_pods, tier="tpu-hbm"):
    """The same case as (port catalog, port map), (JAX catalog, JAX map)."""
    port_cat, jax_cat = GroupCatalog(), JaxCatalog()
    for pod, group, kind, window in entries:
        port_cat.learn(pod, group, GroupMetadata(kind, BLOCK, window))
        jax_cat.learn(pod, group, JaxMeta(kind, BLOCK, window))

    def entry(cls, pod, group, t):
        return (cls(pod, t) if group is None
                else cls(pod, t, has_group=True, group_idx=group))

    port_map = {k: [entry(PodEntry, *e, tier) if len(e) == 2 else entry(PodEntry, *e)
                    for e in v] for k, v in key_to_pods.items()}
    jax_map = {k: [entry(JaxEntry, *e, tier) if len(e) == 2 else entry(JaxEntry, *e)
                   for e in v] for k, v in key_to_pods.items()}
    return (port_cat, port_map), (jax_cat, jax_map)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES)
@pytest.mark.parametrize("tier", ["tpu-hbm", "cpu"])
def test_scores_equal_jax_on_its_cases(case, tier):
    entries, key_to_pods, keys, expected = case
    (pc, pm), (jc, jm) = build(entries, key_to_pods, tier)
    got = scorer.HybridAwareScorer(WEIGHTS, pc, block_size_tokens=BLOCK).score(keys, pm)
    want = jax_scorer.HybridAwareScorer(WEIGHTS, jc, block_size_tokens=BLOCK).score(keys, jm)
    assert got == want
    w = WEIGHTS[tier]
    assert got == {p: s * w for p, s in expected.items()}


@pytest.mark.parametrize("seed", range(6))
def test_scores_equal_jax_on_random_presence(seed):
    """Random residency over four pods: full, SWA (windows of 1-3 blocks),
    hybrid and uncataloged, entries in three tiers, some untagged."""
    rng = np.random.default_rng(seed)
    n = 12
    keys = list(range(100, 100 + n))
    entries = [("full", 0, "full_attention", None),
               ("swa", 0, "sliding_window", int(rng.integers(1, 13))),
               ("hyb", 0, "full_attention", None),
               ("hyb", 1, "sliding_window", int(rng.integers(1, 13)))]
    key_to_pods = {}
    for k in keys:
        for pod, groups in (("full", (0,)), ("swa", (0,)), ("hyb", (0, 1)),
                            ("anon", (0, 3))):
            for g in groups:
                if rng.random() < 0.7:
                    tier = ["tpu-hbm", "cpu", "shared_storage"][int(rng.integers(3))]
                    group = None if rng.random() < 0.15 else g
                    key_to_pods.setdefault(k, []).append((pod, group, tier))
    (pc, pm), (jc, jm) = build(entries, key_to_pods)
    got = scorer.HybridAwareScorer(WEIGHTS, pc, block_size_tokens=BLOCK).score(keys, pm)
    want = jax_scorer.HybridAwareScorer(WEIGHTS, jc, block_size_tokens=BLOCK).score(keys, jm)
    assert got == want


def test_window_value_is_jaxs_on_every_mask():
    port = scorer.HybridAwareScorer(WEIGHTS, GroupCatalog(), block_size_tokens=BLOCK)
    ref = jax_scorer.HybridAwareScorer(WEIGHTS, JaxCatalog(), block_size_tokens=BLOCK)
    for n in (1, 3, 6):
        for wb in (1, 2, 4):
            for mask in itertools.product([0, 1], repeat=n):
                blocks = {i: 1.0 + 0.1 * i for i, m in enumerate(mask) if m}
                assert port._window_value(blocks, n, wb) == ref._window_value(blocks, n, wb)


def test_create_scorer_strategies():
    cfg = scorer.KVBlockScorerConfig(scoring_strategy=scorer.HYBRID_AWARE)
    s = scorer.create_scorer(cfg, block_size_tokens=16)
    assert isinstance(s, scorer.HybridAwareScorer)
    assert (s.strategy, s.block_size_tokens, s.group_catalog) == ("HybridAware", 16, None)
    # With no catalog it scores as the longest-prefix rule.
    pm = {1: [PodEntry("a", "gpu")], 2: [PodEntry("a", "cpu")]}
    assert s.score([1, 2, 3], pm) == {"a": 1.8}
    assert type(scorer.create_scorer()) is scorer.LongestPrefixScorer
    with pytest.raises(ValueError, match="unsupported scoring strategy"):
        scorer.create_scorer(scorer.KVBlockScorerConfig(scoring_strategy="Nope"))


def indexers(block):
    port = Indexer(IndexerConfig(
        token_processor_config=TokenProcessorConfig(block_size_tokens=block),
        scorer_config=scorer.KVBlockScorerConfig(scoring_strategy=scorer.HYBRID_AWARE)))
    port_pool = Pool(PortPoolConfig(concurrency=1), port.kv_block_index, port.token_processor)
    port.attach_group_catalog(port_pool.group_catalog)
    ref = JaxIndexer(JaxIndexerConfig(
        token_processor_config=JaxTPC(block_size_tokens=block),
        scorer_config=JaxScorerConfig(scoring_strategy="HybridAware")))
    ref_pool = JaxPool(PoolConfig(concurrency=1), ref.kv_block_index, ref.token_processor)
    ref.attach_group_catalog(ref_pool.group_catalog)
    assert port.scorer.block_size_tokens == block
    return (port, port_pool), (ref, ref_pool)


def feed(pair, pod, model_name, pools):
    """Route each engine's event batches into its package's pool."""
    (port, port_pool), (ref, ref_pool) = pools
    for batch in pair.batches:
        port_pool.process_event_batch(EventBatch(timestamp=0.0, events=batch), pod,
                                      model_name)
    for batch in pair.jax_batches:
        ref_pool.process_event_batch(JaxBatch(timestamp=0.0, events=batch), pod, model_name)


def test_engine_event_streams_score_as_jax():
    """A hybrid pod, a uniform-SWA pod, a sink pod and a full-attention pod
    (each a JAX/port engine pair) serve prompts over one prefix; each
    package's indexer scores the same queries the same, and the hybrid
    pod's groups are both cataloged."""
    pools = indexers(TINY["page_size"])
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 256, 20).tolist()
    served = prefix + rng.integers(1, 256, 8).tolist()
    layouts = {"pod-h": dict(TINY, sliding_window=8, swa_layers=(1,)),
               "pod-w": "swa", "pod-s": "sinks", "pod-f": "tiny"}
    for pod, layout in layouts.items():
        pair = Pair(layout, num_pages=64, num_swa_pages=32, pod_identifier=pod,
                    max_prefill_tokens=8, model_name="m")
        jr, tr = pair.both("add_request", "a", served, max_new_tokens=3)
        pair.run([(jr, tr)])
        feed(pair, pod, "m", pools)
    (port, port_pool), (ref, ref_pool) = pools
    assert set(port_pool.group_catalog.groups("pod-h")) == {0, 1}
    for query in (served + [1, 2, 3, 4], prefix + [9, 9, 9, 9], served[:12], served):
        got = port.score_tokens(query, "m")
        assert got == ref.score_tokens(query, "m")
        assert got
    # The hybrid pod: the continued prompt scores the window (2 blocks);
    # the prefix alone would need blocks the pod reclaimed.
    assert port.score_tokens(served + [1, 2, 3, 4], "m")["pod-h"] == 2.0
    assert "pod-h" not in port.score_tokens(prefix + [9, 9, 9, 9], "m")


def test_phase13_stream_score():
    """chip_smoke.py's hybrid pods at their paging shapes (a two-layer
    model with one SWA layer: paging does not depend on the widths): page
    16, window 1024, chunks of 2048; a cold 4160-token prompt C. Then a
    prompt continuing C by 64 tokens scores the 64-block window, on both
    packages, and the pod resumes it at 4160; a prompt sharing only C's
    4096-token prefix scores nothing and is admitted cold."""
    layout = dict(TINY, vocab_size=32000, page_size=16, sliding_window=1024, swa_layers=(0,))
    pools = indexers(16)
    pair = Pair(layout, num_pages=300, num_swa_pages=200, max_pages_per_seq=272,
                max_prefill_tokens=2048, pod_identifier="pod-h", model_name="m")
    rng = np.random.default_rng(13)
    prefix = rng.integers(1, 32000, 4096).tolist()
    cold = prefix + rng.integers(1, 32000, 64).tolist()
    jr, tr = pair.both("add_request", "C", cold, max_new_tokens=1)
    pair.run([(jr, tr)])
    feed(pair, "pod-h", "m", pools)
    (port, _), (ref, _) = pools
    cont = cold + rng.integers(1, 32000, 64).tolist()
    other = prefix + rng.integers(1, 32000, 64).tolist()
    assert port.score_tokens(cont, "m") == ref.score_tokens(cont, "m") == {"pod-h": 64.0}
    assert port.score_tokens(other, "m") == ref.score_tokens(other, "m") == {}
    stored1 = [h for b in pair.batches for e in b
               if type(e).__name__ == "BlockStoredEvent" and e.group_idx == 1
               for h in e.block_hashes]
    assert len(stored1) == 64
    for prompt, cached in ((cont, 4160), (other, 0)):
        jr, tr = pair.both("add_request", f"q{cached}", prompt, max_new_tokens=1)
        assert tr.cached_len == jr.cached_len == cached
        pair.run([(jr, tr)])
