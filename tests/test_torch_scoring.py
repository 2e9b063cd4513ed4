"""The port's event ingestion and scoring against the JAX package.

The same KV events — from real engines, and synthetic ones covering
LoRA namespaces, device tiers, multimodal extra keys, tokenless tier
updates, removals and pod-wide clears — go through the port's
``Pool.process_event_batch`` + ``Indexer.score_tokens`` and the JAX
``Pool`` + ``Indexer``; the scores must be equal.
"""

import numpy as np
import pytest

from llmd_kv_cache_tpu.core import TokenProcessorConfig as JaxTokenProcessorConfig
from llmd_kv_cache_tpu.core.extra_keys import BlockExtraFeatures as JaxFeatures
from llmd_kv_cache_tpu.events import model as jax_model
from llmd_kv_cache_tpu.events.pool import Pool as JaxPool
from llmd_kv_cache_tpu.events.pool import PoolConfig as JaxPoolConfig
from llmd_kv_cache_tpu.index import InMemoryIndex as JaxInMemoryIndex
from llmd_kv_cache_tpu.scoring import Indexer as JaxIndexer
from llmd_kv_cache_tpu.scoring import IndexerConfig as JaxIndexerConfig
from llmd_kv_cache_tpu_torch.core.extra_keys import BlockExtraFeatures
from llmd_kv_cache_tpu_torch.core.keys import KeyType, PodEntry
from llmd_kv_cache_tpu_torch.core.token_processor import TokenProcessorConfig
from llmd_kv_cache_tpu_torch.events import model
from llmd_kv_cache_tpu_torch.events.pool import Pool, PoolConfig, realign_extra_features
from llmd_kv_cache_tpu_torch.index.base import infer_engine_mappings
from llmd_kv_cache_tpu_torch.index.in_memory import InMemoryIndex
from llmd_kv_cache_tpu_torch.scoring.indexer import Indexer, IndexerConfig
from llmd_kv_cache_tpu_torch.scoring.scorer import KVBlockScorerConfig, create_scorer

BLOCK = 4
MODEL = "tiny"


class Stacks:
    """The JAX and port event-ingestion + scoring stacks side by side."""

    def __init__(self):
        self.jax_indexer = JaxIndexer(
            JaxIndexerConfig(token_processor_config=JaxTokenProcessorConfig(
                block_size_tokens=BLOCK)),
            index=JaxInMemoryIndex())
        self.jax_pool = JaxPool(JaxPoolConfig(concurrency=1),
                                self.jax_indexer.kv_block_index,
                                self.jax_indexer.token_processor)
        self.indexer = Indexer(IndexerConfig(
            token_processor_config=TokenProcessorConfig(block_size_tokens=BLOCK)))
        self.pool = Pool(PoolConfig(concurrency=1), self.indexer.kv_block_index,
                         self.indexer.token_processor)

    def feed(self, pod, port_events, model_name=MODEL):
        """Apply the port's events, and their JAX twins, to both stacks."""
        jax_events = [getattr(jax_model, type(e).__name__)(**vars(e))
                      for e in port_events]
        self.jax_pool.process_event_batch(
            jax_model.EventBatch(timestamp=0.0, events=jax_events), pod, model_name)
        self.pool.process_event_batch(
            model.EventBatch(timestamp=0.0, events=list(port_events)), pod, model_name)

    def assert_same_scores(self, tokens, model_name=MODEL, pods=None, features=None):
        jax_features = None if features is None else [
            None if f is None else JaxFeatures(mm_hashes=list(f.mm_hashes))
            for f in features]
        ref = self.jax_indexer.score_tokens(tokens, model_name, pods, jax_features)
        got = self.indexer.score_tokens(tokens, model_name, pods, features)
        assert got == ref
        return got


def test_engine_events_score_like_jax():
    """Two tiny port engines' event streams (stores, evictions, a reset)."""
    from llmd_kv_cache_tpu_torch.models import engine, llama

    stacks = Stacks()
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, 256, 16).tolist()
    engines, logs = {}, {}
    for pod in ("pod-a", "pod-b"):
        logs[pod] = []
        engines[pod] = engine.MiniEngine(
            engine.EngineConfig(model=llama.LlamaConfig.tiny(), num_pages=12,
                                max_pages_per_seq=12, model_name=MODEL,
                                pod_identifier=pod),
            event_sink=logs[pod].extend, device="cpu")
    engines["pod-a"].generate("a0", prefix + [7, 8, 9, 10], max_new_tokens=1)
    engines["pod-b"].generate("b0", prefix, max_new_tokens=1)
    for pod, log in logs.items():
        stacks.feed(pod, log)
        log.clear()
    got = stacks.assert_same_scores(prefix + [7, 8, 9, 10])
    assert got == {"pod-a": 5.0, "pod-b": 4.0}
    stacks.assert_same_scores(prefix, pods={"pod-b"})

    # Page pressure on pod-a evicts its oldest blocks (BlockRemoved).
    for i in range(3):
        engines["pod-a"].generate(f"a{i + 1}", rng.integers(1, 256, 16).tolist(), 1)
    assert any(isinstance(e, model.BlockRemovedEvent) for e in logs["pod-a"])
    stacks.feed("pod-a", logs["pod-a"])
    stacks.assert_same_scores(prefix + [7, 8, 9, 10])

    engines["pod-b"].reset_cache()  # AllBlocksCleared
    stacks.feed("pod-b", logs["pod-b"])
    assert "pod-b" not in stacks.assert_same_scores(prefix)


def stored(hashes, tokens, parent=0, **kw):
    return model.BlockStoredEvent(block_hashes=list(hashes), tokens=list(tokens),
                                  parent_hash=parent, block_size=BLOCK, **kw)


def test_synthetic_events_score_like_jax():
    stacks = Stacks()
    toks = list(range(100, 124))  # 6 blocks
    # Engine keys at twice the canonical block size (1 engine key : 2 blocks).
    stacks.feed("pod-a", [stored([11, 12, 13], toks, group_idx=0,
                                 kv_cache_spec_kind="full_attention")])
    # A continuation whose parent resolves through the engine-key mapping.
    stacks.feed("pod-a", [stored([14], list(range(124, 132)), parent=13)])
    # An unknown parent drops the event on both.
    stacks.feed("pod-b", [stored([21], list(range(124, 132)), parent=999)])
    # pod-b: same tokens on the host tier, and a LoRA namespace.
    stacks.feed("pod-b", [stored([31, 32], toks[:16], device_tier="cpu")])
    stacks.feed("pod-c", [stored([41], toks[:8], lora_name="adapter-1")])
    scores = stacks.assert_same_scores(toks + list(range(124, 132)))
    assert scores == {"pod-a": 8.0, "pod-b": 3.2}  # host tier weighs 0.8
    assert stacks.assert_same_scores(toks[:8], model_name="adapter-1") == {"pod-c": 2.0}
    # A tokenless BlockStored moves known blocks to another tier.
    stacks.feed("pod-a", [stored([11], [], device_tier="shared_storage")])
    # Multimodal extra keys taint the chain (engine granularity realigned).
    mm = [["img-1"], None, ["img-2", 5]]
    stacks.feed("pod-d", [stored([51, 52, 53], toks, extra_keys=mm)])
    features = [BlockExtraFeatures(["img-1"]), BlockExtraFeatures(["img-1"]), None,
                None, BlockExtraFeatures(["img-2"]), BlockExtraFeatures(["img-2"])]
    stacks.assert_same_scores(toks, features=features)
    stacks.assert_same_scores(toks)
    # Removal by engine key, then a pod-wide clear.
    stacks.feed("pod-a", [model.BlockRemovedEvent(block_hashes=[12], group_idx=0)])
    stacks.assert_same_scores(toks + list(range(124, 132)))
    stacks.feed("pod-b", [model.AllBlocksClearedEvent()])
    assert "pod-b" not in stacks.assert_same_scores(toks)
    assert len(stacks.indexer.kv_block_index) == len(stacks.jax_indexer.kv_block_index)


def test_realign_and_mappings_match_jax():
    from llmd_kv_cache_tpu.events.pool import realign_extra_features as jax_realign
    from llmd_kv_cache_tpu.index.base import infer_engine_mappings as jax_infer

    for ne, nr in ((3, 6), (6, 3), (4, 4), (1, 5), (5, 1)):
        e, r = list(range(ne)), list(range(100, 100 + nr))
        assert infer_engine_mappings(e, r) == jax_infer(e, r)
    feats = [BlockExtraFeatures(["a"]), None, BlockExtraFeatures(["b", "c"])]
    jfeats = [JaxFeatures(["a"]), None, JaxFeatures(["b", "c"])]
    for n in (1, 2, 3, 6):
        got = realign_extra_features(list(feats), n)
        ref = jax_realign(list(jfeats), n)
        assert [None if f is None else f.mm_hashes for f in got] == \
            [None if f is None else f.mm_hashes for f in ref]


def test_index_and_scorer_contract_match_jax():
    from llmd_kv_cache_tpu.core.keys import KeyType as JaxKeyType
    from llmd_kv_cache_tpu.core.keys import PodEntry as JaxPodEntry
    from llmd_kv_cache_tpu.scoring.scorer import create_scorer as jax_create_scorer

    def run(index, entry, key_type, scorer):
        a, b = entry("pod-a", "tpu-hbm"), entry("pod-b", "cpu")
        index.add([1, 2], [10, 20], [a])
        index.add(None, [10], [b])
        out = [index.lookup([10, 20]), index.lookup([10, 20], {"pod-b"}),
               index.get_request_key(2), scorer.score([10, 20], index.lookup([10, 20]))]
        index.evict(1, key_type.ENGINE, [a])
        out.append(index.lookup([10, 20]))
        index.clear("pod-b")
        out.append(index.lookup([10, 20]))
        return [{k: [str(e) for e in v] for k, v in o.items()} if isinstance(o, dict)
                and o and isinstance(next(iter(o.values())), list) else o for o in out]

    got = run(InMemoryIndex(), PodEntry, KeyType, create_scorer(KVBlockScorerConfig()))
    ref = run(JaxInMemoryIndex(), JaxPodEntry, JaxKeyType, jax_create_scorer())
    assert got == ref
    assert got[3] == {"pod-a": 2.0, "pod-b": 0.8}
    with pytest.raises(ValueError):
        create_scorer(KVBlockScorerConfig(scoring_strategy="Other"))
