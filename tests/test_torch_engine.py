"""The port's ``MiniEngine`` against the JAX ``MiniEngine``.

Both engines serve the same weights (the JAX tree carried over by
``params_from_jax``) at fp32 — bf16 argmax near-ties flip between
differently compiled programs — and must give the same greedy tokens, the
same ``cached_len`` and the same KV event stream (types, block hashes,
parent hashes, token ids, group tags, order), through synchronous serving,
continuous batching, chunked prefill, LRU eviction in an undersized pool,
aborts and cache resets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu_torch.events.model import (
    AllBlocksClearedEvent,
    BlockRemovedEvent,
    BlockStoredEvent,
)
from llmd_kv_cache_tpu_torch.models import engine, llama

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)
PAGE = TINY["page_size"]


def normalize(events):
    """Events of either package as plain tuples, in order."""
    out = []
    for e in events:
        name = type(e).__name__
        fields = dataclasses.asdict(e)
        out.append((name, tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v) for k, v in fields.items()))))
    return out


class Pair:
    """A JAX engine and a port engine with the same weights and config."""

    def __init__(self, **cfg_kw):
        jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32)
        tcfg = llama.LlamaConfig(**TINY, dtype=torch.float32)
        base = dict(max_pages_per_seq=16, model_name="tiny", pod_identifier="pod-0")
        base.update(cfg_kw)
        self.jax_events, self.events = [], []
        self.jax = jax_engine.MiniEngine(
            jax_engine.EngineConfig(model=jcfg, **base),
            event_sink=self.jax_events.extend, seed=0)
        params = llama.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jax.params),
            tcfg, device="cpu")
        self.port = engine.MiniEngine(
            engine.EngineConfig(model=tcfg, **base),
            event_sink=self.events.extend, params=params, device="cpu")

    def both(self, method, *args, **kwargs):
        return (getattr(self.jax, method)(*args, **kwargs),
                getattr(self.port, method)(*args, **kwargs))

    def assert_same_events(self):
        assert normalize(self.events) == normalize(self.jax_events)


def prompts(seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 256, 13).tolist()  # 3 full blocks + 1 token
    return prefix, [prefix + rng.integers(1, 256, n).tolist() for n in (7, 3, 12, 0)]


def test_generate_and_prefix_reuse_match_jax():
    pair = Pair(num_pages=64)
    prefix, ps = prompts()
    for i, p in enumerate(ps):
        jr, tr = pair.both("add_request", f"r{i}", p, max_new_tokens=5)
        assert tr.cached_len == jr.cached_len
        assert tr.block_hashes == jr.block_hashes
        while not jr.done:
            pair.jax.step()
        while not tr.done:
            pair.port.step()
        assert tr.output == jr.output
    # The shared prefix was reused from the second request on.
    assert pair.port.block_manager.num_cached_blocks() == \
        pair.jax.block_manager.num_cached_blocks()
    pair.assert_same_events()
    assert any(isinstance(e, BlockStoredEvent) and e.parent_hash != 0
               for e in pair.events)


def test_continuous_batching_matches_jax():
    pair = Pair(num_pages=96, max_batch=3, max_prefill_tokens=8)
    prefix, ps = prompts(1)
    reqs = [pair.both("enqueue", f"r{i}", p, max_new_tokens=4 + i)
            for i, p in enumerate(ps)]
    for _ in range(60):
        assert pair.port.step() == pair.jax.step()
        if all(jr.done for jr, _ in reqs):
            break
    for jr, tr in reqs:
        assert tr.done and jr.done
        assert (tr.output, tr.cached_len) == (jr.output, jr.cached_len)
    pair.assert_same_events()


def test_chunked_prefill_matches_single_shot():
    outs = []
    for cap in (1024, 8):
        pair = Pair(num_pages=64, max_prefill_tokens=cap)
        prompt = list(range(100, 124))
        jr = pair.jax.generate("r", prompt, max_new_tokens=4)
        tr = pair.port.generate("r", prompt, max_new_tokens=4)
        assert tr == jr
        pair.assert_same_events()
        outs.append(tr)
    assert outs[0] == outs[1]


def test_eviction_in_an_undersized_pool_matches_jax():
    pair = Pair(num_pages=10)
    rng = np.random.default_rng(2)
    for i in range(4):
        p = rng.integers(1, 256, 12).tolist()
        assert pair.port.generate(f"r{i}", p, 2) == pair.jax.generate(f"r{i}", p, 2)
    assert any(isinstance(e, BlockRemovedEvent) for e in pair.events)
    assert pair.port.block_manager.evictions == pair.jax.block_manager.evictions
    pair.assert_same_events()
    # An admission that cannot fit rolls back on both.
    big = rng.integers(1, 256, 30).tolist()
    for eng in (pair.jax, pair.port):
        free = eng.block_manager.num_free()
        with pytest.raises(RuntimeError, match="out of KV pages"):
            eng.add_request("big", big, max_new_tokens=4)
        assert eng.block_manager.num_free() >= free
    pair.assert_same_events()


def test_abort_and_reset_match_jax():
    pair = Pair(num_pages=64)
    prefix, ps = prompts(3)
    pair.both("add_request", "a", ps[0], max_new_tokens=8)
    pair.both("enqueue", "b", ps[1], max_new_tokens=8)
    pair.both("step")
    assert pair.both("abort_request", "a") == (True, True)
    assert pair.both("abort_request", "a") == (False, False)
    pair.both("reset_cache")
    assert isinstance(pair.events[-1], AllBlocksClearedEvent)
    assert pair.port.block_manager.num_free() == pair.jax.block_manager.num_free()
    assert not pair.port._running and pair.port.step() == {}
    pair.assert_same_events()


def test_oversized_request_is_rejected():
    pair = Pair(num_pages=64)
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        pair.port.add_request("big", list(range(1000)), max_new_tokens=1)
    with pytest.raises(ValueError, match="empty prompt"):
        pair.port.add_request("e", [], max_new_tokens=1)


def test_engine_refuses_a_missing_card():
    """Built without ``device="cpu"`` on a host without CUDA, the engine
    raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.MiniEngine(engine.EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_params(llama.LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_kv_cache(llama.LlamaConfig.tiny(), 4)
