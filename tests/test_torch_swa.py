"""Sliding windows and StreamingLLM sinks in the port, against the JAX package.

Both packages get the same weights (the JAX ``init_params`` tree through
``params_from_jax``) and the same numpy inputs from a seed, at fp32 (bf16
argmax near-ties flip between differently compiled programs). Held here:

- ``LlamaConfig``'s window, sink and QK-norm fields: the same validation
  messages, and ``layer_window``/``is_hybrid``/``group_layers``/
  ``layer_group`` equal JAX's for every family configuration;
- logits of a uniform-SWA model (Mistral-style) and of ``sink_tiny``
  through ``forward`` (prefill chunks past the window, then a decode step),
  ``forward_ragged`` (against the JAX ``forward_ragged`` with its Pallas
  ragged kernel in interpret mode) and ``forward_decode_steps`` (tokens and
  pools against the JAX burst), within ``tests/test_torch_model.py``'s 1e-4
  of the largest logit;
- the engines: token streams, ``cached_len`` and every event batch's wire
  bytes (the JAX publisher's encoding) equal JAX's on the padded, ragged
  and burst schedulers, blocks advertised ``sliding_window`` or
  ``sink_full_attention`` with the window;
- the offload spec's sink check: a spec whose ``attention_sinks`` is not
  the model's raises in both packages with the same message, and a sink
  model writes a store the JAX engine restores.

Helpers here are shared with ``test_torch_qwen3.py``, ``test_torch_hybrid.py``
and ``test_torch_hybrid_scoring.py``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.events import model as jax_event_model
from llmd_kv_cache_tpu.events.publisher import encode_event
from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.offload.spec import SharedStorageOffloadSpec as JaxSpec
from llmd_kv_cache_tpu_torch.core.hma import SPEC_SINK_FULL, SPEC_SLIDING_WINDOW
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload.spec import SharedStorageOffloadSpec

TOL = 1e-4
TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, page_size=4)
# A uniform window on every layer (Mistral's layout at the tiny size).
SWA = dict(TINY, sliding_window=8, swa_layers=(0, 1))
FAMILIES = {
    "swa": SWA,
    "sinks": dataclasses.asdict(jax_llama.LlamaConfig.sink_tiny()),
    "qwen3": dataclasses.asdict(jax_llama.LlamaConfig.qwen3_tiny()),
    "hybrid": dataclasses.asdict(jax_llama.LlamaConfig.gemma_tiny()),
    "tiny": TINY,
}


@pytest.fixture(autouse=True)
def jax_restore_metrics(monkeypatch):
    """The JAX engines' restore latencies and sheds are dropped, not
    recorded in the JAX package's process-wide metric families: a fleet test
    later in the same process would read them as slow restores."""
    collector = importlib.import_module("llmd_kv_cache_tpu.metrics.collector")
    monkeypatch.setattr(collector, "record_shed", lambda site, outcome: None)
    monkeypatch.setattr(collector, "record_engine_restore", lambda outcome, seconds=None: None)
    monkeypatch.setattr(collector, "record_offload_restore", lambda tier, seconds: None)


def config_pair(family, **kw):
    """(JAX config, port config) at fp32 for a family name or a field dict."""
    fields = dict(FAMILIES[family] if isinstance(family, str) else family, **kw)
    fields.pop("dtype", None)
    port_fields = {k: v for k, v in fields.items()
                   if k in {f.name for f in dataclasses.fields(llama.LlamaConfig)}}
    return (jax_llama.LlamaConfig(**fields, dtype=jnp.float32),
            llama.LlamaConfig(**port_fields, dtype=torch.float32))


def jax_tree(jcfg, seed=0, biases=False, norms=False):
    """The JAX ``init_params`` tree as numpy, with random QKV biases (Qwen2)
    and QK-norm weights other than ones when asked, so that the port must
    carry and apply them."""
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(seed),
                                                                    jcfg))
    rng = np.random.default_rng(seed + 100)
    for layer in tree["layers"]:
        if biases:
            for name, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
                layer[name] = (rng.standard_normal(layer[w].shape[1]) * 0.05).astype(
                    layer[w].dtype)
        if norms:
            for name in ("q_norm", "k_norm"):
                layer[name] = (1.0 + 0.3 * rng.standard_normal(layer[name].shape)).astype(
                    np.float32)
    return tree


def jax_params(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_logits_close(got, ref):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


def wire(batches):
    """Event batches as the JAX publisher's msgpack bytes, event by event."""
    return [[msgpack.packb(encode_event(getattr(jax_event_model, type(e).__name__)(
        **dataclasses.asdict(e)))) for e in batch] for batch in batches]


class Pair:
    """A JAX engine and a port engine with the same weights and config."""

    def __init__(self, family, tree_kw=None, model_kw=None, port_kw=None, jax_spec=None,
                 port_spec=None, tree=None, **cfg_kw):
        self.jcfg, self.tcfg = config_pair(family, **(model_kw or {}))
        base = dict(max_pages_per_seq=16, model_name="fam", pod_identifier="pod-0")
        base.update(cfg_kw)
        self.jax_batches, self.batches = [], []
        if tree is None:
            tree = jax_tree(self.jcfg, **(tree_kw or {}))
        self.jax = jax_engine.MiniEngine(
            jax_engine.EngineConfig(model=self.jcfg, **base),
            event_sink=self.jax_batches.append, params=jax_params(tree),
            offload_spec=jax_spec)
        self.port = engine.MiniEngine(
            engine.EngineConfig(model=self.tcfg, **base, **(port_kw or {})),
            event_sink=self.batches.append,
            params=llama.params_from_jax(tree, self.tcfg, device="cpu"), device="cpu",
            offload_spec=port_spec)

    def both(self, method, *args, **kwargs):
        return (getattr(self.jax, method)(*args, **kwargs),
                getattr(self.port, method)(*args, **kwargs))

    def step(self):
        want, got = self.jax.step(), self.port.step()
        assert got == want
        self.assert_same_pages()
        return got

    def assert_same_pages(self):
        """Each manager's free count, and (hybrid) each request's SWA pages."""
        assert self.port.block_manager.num_free() == self.jax.block_manager.num_free()
        if self.jax.hybrid:
            assert self.port.swa_manager.num_free() == self.jax.swa_manager.num_free()
            for rid, req in self.jax.requests.items():
                got = self.port.requests[rid]
                assert (got.swa_pages, got.swa_acquired_from) == (
                    req.swa_pages, req.swa_acquired_from)

    def run(self, reqs, max_steps=200):
        for _ in range(max_steps):
            if all(jr.done for jr, _ in reqs):
                break
            self.step()
        for jr, tr in reqs:
            assert jr.done and tr.done
            assert (tr.output, tr.cached_len) == (jr.output, jr.cached_len)

    def assert_same_events(self):
        assert wire(self.batches) == wire(self.jax_batches)


def prompts(seed, lengths, prefix_len=21):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 256, prefix_len).tolist()
    return [prefix + rng.integers(1, 256, n).tolist() for n in lengths]


# ---------------------------------------------------------------------------
# LlamaConfig
# ---------------------------------------------------------------------------

MLA = dict(TINY, num_kv_heads=4, kv_lora_rank=16, qk_rope_head_dim=8)
BAD_CONFIGS = {
    "mla-window": dict(MLA, sliding_window=8, swa_layers=(0,)),
    "mla-swa-layers": dict(MLA, swa_layers=(0,)),
    "mla-qk-norm": dict(MLA, qk_norm=True),
    "sinks-without-window": dict(TINY, attention_sinks=4),
    "sinks-on-hybrid": dict(TINY, sliding_window=8, swa_layers=(0,), attention_sinks=4),
}


@pytest.mark.parametrize("fields", BAD_CONFIGS.values(), ids=BAD_CONFIGS)
def test_config_refusals_match_jax(fields):
    with pytest.raises(ValueError) as want:
        jax_llama.LlamaConfig(**fields)
    with pytest.raises(ValueError) as got:
        llama.LlamaConfig(**fields)
    assert str(got.value) == str(want.value)


LAYOUTS = dict(
    FAMILIES,
    gemma3=dict(TINY, num_layers=12, sliding_window=16,
                swa_layers=tuple(i for i in range(12) if i % 6 != 5)),
    window_unset=dict(TINY, swa_layers=(0,)),
    layers_out_of_range=dict(TINY, sliding_window=8, swa_layers=(1, 5)),
)


@pytest.mark.parametrize("family", LAYOUTS.values(), ids=LAYOUTS)
def test_layer_layout_helpers_match_jax(family):
    jcfg, tcfg = config_pair(family)
    assert tcfg.is_hybrid == jcfg.is_hybrid
    for g in (0, 1):
        assert tcfg.group_layers(g) == jcfg.group_layers(g)
    for li in range(jcfg.num_layers):
        assert tcfg.layer_window(li) == jcfg.layer_window(li)
        assert tcfg.layer_group(li) == jcfg.layer_group(li)


@pytest.mark.parametrize("name", ["qwen3_tiny", "gemma_tiny", "sink_tiny"])
def test_test_configurations_are_jaxs(name):
    want = dataclasses.asdict(getattr(jax_llama.LlamaConfig, name)())
    got = dataclasses.asdict(getattr(llama.LlamaConfig, name)())
    want.pop("dtype"), got.pop("dtype")
    assert {k: v for k, v in want.items() if k in got} == got


# ---------------------------------------------------------------------------
# The forward: padded, ragged, bursts
# ---------------------------------------------------------------------------


def run_padded(jcfg, tcfg, tree, tables, steps):
    """Drive ``forward`` of both packages through ``steps`` ((tokens, ctx,
    new, last_only) each); returns the last pools of both."""
    jparams = jax_params(tree)
    tparams = llama.params_from_jax(tree, tcfg, device="cpu")
    jk, jv = jax_llama.init_kv_cache(jcfg, 40)
    tk, tv = llama.init_kv_cache(tcfg, 40, device="cpu")
    for toks, ctx, new, last_only in steps:
        jlog, jk, jv = jax_llama.forward(
            jparams, jcfg, jnp.asarray(toks), jk, jv, jnp.asarray(tables),
            jnp.asarray(ctx), jnp.asarray(new), last_only=last_only)
        tlog = llama.forward(tparams, tcfg, torch.from_numpy(toks), tk, tv,
                             torch.from_numpy(tables), torch.from_numpy(ctx),
                             torch.from_numpy(new), last_only=last_only)[0].numpy()
        jlog = np.asarray(jlog)
        for b in range(len(new)):
            rows = slice(0, 1) if last_only else slice(0, int(new[b]))
            if new[b]:
                assert_logits_close(tlog[b, rows], jlog[b, rows])
    return (jk, jv), (tk, tv)


def chunked_steps(rng, vocab, lens, chunk):
    """Prefill two rows of ``lens`` tokens in chunks of ``chunk``, then a
    decode step with one live row."""
    steps, ctx = [], np.zeros(2, np.int32)
    for start in range(0, max(lens), chunk):
        new = np.array([max(0, min(chunk, n - start)) for n in lens], np.int32)
        toks = rng.integers(0, vocab, size=(2, chunk)).astype(np.int32)
        steps.append((toks, ctx.copy(), new, start + chunk < max(lens)))
        ctx = ctx + new
    steps.append((rng.integers(0, vocab, size=(2, 1)).astype(np.int32), ctx,
                  np.array([1, 0], np.int32), False))
    return steps


@pytest.mark.parametrize("family", ["swa", "sinks"])
@pytest.mark.parametrize("chunk", [6, 32])
def test_forward_matches_jax_past_the_window(family, chunk):
    jcfg, tcfg = config_pair(family)
    rng = np.random.default_rng(chunk)
    tree = jax_tree(jcfg, seed=chunk)
    table = np.arange(1, 33, dtype=np.int32).reshape(2, 16)
    (jk, jv), (tk, tv) = run_padded(jcfg, tcfg, tree, table,
                                    chunked_steps(rng, jcfg.vocab_size, (27, 19), chunk))
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)


def test_the_window_changes_the_logits():
    """The window is engaged: past it, a uniform-SWA model's logits differ
    from the same weights with no window, and its sinks differ again."""
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 256, (1, 24)))
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    ctx, new = torch.zeros(1, dtype=torch.int32), torch.full((1,), 24, dtype=torch.int32)
    tree = jax_tree(config_pair("tiny")[0])
    outs = []
    for family in ("tiny", "swa", "sinks"):
        tcfg = config_pair(family)[1]
        k, v = llama.init_kv_cache(tcfg, 10, device="cpu")
        outs.append(llama.forward(llama.params_from_jax(tree, tcfg, device="cpu"), tcfg,
                                  toks, k, v, table, ctx, new)[0])
    # Inside the window (the first 8 positions) the three agree exactly.
    for out in outs[1:]:
        torch.testing.assert_close(out[:, :8], outs[0][:, :8], rtol=0, atol=0)
    assert (outs[1][:, 8:] - outs[0][:, 8:]).abs().max() > 1e-3
    assert (outs[2][:, 8:] - outs[1][:, 8:]).abs().max() > 1e-3


@pytest.mark.parametrize("family", ["swa", "sinks"])
def test_forward_ragged_matches_jax(family):
    """A mixed dispatch (three decode rows past the window, one 9-token
    chunk over a cached prefix, an empty row) against the JAX
    ``forward_ragged`` with its Pallas kernel in interpret mode."""
    jcfg, tcfg = config_pair(family)
    tree = jax_tree(jcfg, seed=5)
    rng = np.random.default_rng(5)
    q_lens, ctx = [1, 1, 9, 0, 1], np.array([13, 22, 11, 0, 3], np.int32)
    rows = len(q_lens)
    tables = np.zeros((rows, 16), np.int32)
    for r in range(rows):
        tables[r, :8] = np.arange(1 + 8 * r, 9 + 8 * r)
    jk, jv = jax_llama.init_kv_cache(jcfg, 1 + 8 * rows)
    tk, tv = llama.init_kv_cache(tcfg, 1 + 8 * rows, device="cpu")
    # Fill each row's cached prefix through the padded forward of both.
    jparams, tparams = jax_params(tree), llama.params_from_jax(tree, tcfg, device="cpu")
    pre = rng.integers(0, 256, (rows, 24)).astype(np.int32)
    zeros = np.zeros(rows, np.int32)
    _, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(pre), jk, jv,
                                  jnp.asarray(tables), jnp.asarray(zeros), jnp.asarray(ctx))
    llama.forward(tparams, tcfg, torch.from_numpy(pre), tk, tv, torch.from_numpy(tables),
                  torch.from_numpy(zeros), torch.from_numpy(ctx))
    starts = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    flat = np.zeros((1, 16), np.int32)
    flat[0, :starts[-1]] = rng.integers(0, 256, starts[-1])
    jlog, jk, jv = jax_llama.forward_ragged(
        jparams, jcfg, jnp.asarray(flat), jk, jv, jnp.asarray(tables), jnp.asarray(starts),
        jnp.asarray(ctx), interpret=True)
    tlog = llama.forward_ragged(tparams, tcfg, torch.from_numpy(flat), tk, tv,
                                torch.from_numpy(tables), torch.from_numpy(starts),
                                torch.from_numpy(ctx))[0].numpy()
    live = [r for r in range(rows) if q_lens[r]]
    assert_logits_close(tlog[live], np.asarray(jlog)[live])
    plain = llama.forward_ragged(tparams, tcfg, torch.from_numpy(flat), tk.clone(), tv.clone(),
                                 torch.from_numpy(tables), torch.from_numpy(starts),
                                 torch.from_numpy(ctx), plain_attention=True)[0].numpy()
    np.testing.assert_array_equal(plain[live], tlog[live])


@pytest.mark.parametrize("family", ["swa", "sinks"])
@pytest.mark.parametrize("steps", [1, 4, 8])
def test_decode_steps_match_jax(family, steps):
    """A burst whose tail crosses the window's edge: tokens and the pools
    after the final scatter equal the JAX burst's."""
    jcfg, tcfg = config_pair(family)
    tree = jax_tree(jcfg, seed=6)
    rng = np.random.default_rng(6)
    table = np.arange(1, 49, dtype=np.int32).reshape(3, 16)
    lens = np.array([11, 6, 0], np.int32)
    prompt = rng.integers(0, 256, (3, 12)).astype(np.int32)
    jparams, tparams = jax_params(tree), llama.params_from_jax(tree, tcfg, device="cpu")
    jk, jv = jax_llama.init_kv_cache(jcfg, 50)
    tk, tv = llama.init_kv_cache(tcfg, 50, device="cpu")
    zeros = np.zeros(3, np.int32)
    _, jk, jv = jax_llama.forward(jparams, jcfg, jnp.asarray(prompt), jk, jv,
                                  jnp.asarray(table), jnp.asarray(zeros), jnp.asarray(lens))
    llama.forward(tparams, tcfg, torch.from_numpy(prompt), tk, tv, torch.from_numpy(table),
                  torch.from_numpy(zeros), torch.from_numpy(lens))
    last = np.array([7, 9, 0], np.int32)
    active = np.array([steps, max(steps - 1, 0), 0], np.int32)
    jt, jk, jv = jax_llama.forward_decode_steps(
        jparams, jcfg, jnp.asarray(last), jk, jv, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(active), steps)
    tt, _, _ = llama.forward_decode_steps(
        tparams, tcfg, torch.from_numpy(last), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(active), steps)
    for r in range(2):
        assert tt.numpy()[r, :active[r]].tolist() == np.asarray(jt)[r, :active[r]].tolist()
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

SCHEDULERS = {
    "padded": {},
    "ragged": {"port_kw": {"ragged_attention": True}},
    "burst4": {"decode_burst": 4},
}


@pytest.mark.parametrize("family", ["swa", "sinks"])
@pytest.mark.parametrize("scheduler", SCHEDULERS.values(), ids=SCHEDULERS)
def test_engine_streams_and_events_match_jax(family, scheduler):
    """Continuous batching past the window (4 prompts over a 21-token
    shared prefix, chunks of 8), then a routed prompt reusing the prefix.
    The port's ragged engine is held against the JAX padded engine: the
    same function, so the same streams and events."""
    pair = Pair(family, num_pages=96, max_batch=3, max_prefill_tokens=8, **scheduler)
    reqs = [pair.both("enqueue", f"r{i}", p, max_new_tokens=6 + i)
            for i, p in enumerate(prompts(7, (7, 3, 12, 1)))]
    pair.run(reqs)
    again = prompts(7, (5,))[0]
    jr, tr = pair.both("add_request", "again", again, max_new_tokens=3)
    assert tr.cached_len == jr.cached_len >= 20
    pair.run([(jr, tr)])
    pair.assert_same_events()
    kind = SPEC_SINK_FULL if family == "sinks" else SPEC_SLIDING_WINDOW
    stored = [e for batch in pair.batches for e in batch
              if type(e).__name__ == "BlockStoredEvent"]
    assert stored and all(e.kv_cache_spec_kind == kind and e.kv_cache_spec_sliding_window == 8
                          for e in stored)


@pytest.mark.parametrize("family", ["swa", "sinks"])
def test_engine_eviction_abort_and_reset_match_jax(family):
    pair = Pair(family, num_pages=14)
    rng = np.random.default_rng(8)
    for i in range(4):
        p = rng.integers(1, 256, 14).tolist()
        assert pair.port.generate(f"r{i}", p, 3) == pair.jax.generate(f"r{i}", p, 3)
    assert pair.port.block_manager.evictions == pair.jax.block_manager.evictions > 0
    pair.both("enqueue", "a", rng.integers(1, 256, 15).tolist(), max_new_tokens=8)
    pair.step()
    assert pair.both("abort_request", "a") == (True, True)
    pair.both("reset_cache")
    pair.assert_same_pages()
    pair.assert_same_events()


# ---------------------------------------------------------------------------
# Offload: the spec's sinks
# ---------------------------------------------------------------------------


def spec_kw(root, jcfg, sinks):
    return dict(root=str(root), model_name="fam", page_size=jcfg.page_size,
                num_layers=jcfg.num_layers, kv_heads=jcfg.num_kv_heads,
                head_dim=jcfg.head_dim, io_threads=2, sliding_window=jcfg.sliding_window,
                swa_layers=jcfg.swa_layers, attention_sinks=sinks, dtype="float32")


@pytest.mark.parametrize("family,sinks", [("sinks", 0), ("sinks", 2), ("swa", 4)])
def test_offload_spec_sinks_mismatch_raises_as_jax(tmp_path, family, sinks):
    jcfg, tcfg = config_pair(family)
    with pytest.raises(ValueError) as want:
        jax_engine.MiniEngine(jax_engine.EngineConfig(model=jcfg),
                              offload_spec=JaxSpec(**spec_kw(tmp_path, jcfg, sinks)))
    with pytest.raises(ValueError) as got:
        engine.MiniEngine(engine.EngineConfig(model=tcfg), device="cpu",
                          offload_spec=SharedStorageOffloadSpec(**spec_kw(tmp_path, jcfg, sinks)))
    assert str(got.value) == str(want.value)
    assert f"attention_sinks={sinks}" in str(got.value)


def test_sink_model_store_restores_across_packages(tmp_path):
    """A port sink engine writes through its store; a JAX sink engine of the
    same weights restores it (same fingerprint directory) and decodes the
    tokens the port computed."""
    jcfg, tcfg = config_pair("sinks")
    tree = jax_tree(jcfg, seed=9)
    prompt = np.random.default_rng(9).integers(1, 256, 26).tolist()
    kw = dict(model_name="fam", num_pages=64, max_pages_per_seq=16)
    writer = engine.MiniEngine(
        engine.EngineConfig(model=tcfg, **kw), device="cpu",
        params=llama.params_from_jax(tree, tcfg, device="cpu"),
        offload_spec=SharedStorageOffloadSpec(**spec_kw(tmp_path, jcfg, 4)))
    out = writer.generate("w", prompt, max_new_tokens=5)
    writer.flush_offload()
    writer.offload_handlers.shutdown()
    reader = jax_engine.MiniEngine(jax_engine.EngineConfig(model=jcfg, **kw),
                                   params=jax_params(tree),
                                   offload_spec=JaxSpec(**spec_kw(tmp_path, jcfg, 4)))
    req = reader.add_request("r", prompt, max_new_tokens=5)
    assert req.cached_len == 24 and req.restored_blocks == 6
    while not req.done:
        reader.step()
    assert req.output == out
    reader.offload_handlers.shutdown()
