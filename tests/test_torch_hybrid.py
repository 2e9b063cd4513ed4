"""The hybrid two-pool model and engine in the port, against the JAX package.

A hybrid model mixes full-attention and sliding-window layers (Gemma-style):
group 0 (the full-attention layers) and group 1 (the SWA layers) keep page
pools of their own, each stacked in ``group_layers(g)`` order. Both packages
get the same weights and the same numpy inputs, at fp32. Held here:

- ``init_kv_cache_hybrid``'s pools; ``forward_hybrid`` (logits within
  ``tests/test_torch_model.py``'s 1e-4 of the largest logit, both groups'
  pools) and ``forward_decode_steps_hybrid`` (tokens, pools) against JAX's,
  and ``forward_hybrid`` against the port's one-pool ``forward``;
- the engines, step by step: emitted tokens, each manager's free count, each
  request's SWA pages, ``cached_len`` and every event batch's wire bytes,
  through chunked prefill past the window, continuous batching, the
  trailing-window resume, bursts (2 to 16, windows sliding mid-burst), an
  SWA pool too small for a burst (single-token decoding latched), a
  window-bounded pool, eviction, aborts and a reset (one AllBlocksCleared);
- offload: both groups' store files byte-identical to the JAX engine's
  (posix and object backends), a port engine restoring a JAX store and a
  JAX engine the port's (all or nothing: pages bit-equal, the SWA window
  only, tokens equal), and a missing window skipping the restore;
- the refusals: the ragged scheduler, prefill/decode roles (at construction
  and through ``set_role``), ``handoff=True`` and an offload spec whose sinks
  are not the model's.
"""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import engine as jax_engine
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu.offload.spec import SharedStorageOffloadSpec as JaxSpec
from llmd_kv_cache_tpu_torch.core.hma import SPEC_FULL_ATTENTION, SPEC_SLIDING_WINDOW
from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.offload.spec import SharedStorageOffloadSpec

from tests.test_torch_swa import (  # noqa: F401  (jax_restore_metrics: an autouse fixture)
    TINY,
    Pair,
    assert_logits_close,
    config_pair,
    jax_params,
    jax_tree,
    jax_restore_metrics,
    prompts,
)

# The JAX hybrid suites' layout (tests/test_hybrid_engine.py): two layers,
# the second SWA at window 8 (2 pages); gemma_tiny (4 layers, 1:1); and
# Gemma 3's 5:1 at the tiny width.
LAYOUTS = {
    "hybrid-1of2": dict(TINY, sliding_window=8, swa_layers=(1,)),
    "gemma_tiny": "hybrid",
    "gemma3-5of6": dict(TINY, num_layers=6, sliding_window=8, swa_layers=(0, 1, 2, 3, 4)),
}


def layout(name):
    return LAYOUTS[name]


def hybrid_steps(rng, vocab, lens, chunk):
    """Two rows prefilled in chunks past the window, then two decode
    steps (one with a padded row)."""
    steps, ctx = [], np.zeros(2, np.int32)
    for start in range(0, max(lens), chunk):
        new = np.array([max(0, min(chunk, n - start)) for n in lens], np.int32)
        steps.append((rng.integers(0, vocab, (2, chunk)).astype(np.int32), ctx.copy(), new,
                      start + chunk < max(lens)))
        ctx = ctx + new
    for live in ([1, 1], [1, 0]):
        new = np.array(live, np.int32)
        steps.append((rng.integers(0, vocab, (2, 1)).astype(np.int32), ctx.copy(), new, False))
        ctx = ctx + new
    return steps


def hybrid_pools(jcfg, tcfg, n0=40, n1=24):
    return (jax_llama.init_kv_cache_hybrid(jcfg, n0, n1),
            list(llama.init_kv_cache_hybrid(tcfg, n0, n1, device="cpu")))


def swa_table(rows, pages, base=1):
    """Distinct SWA pages a row (logical order), as an engine's would be
    before reclaiming."""
    t = np.zeros((rows, 16), np.int32)
    for r in range(rows):
        t[r, :pages] = np.arange(base + pages * r, base + pages * (r + 1))
    return t


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LAYOUTS)
def test_hybrid_pools_are_jaxs(name):
    jcfg, tcfg = config_pair(layout(name))
    want = jax_llama.init_kv_cache_hybrid(jcfg, 12, 5)
    got = llama.init_kv_cache_hybrid(tcfg, 12, 5, device="cpu")
    assert [tuple(t.shape) for t in got] == [tuple(a.shape) for a in want]
    assert all(t.dtype == torch.float32 and not t.any() for t in got)
    with pytest.raises(ValueError) as ref:
        jax_llama.init_kv_cache_hybrid(config_pair("swa")[0], 12, 5)
    with pytest.raises(ValueError) as ours:
        llama.init_kv_cache_hybrid(config_pair("swa")[1], 12, 5, device="cpu")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("chunk", [4, 32])
def test_forward_hybrid_matches_jax(name, chunk):
    jcfg, tcfg = config_pair(layout(name))
    tree = jax_tree(jcfg, seed=chunk)
    jparams, tparams = jax_params(tree), llama.params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(chunk)
    table0 = np.arange(1, 33, dtype=np.int32).reshape(2, 16)
    table1 = swa_table(2, 8)
    (jk0, jv0, jk1, jv1), tp = hybrid_pools(jcfg, tcfg)
    for toks, ctx, new, last_only in hybrid_steps(rng, jcfg.vocab_size, (26, 17), chunk):
        jlog, jk0, jv0, jk1, jv1 = jax_llama.forward_hybrid(
            jparams, jcfg, jnp.asarray(toks), jk0, jv0, jk1, jv1, jnp.asarray(table0),
            jnp.asarray(table1), jnp.asarray(ctx), jnp.asarray(new), last_only=last_only)
        out = llama.forward_hybrid(
            tparams, tcfg, torch.from_numpy(toks), *tp, torch.from_numpy(table0),
            torch.from_numpy(table1), torch.from_numpy(ctx), torch.from_numpy(new),
            last_only=last_only)
        assert all(a is b for a, b in zip(out[1:], tp))  # updated in place
        tlog, jlog = out[0].numpy(), np.asarray(jlog)
        for b in range(2):
            if new[b]:
                rows = slice(0, 1) if last_only else slice(0, int(new[b]))
                assert_logits_close(tlog[b, rows], jlog[b, rows])
    for got, want in zip(tp, (jk0, jv0, jk1, jv1)):
        np.testing.assert_allclose(got.numpy()[:, 1:], np.asarray(want)[:, 1:],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", LAYOUTS)
def test_forward_hybrid_equals_one_pool_forward(name):
    """Two pools and one pool of every layer compute the same function
    (each layer keeps its window), exactly; the plain version too."""
    jcfg, tcfg = config_pair(layout(name))
    tparams = llama.params_from_jax(jax_tree(jcfg, seed=2), tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 22)))
    table = torch.arange(1, 7, dtype=torch.int32)[None]
    ctx, new = torch.zeros(1, dtype=torch.int32), torch.full((1,), 22, dtype=torch.int32)
    k, v = llama.init_kv_cache(tcfg, 8, device="cpu")
    ref = llama.forward(tparams, tcfg, toks, k, v, table, ctx, new)[0]
    for plain in (False, True):
        pools = llama.init_kv_cache_hybrid(tcfg, 8, 8, device="cpu")
        got = llama.forward_hybrid(tparams, tcfg, toks, *pools, table, table, ctx, new,
                                   plain_attention=plain)[0]
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        for g, (kp, vp) in enumerate((pools[:2], pools[2:])):
            idx = list(tcfg.group_layers(g))
            torch.testing.assert_close(kp, k[idx], rtol=0, atol=0)
            torch.testing.assert_close(vp, v[idx], rtol=0, atol=0)


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("steps", [2, 8])
def test_decode_steps_hybrid_match_jax(name, steps):
    jcfg, tcfg = config_pair(layout(name))
    tree = jax_tree(jcfg, seed=7)
    jparams, tparams = jax_params(tree), llama.params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(7)
    lens = np.array([13, 6, 0], np.int32)
    prompt = rng.integers(0, 256, (3, 13)).astype(np.int32)
    table0 = np.arange(1, 49, dtype=np.int32).reshape(3, 16)
    table1 = swa_table(3, 8)
    (jk0, jv0, jk1, jv1), tp = hybrid_pools(jcfg, tcfg, 50, 26)
    zeros = np.zeros(3, np.int32)
    _, jk0, jv0, jk1, jv1 = jax_llama.forward_hybrid(
        jparams, jcfg, jnp.asarray(prompt), jk0, jv0, jk1, jv1, jnp.asarray(table0),
        jnp.asarray(table1), jnp.asarray(zeros), jnp.asarray(lens))
    llama.forward_hybrid(tparams, tcfg, torch.from_numpy(prompt), *tp,
                         torch.from_numpy(table0), torch.from_numpy(table1),
                         torch.from_numpy(zeros), torch.from_numpy(lens))
    last, active = np.array([5, 6, 0], np.int32), np.array([steps, 1, 0], np.int32)
    jt, jk0, jv0, jk1, jv1 = jax_llama.forward_decode_steps_hybrid(
        jparams, jcfg, jnp.asarray(last), jk0, jv0, jk1, jv1, jnp.asarray(table0),
        jnp.asarray(table1), jnp.asarray(lens), jnp.asarray(active), steps)
    out = llama.forward_decode_steps_hybrid(
        tparams, tcfg, torch.from_numpy(last), *tp, torch.from_numpy(table0),
        torch.from_numpy(table1), torch.from_numpy(lens), torch.from_numpy(active), steps)
    for r in range(2):
        assert out[0].numpy()[r, :active[r]].tolist() == np.asarray(jt)[r, :active[r]].tolist()
    for got, want in zip(tp, (jk0, jv0, jk1, jv1)):
        np.testing.assert_allclose(got.numpy()[:, 1:], np.asarray(want)[:, 1:],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The engine, step by step against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("burst", [1, 4])
def test_engine_continuous_batching_matches_jax(name, burst):
    """4 prompts over a 21-token prefix, chunks of 8, 3 rows a batch, SWA
    pool of 30 pages; then a routed prompt resuming at its trailing window,
    and a replay of a finished prompt."""
    pair = Pair(layout(name), num_pages=96, num_swa_pages=30, max_batch=3,
                max_prefill_tokens=8, decode_burst=burst)
    ps = prompts(3, (7, 3, 12, 1))
    reqs = [pair.both("enqueue", f"r{i}", p, max_new_tokens=6 + 2 * i)
            for i, p in enumerate(ps)]
    pair.run(reqs)
    jr, tr = pair.both("add_request", "again", ps[2][:27], max_new_tokens=4)
    assert tr.cached_len == jr.cached_len > 0
    pair.run([(jr, tr)])
    jr, tr = pair.both("add_request", "replay", ps[0], max_new_tokens=2)
    assert tr.cached_len == jr.cached_len == 28  # the whole 7-block prompt
    pair.run([(jr, tr)])
    pair.assert_same_events()
    groups = {}
    for batch in pair.batches:
        for e in batch:
            if type(e).__name__ == "BlockStoredEvent":
                groups.setdefault(e.group_idx, set()).add(
                    (e.kv_cache_spec_kind, e.kv_cache_spec_sliding_window))
    assert groups == {0: {(SPEC_FULL_ATTENTION, None)}, 1: {(SPEC_SLIDING_WINDOW, 8)}}


@pytest.mark.parametrize("burst", [2, 8, 16])
def test_engine_bursts_slide_the_window_as_jax(burst):
    """One long generation (33 tokens over a 7-token prompt): bursts end
    mid-page and mid-window; the SWA table is pre-extended and reclaimed
    once a burst, as in JAX."""
    pair = Pair(layout("hybrid-1of2"), num_pages=64, num_swa_pages=12, decode_burst=burst)
    reqs = [pair.both("add_request", "r", list(range(30, 37)), max_new_tokens=33)]
    pair.run(reqs)
    pair.assert_same_events()
    assert not pair.port._burst_degraded


@pytest.mark.parametrize("num_swa,latched", [(4, True), (5, True), (8, False)])
def test_undersized_swa_pool_latches_single_step_as_jax(num_swa, latched):
    """16-token bursts over a 2-page window need up to 6 SWA pages a row
    (pool page 0 is the garbage page): 4 or 5 latch single-token decoding,
    8 keep the bursts; the tokens are a single-step engine's either way."""
    pair = Pair(layout("hybrid-1of2"), num_pages=64, num_swa_pages=num_swa, decode_burst=16)
    reqs = [pair.both("add_request", "r", list(range(40, 48)), max_new_tokens=16)]
    pair.run(reqs)
    assert pair.port._burst_degraded == pair.jax._burst_degraded == latched
    single = Pair(layout("hybrid-1of2"), num_pages=64, num_swa_pages=num_swa)
    jr, tr = single.both("add_request", "r", list(range(40, 48)), max_new_tokens=16)
    single.run([(jr, tr)])
    assert reqs[0][1].output == tr.output
    pair.assert_same_events()


def test_window_bounded_swa_pool_fits_long_prompts_as_jax():
    """A 40-token prompt needs 10 SWA blocks alone; a 10-page SWA pool holds
    it (demand is window + chunk), with the JAX engine's free counts at
    every step and the tokens of an unbounded pool."""
    prompt = np.random.default_rng(9).integers(1, 250, 40).tolist()
    pair = Pair(layout("hybrid-1of2"), num_pages=64, num_swa_pages=10, max_prefill_tokens=8)
    jr, tr = pair.both("enqueue", "long", prompt, max_new_tokens=6)
    pair.run([(jr, tr)])
    wide = Pair(layout("hybrid-1of2"), num_pages=64, num_swa_pages=64)
    assert wide.port.generate("long", prompt, 6) == tr.output
    pair.assert_same_events()


def test_eviction_abort_and_reset_match_jax():
    pair = Pair(layout("gemma_tiny"), num_pages=16, num_swa_pages=12)
    rng = np.random.default_rng(5)
    for i in range(5):
        p = rng.integers(1, 256, 15).tolist()
        assert pair.port.generate(f"r{i}", p, 4) == pair.jax.generate(f"r{i}", p, 4)
        pair.assert_same_pages()
    assert pair.port.block_manager.evictions == pair.jax.block_manager.evictions > 0
    assert pair.port.swa_manager.evictions == pair.jax.swa_manager.evictions
    pair.both("enqueue", "a", rng.integers(1, 256, 14).tolist(), max_new_tokens=8)
    pair.step()
    assert pair.both("abort_request", "a") == (True, True)
    pair.assert_same_pages()
    n_events = sum(len(b) for b in pair.batches)
    pair.both("reset_cache")
    pair.assert_same_pages()
    pair.assert_same_events()
    after = [e for b in pair.batches for e in b][n_events:]
    assert [type(e).__name__ for e in after] == ["AllBlocksClearedEvent"]
    assert pair.port.swa_manager.num_free() == pair.port.swa_manager.num_pages - 1


# ---------------------------------------------------------------------------
# Offload: both groups, all or nothing
# ---------------------------------------------------------------------------


def spec_kw(root, jcfg, **kw):
    return dict(root=str(root), model_name="fam", page_size=jcfg.page_size,
                num_layers=jcfg.num_layers, kv_heads=jcfg.num_kv_heads,
                head_dim=jcfg.head_dim, io_threads=2, sliding_window=jcfg.sliding_window,
                swa_layers=jcfg.swa_layers, dtype="float32", **kw)


def settle(eng, timeout_s=30.0):
    """Drain the engine's offload jobs until none is in flight: the group-1
    stores are not awaited by ``flush_offload``, and an object store's
    shutdown cancels what is still queued."""
    handlers = eng.offload_handlers
    deadline = time.monotonic() + timeout_s
    while getattr(handlers, "_jobs", None) or getattr(handlers, "_pending", None):
        assert time.monotonic() < deadline, "offload jobs did not settle"
        eng.poll_offload()
        time.sleep(0.002)


def wait_job(handlers, job, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for res in handlers.get_finished():
            if res.job_id == job:
                return res
        time.sleep(0.002)
    raise AssertionError(f"offload job {job} did not settle")


def tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


PROMPT = np.random.default_rng(21).integers(1, 256, 30).tolist()  # 7 full blocks


def writer_pair(tmp_path, name, backend):
    """Two writers over their own stores. An object store sheds a put past
    its queue (io_threads x 4 puts in flight), and ``add_request`` submits
    every chunk's puts at once: on a loaded machine the two engines would
    shed different blocks and write different trees. The comparison is of
    what each writes, so both object stores take every put."""
    jcfg, _ = config_pair(layout(name))
    kw = dict(backend=backend, **({"parallel_agnostic": True} if backend == "object" else {}))
    pair = Pair(layout(name), num_pages=64, num_swa_pages=32, max_prefill_tokens=8,
                jax_spec=JaxSpec(**spec_kw(tmp_path / "jax", jcfg, **kw)),
                port_spec=SharedStorageOffloadSpec(**spec_kw(tmp_path / "port", jcfg, **kw)))
    for eng in (pair.jax, pair.port):
        if hasattr(eng.offload_handlers, "_put_slots"):
            eng.offload_handlers._put_slots = threading.Semaphore(1 << 16)
    return pair


@pytest.mark.parametrize("name", ["hybrid-1of2", "gemma_tiny"])
@pytest.mark.parametrize("backend", ["posix", "object"])
def test_both_groups_write_the_jax_files(tmp_path, name, backend):
    """The two engines' write-through stores hold the same files (paths,
    sizes, config.json bytes; payloads within fp32 summation order). Then,
    with the JAX engine's pool contents copied into the port's pools, the
    port engine's own handlers (its group-1 copier bound to its SWA pool)
    store every block again: every file byte-identical to the JAX engine's."""
    pair = writer_pair(tmp_path, name, backend)
    try:
        jr, tr = pair.both("add_request", "w", PROMPT, max_new_tokens=4)
        pair.run([(jr, tr)])
        for eng in (pair.jax, pair.port):
            settle(eng)
        pair.jax.offload_handlers.shutdown()
        want = tree_bytes(tmp_path / "jax")
        got = tree_bytes(tmp_path / "port")
        assert got.keys() == want.keys()
        for path, data in got.items():
            assert len(data) == len(want[path])
            if path.endswith("config.json"):
                assert data == want[path]
            else:  # fp32 words, then the CRC footer (4-byte CRC + "KVCK" trailer)
                words = len(data) - 12 if data[-8:-4] == b"KVCK" else len(data)
                np.testing.assert_allclose(np.frombuffer(data[:words], np.float32),
                                           np.frombuffer(want[path][:words], np.float32),
                                           rtol=1e-5, atol=1e-6)
        # Group 0: all 7 prompt blocks; group 1: the 2-block window at commit.
        if backend == "posix":
            groups = [p.split(os.sep)[-2][-2:] for p in got if p.endswith(".bin")]
            assert sorted(groups) == ["g0"] * 7 + ["g1"] * 2

        for dst, src in ((pair.port.k_cache, pair.jax.k_cache),
                         (pair.port.v_cache, pair.jax.v_cache),
                         (pair.port.k_swa, pair.jax.k_swa), (pair.port.v_swa, pair.jax.v_swa)):
            dst.copy_(torch.from_numpy(np.array(src)))
        for path in got:
            if not path.endswith("config.json"):
                os.unlink(tmp_path / "port" / path)
        handlers = pair.port.offload_handlers

        def stored(h, group):  # the block's file name in the store
            mapper = handlers.mapper
            if backend == "object":
                return mapper.block_key(h, group)
            return os.path.relpath(mapper.block_path(h, group), tmp_path / "port")

        for group, mgr in ((0, pair.port.block_manager), (1, pair.port.swa_manager)):
            job = handlers.async_store_blocks(
                [(h, [info.page]) for h, info in mgr.blocks.items()
                 if stored(h, group) in want], group_idx=group)
            assert wait_job(handlers, job).success
        handlers.shutdown()
        assert tree_bytes(tmp_path / "port") == want
    finally:
        for eng in (pair.jax, pair.port):
            eng.offload_handlers.shutdown()


def restorer(root, jcfg, tcfg, tree, port: bool, **kw):
    cfg_kw = dict(num_pages=64, num_swa_pages=32, max_pages_per_seq=16, model_name="fam",
                  **kw)
    if port:
        return engine.MiniEngine(engine.EngineConfig(model=tcfg, **cfg_kw), device="cpu",
                                 params=llama.params_from_jax(tree, tcfg, device="cpu"),
                                 offload_spec=SharedStorageOffloadSpec(**spec_kw(root, jcfg)))
    return jax_engine.MiniEngine(jax_engine.EngineConfig(model=jcfg, **cfg_kw),
                                 params=jax_params(tree),
                                 offload_spec=JaxSpec(**spec_kw(root, jcfg)))


def pool_words(eng, group, page):
    pools = ((eng.k_cache, eng.v_cache) if group == 0 else (eng.k_swa, eng.v_swa))
    return [np.asarray(p[:, page]) for p in pools]


@pytest.mark.parametrize("name", ["hybrid-1of2", "gemma_tiny"])
@pytest.mark.parametrize("writer_is_port", [False, True])
def test_restore_across_packages_is_all_or_nothing(tmp_path, name, writer_is_port):
    """One package writes, the other restores through ``add_request`` and,
    on a second pod, ``enqueue`` (a hybrid restore stays synchronous): the
    whole group-0 chain and the group-1 window only, pages bit-equal to the
    writer's, the writer's tokens."""
    jcfg, tcfg = config_pair(layout(name))
    tree = jax_tree(jcfg, seed=11)
    writer = restorer(tmp_path, jcfg, tcfg, tree, writer_is_port)
    out = writer.generate("w", PROMPT, max_new_tokens=5)
    settle(writer)
    for via in ("add_request", "enqueue"):
        reader = restorer(tmp_path, jcfg, tcfg, tree, not writer_is_port,
                          pod_identifier=f"pod-{via}")
        req = getattr(reader, via)("r", PROMPT, max_new_tokens=5)
        assert (req.cached_len, req.restored_blocks) == (28, 7)
        assert req.swa_pages[:5] == [0] * 5 and all(req.swa_pages[5:7])
        for i, h in enumerate(req.block_hashes):
            for group, mgr_w, mgr_r in ((0, writer.block_manager, reader.block_manager),
                                        (1, writer.swa_manager, reader.swa_manager)):
                if group == 1 and i < 5:
                    assert h not in mgr_r.blocks
                    continue
                got = pool_words(reader, group, mgr_r.blocks[h].page)
                want = pool_words(writer, group, mgr_w.blocks[h].page)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
        while not req.done:
            reader.step()
        assert req.output == out
        settle(reader)
        reader.offload_handlers.shutdown()
    writer.offload_handlers.shutdown()


def test_missing_window_skips_the_restore_as_jax(tmp_path):
    jcfg, tcfg = config_pair(layout("hybrid-1of2"))
    tree = jax_tree(jcfg, seed=12)
    writer = restorer(tmp_path, jcfg, tcfg, tree, True)
    out = writer.generate("w", PROMPT, max_new_tokens=4)
    settle(writer)
    writer.offload_handlers.shutdown()
    for port in (True, False):
        # (Each reader writes its own window through: delete it again.)
        for dirpath, _, files in os.walk(tmp_path):
            if dirpath.endswith("_g1"):
                for f in files:
                    os.unlink(os.path.join(dirpath, f))
        reader = restorer(tmp_path, jcfg, tcfg, tree, port)
        req = reader.add_request("r", PROMPT, max_new_tokens=4)
        assert (req.cached_len, req.restored_blocks) == (0, 0)
        while not req.done:
            reader.step()
        assert req.output == out
        settle(reader)
        reader.offload_handlers.shutdown()


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_ragged_scheduler_on_a_hybrid_model_raises():
    _, tcfg = config_pair(layout("gemma_tiny"))
    with pytest.raises(ValueError, match="hybrid model"):
        engine.MiniEngine(engine.EngineConfig(model=tcfg, ragged_attention=True), device="cpu")


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_roles_and_handoff_on_a_hybrid_model_raise_as_jax(tmp_path, role):
    jcfg, tcfg = config_pair(layout("gemma_tiny"))
    with pytest.raises(ValueError) as want:
        jax_engine.MiniEngine(jax_engine.EngineConfig(model=jcfg, role=role),
                              offload_spec=JaxSpec(**spec_kw(tmp_path / "j", jcfg)))
    with pytest.raises(ValueError) as got:
        engine.MiniEngine(engine.EngineConfig(model=tcfg, role=role), device="cpu",
                          offload_spec=SharedStorageOffloadSpec(**spec_kw(tmp_path / "p", jcfg)))
    assert str(got.value) == str(want.value)
    eng = engine.MiniEngine(engine.EngineConfig(model=tcfg), device="cpu",
                            offload_spec=SharedStorageOffloadSpec(**spec_kw(tmp_path / "p", jcfg)))
    try:
        with pytest.raises(ValueError, match="non-hybrid"):
            eng.set_role(role)
        assert eng.cfg.role == "both"
        with pytest.raises(ValueError, match="non-hybrid"):
            eng.enqueue("h", [1, 2, 3], handoff=True)
        assert not eng.requests
    finally:
        eng.offload_handlers.shutdown()


def test_offload_spec_with_sinks_on_a_hybrid_model_raises(tmp_path):
    jcfg, tcfg = config_pair(layout("gemma_tiny"))
    with pytest.raises(ValueError, match="attention_sinks=4 does not match the model's 0"):
        engine.MiniEngine(engine.EngineConfig(model=tcfg), device="cpu",
                          offload_spec=SharedStorageOffloadSpec(
                              **spec_kw(tmp_path, jcfg, attention_sinks=4)))


def test_pool_views_keep_group_order():
    """Group g's pool holds its layers in ``group_layers(g)`` order: a
    layer's K lands at its group-local index."""
    _, tcfg = config_pair(layout("gemma_tiny"))
    tparams = llama.init_params(tcfg, seed=0, device="cpu")
    pools = llama.init_kv_cache_hybrid(tcfg, 6, 6, device="cpu")
    k, v = llama.init_kv_cache(tcfg, 6, device="cpu")
    toks = torch.tensor([[3, 4, 5, 6, 7]])
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    ctx, new = torch.zeros(1, dtype=torch.int32), torch.full((1,), 5, dtype=torch.int32)
    llama.forward_hybrid(tparams, tcfg, toks, *pools, table, table, ctx, new)
    llama.forward(tparams, tcfg, toks, k, v, table, ctx, new)
    for j, li in enumerate(tcfg.group_layers(1)):
        torch.testing.assert_close(pools[2][j], k[li], rtol=0, atol=0)
