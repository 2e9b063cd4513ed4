"""The ranks of the spawned tensor-parallel tests, and ``spawn_tp``'s
handling of a rank that fails.

``parallel.mesh.spawn_tp`` starts each rank as a fresh process that imports
its function's module by name, so the rank functions live here, in a
module that imports no JAX: a rank then starts in ~3 s, not the ~8 s that
importing ``test_torch_tp`` (JAX and the JAX package) takes.
``test_torch_tp`` serves its gloo pair through ``serve_rank``.

A rank that raises, exits with no result or hangs fails the call, fast
(not at the deadline, unless the rank hangs), and the other rank is
stopped.
"""

import os
import time

import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.parallel import mesh

PROMPT_SEEDS = (0, 6, 8)
ENGINE = dict(num_pages=64, max_pages_per_seq=16, model_name="tp-test", pod_identifier="p",
              max_batch=3, max_prefill_tokens=8)


def traffic(eng):
    """One request alone, then two more (one sharing its prefix) batched."""
    rng = np.random.default_rng(PROMPT_SEEDS[0])
    first = rng.integers(1, 250, 24).tolist()
    outs = {"r0": eng.generate("r0", first, max_new_tokens=8)}
    more = [first[:16] + rng.integers(1, 250, 5).tolist(), rng.integers(1, 250, 11).tolist()]
    reqs = [eng.enqueue(f"r{i + 1}", p, max_new_tokens=6) for i, p in enumerate(more)]
    for _ in range(40):
        eng.step()
        if all(r.done for r in reqs):
            break
    outs.update({r.request_id: (list(r.output), r.cached_len) for r in reqs})
    return outs


def serve_rank(grp, kw, tree):
    """One rank of the pair: the port's tp engine over the JAX tree (numpy
    leaves), fp32; its tokens, its events and its pool."""
    torch.set_num_threads(2)
    cfg = llama.LlamaConfig(**kw, dtype=torch.float32)
    events = []
    eng = engine.MiniEngine(engine.EngineConfig(model=cfg, **ENGINE), event_sink=events.extend,
                            params=llama.params_from_jax(tree, cfg, device="cpu"),
                            device="cpu", tp=grp)
    return dict(outs=traffic(eng), events=events, k_cache=eng.k_cache.numpy(),
                k_heads=eng.k_cache.shape[2])


def failing_rank(grp, how):
    """Rank 1 raises, exits with no result or hangs; rank 0 waits in a
    collective rank 1 never joins."""
    if grp.rank == 1:
        if how == "raise":
            raise ValueError("rank 1 refuses")
        if how == "exit":
            os._exit(3)
        time.sleep(120)
    grp.all_reduce_(torch.zeros(1))
    return "unreachable"


@pytest.mark.parametrize("how,error,match,within_s", [
    pytest.param("raise", RuntimeError, r"tp rank \d failed", 30, id="raise"),
    pytest.param("exit", RuntimeError, r"tp rank \d (failed|exited with code)", 30, id="exit"),
    pytest.param("hang", TimeoutError, r"gave no result in 8 s", 30, id="hang"),
])
def test_spawn_tp_fails_when_a_rank_fails(how, error, match, within_s):
    t = time.monotonic()
    with pytest.raises(error, match=match):
        mesh.spawn_tp(failing_rank, 2, backend="gloo", devices=["cpu", "cpu"], args=(how,),
                      timeout_s=8 if how == "hang" else 120, collective_timeout_s=60)
    assert time.monotonic() - t < within_s
