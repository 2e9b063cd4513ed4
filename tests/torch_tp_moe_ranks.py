"""The ranks of ``tests/test_torch_tp_moe.py``'s spawned pairs.

``parallel.mesh.spawn_tp`` starts each rank as a fresh process that imports
its function's module by name, so the rank function lives in a module that
imports no JAX (a rank then starts in seconds).
"""

import torch

from llmd_kv_cache_tpu_torch.models import engine, llama

from test_torch_tp_ranks import ENGINE, traffic


def serve_moe_rank(grp, kw, tree, fuse, control=False):
    """One rank: the port's tp engine over the JAX tree (numpy leaves) at
    fp32 with ``fuse_projections=fuse``; its tokens, events, first layer's
    leaves and interleave. ``control``: the rank splits its local fused
    outputs with the whole tree's interleave (t = tp), as JAX splits the
    global output, instead of its own block's (1)."""
    torch.set_num_threads(2)
    if control:
        llama._rank_interleave = lambda cfg, tp: cfg.fused_interleave
    cfg = llama.LlamaConfig(**kw, dtype=torch.float32)
    events = []
    eng = engine.MiniEngine(engine.EngineConfig(model=cfg, fuse_projections=fuse, **ENGINE),
                            event_sink=events.extend,
                            params=llama.params_from_jax(tree, cfg, device="cpu"),
                            device="cpu", tp=grp)
    return dict(outs=traffic(eng), events=events, keys=sorted(eng.params["layers"][0]),
                interleave=eng.cfg.model.fused_interleave,
                marker=eng.params.get("fused_interleave"))
