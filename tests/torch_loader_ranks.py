"""The ranks of the loader and checkpoint tests' spawned tp pairs.

``parallel.mesh.spawn_tp`` starts each rank as a fresh process that imports
its function's module by name, so the rank function lives in a module that
imports no JAX and no transformers (a rank then starts in seconds).
"""

import tempfile

import torch

from llmd_kv_cache_tpu_torch.models import checkpoint, engine, hf_loader

ENGINE = dict(num_pages=64, max_pages_per_seq=16, pod_identifier="p")


def serve_loaded_rank(grp, path, kind, prompt, max_new_tokens):
    """One rank: the model of an HF checkpoint directory (``kind`` "hf",
    fp32, page 4) or of an engine checkpoint ("engine") loaded on the host,
    served by ``MiniEngine(tp=grp)``; its tokens, the block keys of its
    prompt, its BlockStored hashes, and the message with which saving its
    shard tree was refused (None if it was not)."""
    torch.set_num_threads(2)
    if kind == "hf":
        cfg, params = hf_loader.load_hf_checkpoint(path, page_size=4, dtype=torch.float32,
                                                   device="cpu")
        name, seed = "hf", ""
    else:
        params, cfg, name, seed = checkpoint.load_engine_checkpoint(path, device="cpu")
    events = []
    eng = engine.MiniEngine(engine.EngineConfig(model=cfg, model_name=name, hash_seed=seed,
                                                **ENGINE),
                            event_sink=events.extend, params=params, device="cpu", tp=grp)
    req = eng.add_request("r", prompt, max_new_tokens=max_new_tokens)
    while not req.done:
        eng.step()
    refusal = None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            checkpoint.save_engine_checkpoint(tmp, eng.params, eng.cfg.model, name, seed)
        except ValueError as exc:
            refusal = str(exc)
    stored = [h for e in events for h in getattr(e, "block_hashes", ())
              if type(e).__name__ == "BlockStoredEvent"]
    return dict(tokens=list(req.output), block_hashes=list(req.block_hashes), stored=stored,
                refusal=refusal)
