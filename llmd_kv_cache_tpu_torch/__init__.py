"""llmd_kv_cache_tpu_torch — the PyTorch/CUDA port of ``llmd_kv_cache_tpu``.

The JAX package beside this one is the reference; this package mirrors its
layout and module names so each counterpart is found at the same path:

- ``core/``, ``index/``, ``events/``, ``scoring/``, ``utils/`` — block-key
  hashing, the in-memory index, synchronous event ingestion and
  longest-prefix scoring. Byte-compatible copies (block keys and events are
  identical to the JAX package's); this package imports nothing of it.
- ``ops/`` — paged KV scatter/gather, the plain paged attention, and the
  hand-written Hopper (sm_90a) prefill and decode kernels in ``csrc/``.
- ``models/`` — the dense GQA Llama over a paged bf16 KV pool and the
  ``MiniEngine`` pod that serves it with prefix caching and KV events.

Only torch, numpy and the standard library are imported. Entry points
(``models.llama.init_params``, ``models.engine.MiniEngine``) run on the
card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
