"""The recovery and control planes around pods on the card.

Needs an NVIDIA Hopper GPU and ``nvcc`` (the pods run the hand-written
kernels); elsewhere it skips. On a machine with the card, which has no JAX
(hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_recovery.py -q

``chip_smoke``'s phase 23 at a small width: pods of a 2-layer model feed an
``IndexerService`` that snapshots, journals, is abandoned and warm-restarts
into the control's state (degraded and 503 while warming, ready once live
events arrive); a service that missed two batches audits exactly their
ghost and phantom rows and repairs them, as a sharded replica does over
its peers; a drain with store jobs in flight completes and a fresh pod
restores the flushed prefix bit-equal; a deployment's state (cut to 2,048
blocks a pod) snapshots and restores; and the fleet controller re-roles one
pod over admin HTTP, once. Every pod's attention launches a kernel: the
prefill kernel once a layer a chunk, the decode kernel once a layer a step,
no other kernel and no plain call.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# A small model the kernels take: head_dim 128, GQA group 2, page 16.
MODEL = dict(vocab_size=32000, hidden_size=256, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=128, intermediate_size=512, page_size=16)


def test_phase_23_at_a_small_width_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pods run the hand-written kernels)")
    import chip_smoke
    from llmd_kv_cache_tpu_torch.models.llama import LlamaConfig
    from llmd_kv_cache_tpu_torch.ops import cuda_paged_attention as ops

    out = chip_smoke.recovery_path(torch, ops, "test", model=LlamaConfig(**MODEL),
                                   device="cuda", state_blocks=2048)
    parts = out["parts"]
    for part in ("a", "c", "e"):
        assert parts[part]["prefill"] == 2 * parts[part]["prefill_chunks"] > 0
        assert parts[part]["decode"] == 2 * parts[part]["decode_steps"] > 0
    assert out["drain"]["completed"] and out["drain"]["restored_tokens"] == 4096
    assert out["control"]["posts"] == {"pod-c0": 0, "pod-c1": 0, "pod-c2": 1}
    assert out["state"]["entries"] == 8 * 2048 + 4 * 260
