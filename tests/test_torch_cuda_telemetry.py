"""Engine telemetry on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the pods run the
hand-written kernels); elsewhere they skip. On a machine with the card,
which has no JAX (hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_telemetry.py -q

- A ``ProfilerCapture`` of 0.5 s on a thread of its own, while a pod
  decodes on the test's thread (fresh rows whenever the last finish: the
  first session's set-up has taken 13 s), writes a Chrome trace that names
  the GQA decode kernel; a second capture during it raises
  ``ProfileInProgress``.
- A burst pod with telemetry on (bursts of 4 replayed from its CUDA graph)
  gives the tokens of the same pod with telemetry off, and its hooks saw
  every token.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu_torch.models import engine, llama
from llmd_kv_cache_tpu_torch.telemetry import EngineTelemetryConfig, ProfileInProgress

pytestmark = pytest.mark.cuda

# A small model the kernels take: head_dim 128, GQA group 2, page 16.
MODEL = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=128, intermediate_size=512, page_size=16)
PROMPTS = [np.random.default_rng(i).integers(1, 512, 40 + 7 * i).tolist() for i in range(4)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pods run the hand-written kernels)")
    return torch.device("cuda")


def pod(card, params, telemetry, tmp_path=None, **cfg_kw):
    model = llama.LlamaConfig(**MODEL)
    tel = EngineTelemetryConfig(profile_dir=str(tmp_path or "")) if telemetry else None
    return engine.MiniEngine(
        engine.EngineConfig(model=model, num_pages=128, max_pages_per_seq=16,
                            max_prefill_tokens=32, telemetry=tel, **cfg_kw),
        params=params, device=card)


def test_profiler_capture_names_the_decode_kernel(card, tmp_path):
    params = llama.init_params(llama.LlamaConfig(**MODEL), seed=0, device=card)
    eng = pod(card, params, True, tmp_path)
    waves = [0]

    def wave():
        """Rows decoding until the capture ends: its start (Kineto's set-up)
        may take seconds."""
        waves[0] += 1
        rows = [eng.enqueue(f"r{waves[0]}-{i}", p, max_new_tokens=120)
                for i, p in enumerate(PROMPTS)]
        while any(r.prefill_pos is not None for r in rows):
            eng.step()
        return rows

    reqs = wave()
    prof = eng.telemetry.profiler
    result, errors = {}, []

    def capture():
        try:
            result.update(prof.capture(0.5))
        except Exception as exc:  # reported below
            errors.append(exc)

    th = threading.Thread(target=capture)
    th.start()
    deadline = time.monotonic() + 5.0
    while not prof._lock.locked() and th.is_alive() and time.monotonic() < deadline:
        time.sleep(0.001)
    with pytest.raises(ProfileInProgress):
        prof.capture(0.1)
    while th.is_alive():
        if all(r.done for r in reqs):
            reqs = wave()
        eng.step()
    th.join()
    assert not errors
    with open(result["trace"]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    assert any("decode_kernel" in k for k in kernels)
    assert eng.telemetry.debug_vars()["last_profile"]["trace"] == result["trace"]


def test_burst_graph_with_telemetry_gives_the_same_tokens(card):
    params = llama.init_params(llama.LlamaConfig(**MODEL), seed=0, device=card)
    outs = []
    for telemetry in (True, False):
        eng = pod(card, params, telemetry, decode_burst=4)
        reqs = [eng.enqueue(f"r{i}", p, max_new_tokens=11) for i, p in enumerate(PROMPTS)]
        while not all(r.done for r in reqs):
            eng.step()
        assert eng._burst_graph is not None
        outs.append([r.output for r in reqs])
        if telemetry:
            dv = eng.telemetry.debug_vars()
            assert dv["phases"]["ttft_seconds"]["count"] >= len(PROMPTS)
            assert sum(s["tokens"] for s in dv["requests"]["recent"]) == 11 * len(PROMPTS)
    assert outs[0] == outs[1]
