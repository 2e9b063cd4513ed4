"""Model loading straight to the card.

These tests need an NVIDIA GPU (elsewhere they skip). On a machine with the
card, which has no JAX and no transformers (hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_loader.py -q

- A small HF checkpoint (a Qwen3 layout, written in-process with the port's
  own writer in HF's names and ``[out, in]`` layout, sharded with an index)
  loads with ``load_hf_checkpoint`` and its defaults: every leaf lies on the
  card, equal bit for bit to the same load on the CPU, and a pod on the
  loaded tree serves the tokens of a pod on the CPU-loaded tree moved to
  the card.
- An engine checkpoint of that tree loads with ``load_engine_checkpoint``'s
  defaults onto the card, equal to the saved tree.
"""

import json

import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu_torch.models import checkpoint, engine, hf_loader, llama
from llmd_kv_cache_tpu_torch.utils import safetensors as st

pytestmark = pytest.mark.cuda

# A small model the kernels take: head_dim 128, GQA group 2, page 16.
MODEL = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=128, intermediate_size=512, page_size=16, qk_norm=True,
             rope_theta=1e6, norm_eps=1e-6)
CONFIG_JSON = {"model_type": "qwen3", "vocab_size": 512, "hidden_size": 256,
               "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 128, "intermediate_size": 512, "rope_theta": 1e6,
               "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
               "use_sliding_window": False, "torch_dtype": "bfloat16"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the loader's default device is the card")
    from llmd_kv_cache_tpu_torch.ops import cuda_build

    cuda_build.load_library()


def hf_names(params):
    """The seeded tree in HF's names and ``[out, in]`` layout."""
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight":
           params["final_norm"], "lm_head.weight": params["lm_head"].t()}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        for ours, theirs in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                             ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                             ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                             ("w_down", "mlp.down_proj")):
            out[p + theirs + ".weight"] = layer[ours].t()
        for ours, theirs in (("attn_norm", "input_layernorm"),
                             ("mlp_norm", "post_attention_layernorm"),
                             ("q_norm", "self_attn.q_norm"), ("k_norm", "self_attn.k_norm")):
            out[p + theirs + ".weight"] = layer[ours]
    return {k: v.contiguous() for k, v in out.items()}


def write_checkpoint(path, params):
    tensors = hf_names(params)
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    for file, keys in shards.items():
        st.save_file({k: tensors[k] for k in keys}, str(path / file),
                     metadata={"format": "pt"})
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    (path / "config.json").write_text(json.dumps(CONFIG_JSON))


def tokens_of(params, cfg, device, prompt):
    eng = engine.MiniEngine(engine.EngineConfig(model=cfg, num_pages=64, max_pages_per_seq=8,
                                                model_name="q", pod_identifier="p"),
                            params=params, device=device)
    return eng.generate("r", prompt, max_new_tokens=6)


def test_hf_checkpoint_loads_to_the_card_by_default(card, tmp_path):
    cfg = llama.LlamaConfig(**MODEL)
    seeded = llama.init_params(cfg, seed=3, device="cpu")
    for layer in seeded["layers"]:
        layer["q_norm"] = torch.rand(128) + 0.5
    write_checkpoint(tmp_path, seeded)
    got_cfg, params = hf_loader.load_hf_checkpoint(str(tmp_path))
    assert got_cfg == cfg
    host_cfg, host = hf_loader.load_hf_checkpoint(str(tmp_path), device="cpu")
    leaves, host_leaves = llama.flatten_params(params), llama.flatten_params(host)
    for k, v in leaves.items():
        assert v.device.type == "cuda", k
        assert v.dtype == host_leaves[k].dtype and torch.equal(v.cpu(), host_leaves[k]), k
        assert torch.equal(host_leaves[k], llama.flatten_params(seeded)[k]), k
    prompt = np.random.default_rng(0).integers(1, 500, 40).tolist()
    moved = {**host, "layers": [{k: v.cuda() for k, v in lyr.items()}
                                for lyr in host["layers"]],
             **{k: host[k].cuda() for k in ("embed", "final_norm", "lm_head")}}
    assert tokens_of(params, got_cfg, "cuda", prompt) == tokens_of(moved, host_cfg, "cuda",
                                                                   prompt)


def test_engine_checkpoint_loads_to_the_card_by_default(card, tmp_path):
    cfg = llama.LlamaConfig(**MODEL)
    seeded = llama.init_params(cfg, seed=4)  # on the card: the default
    assert seeded["embed"].device.type == "cuda"
    checkpoint.save_engine_checkpoint(str(tmp_path), seeded, cfg, "q", "s")
    params, cfg2, name, seed = checkpoint.load_engine_checkpoint(str(tmp_path))
    assert (cfg2, name, seed) == (cfg, "q", "s")
    want = llama.flatten_params(seeded)
    for k, v in llama.flatten_params(params).items():
        assert v.device.type == "cuda" and torch.equal(v, want[k]), k
