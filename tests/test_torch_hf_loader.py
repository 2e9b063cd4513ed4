"""The port's HF checkpoint loader against the JAX package's and transformers.

For every test of ``tests/test_hf_loader.py`` a counterpart: a random-init
transformers model is the oracle. The port's ``config_from_hf`` equals JAX's
field by field, the port's ``params_from_hf`` leaves equal JAX's (fp32,
exact), and the port's forward at fp32 on the CPU matches transformers'
logits at JAX's tolerances (rtol = atol = 2e-4, 3e-4 where JAX uses it), with
the argmax equal at every position.

The disk path: ``save_pretrained`` writes single-file, sharded and ``.bin``
checkpoints; ``load_hf_checkpoint(..., device="cpu")`` reads them with no
transformers code (the in-repo ``config.json`` reader and safetensors codec),
and ``MiniEngine`` then generates transformers' greedy tokens. A
``config.json`` reduced to the keys that differ from its class's defaults
gives JAX's config for each of the eight ``model_type``s, and the reader's
attributes equal transformers' class defaults.
"""

import concurrent.futures
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from llmd_kv_cache_tpu.models import hf_loader as jax_loader  # noqa: E402
from llmd_kv_cache_tpu_torch.models import hf_loader, llama  # noqa: E402
from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine  # noqa: E402
from llmd_kv_cache_tpu_torch.parallel import mesh  # noqa: E402

from torch_loader_ranks import serve_loaded_rank  # noqa: E402


def assert_config_equal(got, want):
    """The port's LlamaConfig equals JAX's, field by field (dtype by name)."""
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert str(g).removeprefix("torch.") == jnp.dtype(w).name
        else:
            assert g == w, (f.name, g, w)


def assert_params_equal(got, want):
    """Every leaf of the port's tree equals JAX's exactly, the same keys."""
    assert set(got) == set(want)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert len(got["layers"]) == len(want["layers"])
    for li, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert set(g) == set(w), li
        for k in w:
            assert g[k].dtype == torch.float32, (li, k)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=f"layer {li} {k}")


def port_logits(cfg, params, tokens):
    """The port's forward over a fresh paged pool: every position's logits."""
    n, page = len(tokens), cfg.page_size
    padded = -(-n // page) * page
    pages = padded // page + 1
    tok = torch.zeros((1, padded), dtype=torch.int64)
    tok[0, :n] = torch.tensor(tokens)
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None, :]
    ctx, new = torch.tensor([0], dtype=torch.int32), torch.tensor([n], dtype=torch.int32)
    if cfg.is_hybrid:
        k0, v0, k1, v1 = llama.init_kv_cache_hybrid(cfg, pages + 2, pages + 2, device="cpu")
        logits = llama.forward_hybrid(params, cfg, tok, k0, v0, k1, v1, table, table, ctx,
                                      new)[0]
    else:
        k, v = llama.init_kv_cache(cfg, pages + 2, device="cpu")
        logits = llama.forward(params, cfg, tok, k, v, table, ctx, new)[0]
    return logits[0, :n].float().numpy()


def check_family(hf_cfg, model, seed, n, tol=2e-4):
    """The three checks of a family: configs, params and logits. Returns the
    port's config and tree."""
    jcfg = jax_loader.config_from_hf(hf_cfg, page_size=4, dtype=jnp.float32)
    tcfg = hf_loader.config_from_hf(hf_cfg, page_size=4, dtype=torch.float32)
    assert_config_equal(tcfg, jcfg)
    interleaved = getattr(hf_cfg, "rope_interleave", True)
    sd = model.state_dict()
    jp = jax_loader.params_from_hf(sd, jcfg, mla_rope_interleaved=interleaved)
    tp = hf_loader.params_from_hf(sd, tcfg, mla_rope_interleaved=interleaved, device="cpu")
    assert_params_equal(tp, jp)
    tokens = np.random.default_rng(seed).integers(1, 250, n).tolist()
    with torch.no_grad():
        ref = model(torch.tensor([tokens])).logits[0].float().numpy()
    ours = port_logits(tcfg, tp, tokens)
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
    return tcfg, tp


def build_llama(vocab=256, hidden=64, inter=128, layers=2, heads=4, kv=2, hd=16, tie=False,
                window=None, seed=0):
    """The JAX tests' ``_build_hf``: a Llama, or a Mistral with a window."""
    torch.manual_seed(seed)
    if window is not None:
        hf_cfg = transformers.MistralConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
            num_hidden_layers=layers, num_attention_heads=heads, num_key_value_heads=kv,
            head_dim=hd, rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=window,
            tie_word_embeddings=tie)
        return hf_cfg, transformers.MistralForCausalLM(hf_cfg).eval()
    hf_cfg = transformers.LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
        num_hidden_layers=layers, num_attention_heads=heads, num_key_value_heads=kv,
        head_dim=hd, rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=False,
        mlp_bias=False, tie_word_embeddings=tie)
    return hf_cfg, transformers.LlamaForCausalLM(hf_cfg).eval()


def qwen3(seed=5):
    torch.manual_seed(seed)
    hf_cfg = transformers.Qwen3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False)
    return hf_cfg, transformers.Qwen3ForCausalLM(hf_cfg).eval()


def qwen2(seed=8, **kw):
    torch.manual_seed(seed)
    hf_cfg = transformers.Qwen2Config(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
        use_sliding_window=False, tie_word_embeddings=False), **kw})
    return hf_cfg, transformers.Qwen2ForCausalLM(hf_cfg).eval()


MLA = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=16, qk_rope_head_dim=8,
           qk_nope_head_dim=16, v_head_dim=16, rms_norm_eps=1e-5, rope_theta=10000.0,
           first_k_dense_replace=2, tie_word_embeddings=False)


def deepseek(which, seed, **kw):
    torch.manual_seed(seed)
    cls, model_cls = ((transformers.DeepseekV2Config, transformers.DeepseekV2ForCausalLM)
                      if which == "v2" else
                      (transformers.DeepseekV3Config, transformers.DeepseekV3ForCausalLM))
    hf_cfg = cls(**{**MLA, **kw})
    return hf_cfg, model_cls(hf_cfg).eval()


def mixtral(seed=9):
    torch.manual_seed(seed)
    hf_cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    return hf_cfg, transformers.MixtralForCausalLM(hf_cfg).eval()


def qwen3_moe(seed=21, **kw):
    torch.manual_seed(seed)
    hf_cfg = transformers.Qwen3MoeConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
        rope_theta=10000.0, num_experts=4, num_experts_per_tok=2, norm_topk_prob=False,
        moe_intermediate_size=32, decoder_sparse_step=1, mlp_only_layers=[0],
        tie_word_embeddings=False, use_sliding_window=False), **kw})
    return hf_cfg, transformers.Qwen3MoeForCausalLM(hf_cfg).eval()


def deepseek_moe(seed=19):
    torch.manual_seed(seed)
    hf_cfg = transformers.DeepseekV3Config(**{**MLA, **dict(
        num_hidden_layers=3, q_lora_rank=None, first_k_dense_replace=1, n_routed_experts=8,
        num_experts_per_tok=2, n_group=4, topk_group=2, norm_topk_prob=True,
        routed_scaling_factor=2.5, n_shared_experts=1, moe_intermediate_size=32)})
    model = transformers.DeepseekV3ForCausalLM(hf_cfg).eval()
    with torch.no_grad():  # engage the bias-corrected selection path
        for li in (1, 2):
            model.model.layers[li].mlp.gate.e_score_correction_bias.copy_(torch.randn(8) * 0.5)
    return hf_cfg, model


# --- the counterparts of tests/test_hf_loader.py ---

@pytest.mark.parametrize("tie", [False, True])
def test_llama_logits_match_transformers(tie):
    hf_cfg, model = build_llama(tie=tie)
    check_family(hf_cfg, model, seed=0, n=21)


def test_mistral_sliding_window_matches_transformers():
    hf_cfg, model = build_llama(window=8)
    cfg, _ = check_family(hf_cfg, model, seed=1, n=20)
    assert cfg.sliding_window == 8 and len(cfg.swa_layers) == cfg.num_layers


def test_qwen3_qk_norm_matches_transformers():
    hf_cfg, model = qwen3()
    cfg, params = check_family(hf_cfg, model, seed=4, n=18)
    assert cfg.qk_norm and "q_norm" in params["layers"][0]


def test_qwen2_partial_window_layer_types():
    torch.manual_seed(6)
    hf_cfg = transformers.Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=8, use_sliding_window=True, max_window_layers=2,
        tie_word_embeddings=False)
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    cfg, _ = check_family(hf_cfg, model, seed=5, n=20)
    assert cfg.swa_layers == (2, 3) and cfg.sliding_window == 8 and cfg.is_hybrid


def test_llama3_rope_scaling_matches_transformers():
    torch.manual_seed(12)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
        rope_theta=10000.0, max_position_embeddings=256, attention_bias=False,
        mlp_bias=False, tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 32})
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg, _ = check_family(hf_cfg, model, seed=11, n=48, tol=3e-4)
    assert cfg.rope_scaling[0] == "llama3"


def test_yarn_rope_scaling_matches_transformers():
    hf_cfg, model = qwen2(seed=15, max_position_embeddings=512,
                          rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                        "original_max_position_embeddings": 32})
    cfg, _ = check_family(hf_cfg, model, seed=15, n=48, tol=3e-4)
    assert cfg.rope_scaling[0] == "yarn" and cfg.rope_scaling[5] > 1.0


def refusal(fn, *args, **kwargs):
    """``(type, message)`` of what ``fn`` raises."""
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value), str(info.value)


def test_unsupported_features_raise_as_jax():
    """Each refusal raises with JAX's exception type and message: rope
    scalings, MLP biases, an unknown model_type, the DeepSeek refusals, and
    tensors with no slot in the model."""
    base = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                num_attention_heads=2, num_key_value_heads=2)
    cases = [
        transformers.LlamaConfig(**base, rope_scaling={"rope_type": "linear", "factor": 2.0}),
        transformers.LlamaConfig(**base, rope_scaling={"type": "dynamic", "factor": 2.0}),
        transformers.LlamaConfig(**base, mlp_bias=True),
        transformers.LlamaConfig(**base, hidden_act="gelu"),
        transformers.LlamaConfig(**base, num_experts=4),
        type("G", (), dict(transformers.LlamaConfig(**base).to_dict(), model_type="gemma2",
                           num_hidden_layers=1))(),
        transformers.Qwen2Config(**base, use_sliding_window=True, sliding_window=4,
                                 layer_types=["chunked_attention"]),
        transformers.DeepseekV3Config(**{**MLA, "v_head_dim": 8}),
        transformers.DeepseekV2Config(**{**MLA, "first_k_dense_replace": 1,
                                         "n_routed_experts": 4}),
        transformers.DeepseekV3Config(**{**MLA, "first_k_dense_replace": 1,
                                         "n_routed_experts": 8, "topk_method": "greedy"}),
        transformers.DeepseekV3Config(**{**MLA, "rope_scaling": {
            "rope_type": "yarn", "factor": 4.0, "truncate": False,
            "original_max_position_embeddings": 32}}),
    ]
    for hf_cfg in cases:
        want = refusal(jax_loader.config_from_hf, hf_cfg)
        assert refusal(hf_loader.config_from_hf, hf_cfg) == want
        assert want[0] is NotImplementedError
    hf_cfg, model = build_llama(vocab=64, hidden=32, inter=64, layers=1, heads=2, kv=2, hd=16)
    jcfg = jax_loader.config_from_hf(hf_cfg, dtype=jnp.float32)
    tcfg = hf_loader.config_from_hf(hf_cfg, dtype=torch.float32)
    for extra in ("model.layers.0.self_attn.o_proj.bias",
                  "model.layers.0.pre_feedforward_layernorm.weight"):
        sd = dict(model.state_dict())
        sd[extra] = torch.zeros(32)
        want = refusal(jax_loader.params_from_hf, sd, jcfg)
        assert refusal(hf_loader.params_from_hf, sd, tcfg, device="cpu") == want
        assert want[0] is NotImplementedError and "unmapped" in want[1]
    # A non-persistent rotary buffer is the one tensor left unmapped.
    sd = dict(model.state_dict(), **{"model.rotary_emb.inv_freq": torch.ones(8)})
    hf_loader.params_from_hf(sd, tcfg, device="cpu")


def test_qwen2_tp_serve_with_biases(tmp_path):
    """QKV biases shard column-parallel under tp: a Qwen2 checkpoint loaded
    on the host serves at tp 2 (a spawned gloo pair) with the tokens of tp 1
    and of transformers."""
    hf_cfg, model = qwen2(seed=8)
    cfg, params = check_family(hf_cfg, model, seed=6, n=16)
    assert "bq" in params["layers"][0]
    model.save_pretrained(tmp_path)
    prompt = np.random.default_rng(6).integers(1, 250, 16).tolist()
    with concurrent.futures.ThreadPoolExecutor(1) as waiter:
        pair = waiter.submit(mesh.spawn_tp, serve_loaded_rank, 2, backend="gloo",
                             devices=["cpu", "cpu"], args=(str(tmp_path), "hf", prompt, 6),
                             timeout_s=240, collective_timeout_s=120)
        eng = MiniEngine(EngineConfig(model=cfg, num_pages=64, max_pages_per_seq=16,
                                      model_name="hf", pod_identifier="p"),
                         params=params, device="cpu")
        ref = eng.generate("r", prompt, max_new_tokens=6)
        ranks = pair.result()
    with torch.no_grad():
        hf_tokens = model.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False,
                                   pad_token_id=0)[0, len(prompt):].tolist()
    assert ref == hf_tokens
    assert [r["tokens"] for r in ranks] == [ref, ref]


def test_deepseek_q_lora_matches_transformers():
    hf_cfg, model = deepseek("v3", 14, q_lora_rank=24)
    _, params = check_family(hf_cfg, model, seed=13, n=18, tol=3e-4)
    assert "w_dq" in params["layers"][0]


def test_deepseek_v2_yarn_matches_transformers():
    hf_cfg, model = deepseek("v2", 18, q_lora_rank=None, max_position_embeddings=512,
                             rope_scaling={"rope_type": "yarn", "factor": 4.0, "mscale": 0.707,
                                           "mscale_all_dim": 0.707,
                                           "original_max_position_embeddings": 32})
    cfg, _ = check_family(hf_cfg, model, seed=18, n=44, tol=3e-4)
    assert cfg.softmax_scale_mult == 1.0


def test_qwen3_moe_matches_transformers():
    hf_cfg, model = qwen3_moe()
    cfg, params = check_family(hf_cfg, model, seed=21, n=19, tol=3e-4)
    assert cfg.moe_layers == (1, 2) and cfg.moe_router == ("softmax_topk", 0) and cfg.qk_norm
    assert "router" not in params["layers"][0] and "router_bias" not in params["layers"][1]


def test_qwen3_moe_norm_topk_matches_transformers():
    hf_cfg, model = qwen3_moe(seed=22, num_hidden_layers=2, norm_topk_prob=True,
                              mlp_only_layers=[])
    cfg, _ = check_family(hf_cfg, model, seed=22, n=17, tol=3e-4)
    assert cfg.moe_router == ("softmax_topk", 1)


def test_deepseek_moe_matches_transformers():
    hf_cfg, model = deepseek_moe()
    cfg, params = check_family(hf_cfg, model, seed=19, n=21, tol=3e-4)
    assert cfg.moe_layers == (1, 2) and cfg.moe_router[0] == "deepseek_v3"
    assert "router" not in params["layers"][0] and "w_gate_sh" in params["layers"][1]


def test_deepseek_yarn_matches_transformers():
    hf_cfg, model = deepseek("v3", 16, q_lora_rank=24, max_position_embeddings=512,
                             rope_scaling={"rope_type": "yarn", "factor": 4.0, "mscale": 1.0,
                                           "mscale_all_dim": 1.0, "beta_fast": 32,
                                           "beta_slow": 1,
                                           "original_max_position_embeddings": 32})
    cfg, _ = check_family(hf_cfg, model, seed=16, n=48, tol=3e-4)
    assert cfg.rope_scaling[0] == "yarn" and cfg.softmax_scale_mult > 1.0


@pytest.mark.parametrize("which", ["v2", "v3"])
def test_deepseek_mla_matches_transformers(which):
    hf_cfg, model = deepseek(which, 7, q_lora_rank=None)
    cfg, params = check_family(hf_cfg, model, seed=8, n=19, tol=3e-4)
    assert cfg.is_mla and cfg.kv_lora_rank == 16 and "latent_norm" in params["layers"][0]


def test_mixtral_moe_matches_transformers():
    hf_cfg, model = mixtral()
    cfg, params = check_family(hf_cfg, model, seed=9, n=17, tol=3e-4)
    assert cfg.num_experts == 4 and cfg.moe_dispatch == "dense"
    assert tuple(params["layers"][0]["w_gate"].shape) == (4, 64, 128)


def hf_greedy(model, prompt, n):
    with torch.no_grad():
        return model.generate(torch.tensor([prompt]), max_new_tokens=n, do_sample=False,
                              pad_token_id=0)[0, len(prompt):].tolist()


def served(cfg, params, prompt, n):
    eng = MiniEngine(EngineConfig(model=cfg, num_pages=64, max_pages_per_seq=16,
                                  model_name="ckpt", pod_identifier="p"),
                     params=params, device="cpu")
    return eng.generate("r", prompt, max_new_tokens=n)


# The checkpoints the disk path reads: save_pretrained's keyword arguments.
FORMATS = {"safetensors": {}, "sharded": dict(max_shard_size="40KB"),
           "bin": dict(safe_serialization=False),
           "bin-sharded": dict(safe_serialization=False, max_shard_size="40KB")}
FILES = {"safetensors": {"model.safetensors"},
         "sharded": {"model.safetensors.index.json"},
         "bin": {"pytorch_model.bin"}, "bin-sharded": {"pytorch_model.bin.index.json"}}
DISK_MODELS = {
    "llama": lambda: build_llama(seed=10),
    "llama-tied": lambda: build_llama(seed=11, tie=True),
    "qwen2-biases": lambda: qwen2(seed=12),
    "deepseek-v3-q-lora": lambda: deepseek("v3", 13, q_lora_rank=24),
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", DISK_MODELS)
def test_load_checkpoint_directory_roundtrip(tmp_path, fmt, family):
    """The disk path: save_pretrained -> load_hf_checkpoint (the in-repo
    reader, no transformers) -> serve: the config is JAX's for the
    transformers config, the tree is the state dict's conversion, and the
    engine generates transformers' greedy tokens."""
    hf_cfg, model = DISK_MODELS[family]()
    model.save_pretrained(tmp_path, **FORMATS[fmt])
    assert FILES[fmt] <= set(os.listdir(tmp_path)), os.listdir(tmp_path)
    cfg, params = hf_loader.load_hf_checkpoint(str(tmp_path), page_size=4,
                                               dtype=torch.float32, device="cpu")
    assert_config_equal(cfg, jax_loader.config_from_hf(hf_cfg, page_size=4,
                                                       dtype=jnp.float32))
    want = hf_loader.params_from_hf(model.state_dict(), cfg, device="cpu")
    got, ref = llama.flatten_params(params), llama.flatten_params(want)
    assert list(got) == list(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    prompt = np.random.default_rng(7).integers(1, 250, 12).tolist()
    assert served(cfg, params, prompt, 4) == hf_greedy(model, prompt, 4)


def test_load_checkpoint_bf16_casts_on_read(tmp_path):
    """A bf16 checkpoint loads at bf16 bit for bit (the JAX conversion's
    upcast to fp32 and back is exact), and at fp32 exactly upcast."""
    hf_cfg, model = build_llama(seed=4)
    model.to(torch.bfloat16).save_pretrained(tmp_path)
    sd = model.state_dict()
    cfg, params = hf_loader.load_hf_checkpoint(str(tmp_path), page_size=4, device="cpu")
    assert cfg.dtype == torch.bfloat16 and params["embed"].dtype == torch.bfloat16
    assert torch.equal(params["layers"][1]["wq"], sd["model.layers.1.self_attn.q_proj.weight"].t())
    assert params["final_norm"].dtype == torch.float32
    _, p32 = hf_loader.load_hf_checkpoint(str(tmp_path), page_size=4, dtype=torch.float32,
                                          device="cpu")
    assert torch.equal(p32["lm_head"], sd["lm_head.weight"].float().t())


def test_load_refuses_before_reading_weights(tmp_path):
    """A config the conversion refuses raises its NotImplementedError before
    any weight file is opened (here there is none); a checkpoint carrying a
    tensor with no slot raises the leftover refusal."""
    hf_cfg, model = build_llama(seed=2)
    model.save_pretrained(tmp_path)
    cfg_json = json.loads((tmp_path / "config.json").read_text())
    os.unlink(tmp_path / "model.safetensors")
    with pytest.raises(FileNotFoundError):
        hf_loader.load_hf_checkpoint(str(tmp_path), device="cpu")
    (tmp_path / "config.json").write_text(json.dumps(dict(cfg_json, hidden_act="gelu")))
    with pytest.raises(NotImplementedError, match="hidden_act"):
        hf_loader.load_hf_checkpoint(str(tmp_path), device="cpu")
    from safetensors.torch import save_file as lib_save

    (tmp_path / "config.json").write_text(json.dumps(cfg_json))
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    sd["model.layers.0.self_attn.o_proj.bias"] = torch.zeros(64)
    lib_save(sd, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    with pytest.raises(NotImplementedError, match="unmapped"):
        hf_loader.load_hf_checkpoint(str(tmp_path), device="cpu")


def test_served_tokens_match_hf_greedy():
    hf_cfg, model = build_llama(seed=3)
    cfg = hf_loader.config_from_hf(hf_cfg, page_size=4, dtype=torch.float32)
    params = hf_loader.params_from_hf(model.state_dict(), cfg, device="cpu")
    prompt = np.random.default_rng(2).integers(1, 250, 12).tolist()
    assert served(cfg, params, prompt, 6) == hf_greedy(model, prompt, 6)


def test_default_device_is_cuda():
    """The loader runs on the card unless the caller asks for the CPU: here,
    with no card, the defaults raise rather than fall back."""
    hf_cfg, model = build_llama(vocab=64, hidden=32, inter=64, layers=1, heads=2, kv=2, hd=16)
    cfg = hf_loader.config_from_hf(hf_cfg, dtype=torch.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda_loader.py holds the default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hf_loader.params_from_hf(model.state_dict(), cfg)


# --- config.json without transformers ---

# Configs of each model_type: the class defaults, and the tests' settings.
CONFIGS = {
    "llama": [{}, dict(num_key_value_heads=2, head_dim=16, hidden_size=64,
                       num_attention_heads=4, rope_scaling={"type": "llama3", "factor": 8.0,
                                                            "low_freq_factor": 1.0,
                                                            "high_freq_factor": 4.0,
                                                            "original_max_position_embeddings": 32}),
              dict(tie_word_embeddings=True, hidden_size=64, num_attention_heads=8)],
    "mistral": [{}, dict(sliding_window=None), dict(head_dim=64, sliding_window=8)],
    "mixtral": [{}, dict(num_local_experts=4, rope_theta=1e4, sliding_window=16)],
    "qwen2": [{}, dict(use_sliding_window=True, sliding_window=8, max_window_layers=2,
                       num_hidden_layers=4),
              dict(rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                 "original_max_position_embeddings": 32})],
    "qwen3": [{}, dict(use_sliding_window=True, max_window_layers=30),
              dict(head_dim=64, num_key_value_heads=8, tie_word_embeddings=True)],
    "qwen3_moe": [{}, dict(mlp_only_layers=[0, 3], decoder_sparse_step=2,
                           norm_topk_prob=True),
                  dict(use_sliding_window=True, num_key_value_heads=None)],
    "deepseek_v2": [{}, dict(first_k_dense_replace=32, q_lora_rank=None,
                             rope_scaling={"type": "yarn", "factor": 40, "mscale": 0.707,
                                           "mscale_all_dim": 0.707,
                                           "original_max_position_embeddings": 4096})],
    "deepseek_v3": [{}, dict(first_k_dense_replace=61, rope_interleave=False),
                    dict(num_hidden_layers=4, first_k_dense_replace=1, n_group=2, topk_group=1,
                         rope_scaling={"rope_type": "yarn", "factor": 40, "beta_fast": 32,
                                       "beta_slow": 1, "mscale": 1, "mscale_all_dim": 1,
                                       "original_max_position_embeddings": 4096})],
}
# Every attribute config_from_hf and load_hf_checkpoint read.
READ = ("model_type", "num_hidden_layers", "hidden_act", "rope_scaling", "mlp_bias",
        "num_local_experts", "num_experts_per_tok", "decoder_sparse_step", "mlp_only_layers",
        "num_experts", "moe_intermediate_size", "norm_topk_prob", "layer_types",
        "sliding_window", "use_sliding_window", "head_dim", "hidden_size",
        "num_attention_heads", "vocab_size", "num_key_value_heads", "intermediate_size",
        "rope_theta", "rms_norm_eps", "max_position_embeddings", "v_head_dim",
        "qk_nope_head_dim", "first_k_dense_replace", "n_routed_experts", "topk_method",
        "n_shared_experts", "n_group", "topk_group", "routed_scaling_factor", "kv_lora_rank",
        "qk_rope_head_dim", "rope_interleave", "tie_word_embeddings", "q_lora_rank")
MISSING = object()


def reduced_json(hf_cfg) -> dict:
    """The config's keys whose values differ from its class's defaults (and
    its model_type): the smallest config.json transformers reads back as
    ``hf_cfg``."""
    full = hf_cfg.to_dict()
    defaults = type(hf_cfg)().to_dict()
    return {k: v for k, v in full.items()
            if k == "model_type" or k not in defaults or defaults[k] != v}


def config_or_refusal(fn, hf_cfg):
    try:
        return fn(hf_cfg, page_size=16, dtype=jnp.float32 if fn is jax_loader.config_from_hf
                  else torch.float32)
    except NotImplementedError as exc:
        return ("refused", str(exc))


@pytest.mark.parametrize("model_type,i", [(t, i) for t, cs in CONFIGS.items()
                                           for i in range(len(cs))])
def test_reduced_config_json_gives_jax_config(tmp_path, model_type, i):
    """transformers' config class for ``model_type`` built from the test's
    settings; its config.json reduced to the keys that differ from the class
    defaults; the port's reader gives every attribute the conversion reads
    as transformers has it, and the port's config_from_hf of it equals
    JAX's of the transformers config (or both refuse alike)."""
    hf_cfg = transformers.AutoConfig.for_model(model_type, **CONFIGS[model_type][i])
    path = tmp_path / "config.json"
    path.write_text(json.dumps(reduced_json(hf_cfg)))
    mine = hf_loader.hf_config_from_json(str(tmp_path))
    for name in READ:
        assert getattr(mine, name, MISSING) == getattr(hf_cfg, name, MISSING), name
    want = config_or_refusal(jax_loader.config_from_hf, hf_cfg)
    got = config_or_refusal(hf_loader.config_from_hf, mine)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert_config_equal(got, want)
    # The whole config.json save_pretrained writes reads the same.
    hf_cfg.save_pretrained(tmp_path / "full")
    full = hf_loader.hf_config_from_json(str(tmp_path / "full" / "config.json"))
    for name in READ:
        assert getattr(full, name, MISSING) == getattr(hf_cfg, name, MISSING), name


def test_config_json_needs_a_model_type():
    with pytest.raises(ValueError, match="model_type"):
        hf_loader.hf_config_from_json({"hidden_size": 64})
    with pytest.raises(NotImplementedError, match="gemma2"):
        hf_loader.config_from_hf(hf_loader.hf_config_from_json({"model_type": "gemma2"}))
