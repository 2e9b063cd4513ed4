"""The port's engine checkpoint against the JAX package's.

A counterpart of each test in ``tests/test_checkpoint.py`` (round trip,
restarted engine, a fused tree saved with the pre-init config, MoE and SWA
config fields, a tp engine's checkpoint), and beside them: the port's
``engine_meta.json`` equals JAX's for the same config (parsed JSON); a tree
JAX saves and reloads (Orbax), carried with ``params_from_jax``, equals the
port's reload of the same tree leaf for leaf; a checkpoint loads into a
spawned gloo ``MiniEngine(tp=2)`` pair on the CPU with the tokens and block
keys of tp 1, and saving a rank's shard tree is refused, naming the rank;
converted trees (DeepSeek's ``latent_norm`` and q-LoRA, Qwen2's biases)
round-trip; a checkpoint whose leaves do not fit its config raises before
any tensor is read.
"""

import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_kv_cache_tpu.models import checkpoint as jax_checkpoint
from llmd_kv_cache_tpu.models import llama as jax_llama
from llmd_kv_cache_tpu_torch.models import checkpoint, llama
from llmd_kv_cache_tpu_torch.models.engine import EngineConfig, MiniEngine
from llmd_kv_cache_tpu_torch.parallel import mesh
from llmd_kv_cache_tpu_torch.utils import safetensors as st

from torch_loader_ranks import serve_loaded_rank

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=8, intermediate_size=64, page_size=4)
# Configs held across the packages: their fields as both packages take them.
CONFIGS = {
    "tiny": dataclasses.asdict(jax_llama.LlamaConfig.tiny()),
    "moe-swa": dict(SMALL, num_experts=4, num_experts_per_token=2, sliding_window=8,
                    swa_layers=(0, 1)),
    "deepseek-yarn": dict(dataclasses.asdict(jax_llama.LlamaConfig.deepseek_tiny()),
                          rope_scaling=("yarn", 4.0, 32.0, 1.0, 32.0, 1.1),
                          softmax_scale_mult=1.2, latent_pad=8),
    "qwen3-sinks": dict(dataclasses.asdict(jax_llama.LlamaConfig.qwen3_tiny()),
                        sliding_window=8, swa_layers=(0, 1), attention_sinks=4),
    "deepseek-moe": dict(SMALL, num_heads=4, num_kv_heads=4, kv_lora_rank=16,
                         qk_rope_head_dim=8, num_experts=4, num_experts_per_token=2,
                         moe_layers=(1,), n_shared_experts=1, moe_intermediate_size=16,
                         moe_router=("deepseek_v3", 2, 1, 1, 2.5), moe_dispatch="dense"),
}


def pair(name, dtype="float32"):
    kw = {k: v for k, v in CONFIGS[name].items() if k != "dtype"}
    return (jax_llama.LlamaConfig(**kw, dtype=getattr(jnp, dtype)),
            llama.LlamaConfig(**kw, dtype=getattr(torch, dtype)))


def assert_trees_equal(got, want):
    """The same leaves by flat name, bit for bit, the same dtypes."""
    g, w = llama.flatten_params(got), llama.flatten_params(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_save_restore_roundtrip(tmp_path):
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, seed=7, device="cpu")
    checkpoint.save_engine_checkpoint(str(tmp_path / "ckpt"), params, cfg, "tiny", "42")
    params2, cfg2, name, seed = checkpoint.load_engine_checkpoint(str(tmp_path / "ckpt"),
                                                                  device="cpu")
    assert (name, seed) == ("tiny", "42") and cfg2 == cfg
    assert_trees_equal(params2, params)
    meta = json.loads((tmp_path / "ckpt" / "engine_meta.json").read_text())
    assert meta["dtype"] == "bfloat16" and meta["model_config"]["fused_interleave"] == 1


def serve(cfg, params, name, seed, prompt, n=4, events=None):
    eng = MiniEngine(EngineConfig(model=cfg, num_pages=64, max_pages_per_seq=16,
                                  model_name=name, pod_identifier="p", hash_seed=seed),
                     event_sink=events.extend if events is not None else None,
                     params=params, device="cpu")
    req = eng.add_request("r", prompt, max_new_tokens=n)
    while not req.done:
        eng.step()
    return eng, req


def stored(events):
    return [h for e in events if type(e).__name__ == "BlockStoredEvent"
            for h in e.block_hashes]


def test_restarted_engine_resumes_identically(tmp_path):
    """A pod restarted from its checkpoint generates the same tokens and
    emits the same block keys (its cache fingerprints stay valid)."""
    cfg = llama.LlamaConfig.tiny()
    prompt = list(range(60, 76))
    events = []
    engine = MiniEngine(EngineConfig(model=cfg, num_pages=64, max_pages_per_seq=16,
                                     model_name="tiny", pod_identifier="p", hash_seed="s"),
                        event_sink=events.extend, seed=3, device="cpu")
    out1 = engine.generate("r", prompt, max_new_tokens=4)
    checkpoint.save_engine_checkpoint(str(tmp_path / "ck"), engine.params, cfg, "tiny", "s")
    params, cfg2, name, seed = checkpoint.load_engine_checkpoint(str(tmp_path / "ck"),
                                                                 device="cpu")
    events2 = []
    _, req = serve(cfg2, params, name, seed, prompt, events=events2)
    assert req.output == out1
    assert req.block_hashes == engine.processor.tokens_to_kv_block_keys(0, prompt, "tiny")
    assert stored(events2) == stored(events)


def test_fused_tree_saves_with_preinit_config(tmp_path):
    """A tree fused at interleave 2 saves with the canonical (t = 1) config:
    its marker decides the unfuse, and the stored tree is the canonical one;
    an engine's fused tree (the default gate at hidden 4096) saves alike."""
    base = llama.LlamaConfig(**SMALL, dtype=torch.float32)
    params = llama.init_params(base, seed=5, device="cpu")
    fused = llama.fuse_params(params, dataclasses.replace(base, fused_interleave=2))
    assert fused["fused_interleave"] == 2
    checkpoint.save_engine_checkpoint(str(tmp_path / "fz"), fused, base, "fz")
    params2, cfg2, _, _ = checkpoint.load_engine_checkpoint(str(tmp_path / "fz"), device="cpu")
    assert cfg2.fused_interleave == 1 and cfg2 == base
    assert_trees_equal(params2, params)
    wide = llama.LlamaConfig(vocab_size=64, hidden_size=4096, num_layers=1, num_heads=32,
                             num_kv_heads=8, head_dim=128, intermediate_size=64, page_size=16,
                             dtype=torch.bfloat16)
    tree = llama.init_params(wide, seed=1, device="cpu")
    eng = MiniEngine(EngineConfig(model=wide, num_pages=8, max_pages_per_seq=4,
                                  model_name="w", pod_identifier="p"),
                     params=tree, device="cpu")
    assert "w_qkv" in eng.params["layers"][0] and eng.params["fused_interleave"] == 1
    checkpoint.save_engine_checkpoint(str(tmp_path / "w"), eng.params, eng.cfg.model, "w")
    assert_trees_equal(checkpoint.load_engine_checkpoint(str(tmp_path / "w"), "cpu")[0], tree)


def test_moe_and_swa_config_roundtrip(tmp_path):
    _, cfg = pair("moe-swa")
    params = llama.init_params(cfg, seed=1, device="cpu")
    checkpoint.save_engine_checkpoint(str(tmp_path / "moe"), params, cfg, "moe-model")
    params2, cfg2, name, _ = checkpoint.load_engine_checkpoint(str(tmp_path / "moe"), "cpu")
    assert cfg2 == cfg and cfg2.swa_layers == (0, 1) and name == "moe-model"
    assert tuple(params2["layers"][0]["router"].shape) == (32, 4)
    assert_trees_equal(params2, params)


def test_sharded_params_roundtrip(tmp_path):
    """A checkpoint loads into a tp 2 engine (a spawned gloo pair on the
    CPU, each rank placing its shard of the host tree) with the tokens, the
    block keys and the BlockStored hashes of tp 1; each rank's attempt to
    save its shard tree is refused, naming the rank."""
    cfg = llama.LlamaConfig(**dict(SMALL, vocab_size=128), dtype=torch.float32)
    params = llama.init_params(cfg, seed=2, device="cpu")
    checkpoint.save_engine_checkpoint(str(tmp_path / "tp"), params, cfg, "tp-model", "h")
    prompt = np.random.default_rng(0).integers(1, 120, 12).tolist()
    with concurrent.futures.ThreadPoolExecutor(1) as waiter:
        ranks = waiter.submit(mesh.spawn_tp, serve_loaded_rank, 2, backend="gloo",
                              devices=["cpu", "cpu"],
                              args=(str(tmp_path / "tp"), "engine", prompt, 4),
                              timeout_s=240, collective_timeout_s=120)
        loaded, cfg2, name, seed = checkpoint.load_engine_checkpoint(str(tmp_path / "tp"),
                                                                     "cpu")
        events = []
        _, req = serve(cfg2, loaded, name, seed, prompt, events=events)
        _, ref = serve(cfg, params, "tp-model", "h", prompt)
        ranks = ranks.result()
    assert req.output == ref.output
    for r, got in enumerate(ranks):
        assert got["tokens"] == req.output and got["block_hashes"] == req.block_hashes
        assert f"rank {r} of 2" in got["refusal"] and "one rank's columns" in got["refusal"]
    assert ranks[0]["stored"] == stored(events) and ranks[1]["stored"] == []


def test_a_ranks_shard_is_refused_outside_a_group():
    """A shard made by ``shard_params`` (unfused, and fused at interleave
    2) is refused with no process group too; the message says it holds one
    rank's columns and how many ways the model is split."""
    cfg = llama.LlamaConfig(**SMALL, dtype=torch.float32)
    params = llama.init_params(cfg, seed=4, device="cpu")
    fused = llama.fuse_params(params, dataclasses.replace(cfg, fused_interleave=2))
    for tp in (2, 4):
        for tree in (params, fused):
            grp = mesh.TPGroup(rank=1, size=tp, process_group=None,
                               device=torch.device("cpu"), backend="gloo")
            with pytest.raises(ValueError, match=f"one rank's columns of a {tp}-way shard"):
                checkpoint.save_engine_checkpoint("/nonexistent/ck", mesh.shard_params(
                    tree, grp), cfg, "m")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_meta_equals_jaxs(tmp_path, name, dtype):
    """The identity file: the same keys and values as JAX's for the same
    config, model name and hash seed (``"dtype": "bfloat16"``, not
    ``"torch.bfloat16"``), compared as parsed JSON."""
    jcfg, tcfg = pair(name, dtype)
    jax_checkpoint.save_engine_checkpoint(str(tmp_path / "jax"), jax_llama.init_params(
        jax.random.PRNGKey(0), jcfg), jcfg, "model-x", "seed-y")
    checkpoint.save_engine_checkpoint(str(tmp_path / "port"), llama.init_params(
        tcfg, seed=0, device="cpu"), tcfg, "model-x", "seed-y")
    want = json.loads((tmp_path / "jax" / "engine_meta.json").read_text())
    got = json.loads((tmp_path / "port" / "engine_meta.json").read_text())
    assert got == want
    assert got["dtype"] == dtype
    # The port reads JAX's identity file as its own.
    _, cfg2, model_name, seed = checkpoint.load_engine_checkpoint(str(tmp_path / "port"), "cpu")
    assert (cfg2, model_name, seed) == (tcfg, "model-x", "seed-y")


def test_jax_reload_equals_the_ports(tmp_path):
    """One JAX tree: JAX saves and reloads it (Orbax), the port saves and
    reloads it (carried with ``params_from_jax``), and the two reloads are
    equal leaf for leaf, bf16 bits included; a JAX-fused tree too."""
    for name in ("tiny", "moe-swa", "qwen3-sinks", "deepseek-moe"):
        jcfg, tcfg = pair(name, "bfloat16")
        tree = jax_llama.init_params(jax.random.PRNGKey(3), jcfg)
        if name == "tiny":
            tree = jax_llama.fuse_params(tree, jcfg)
        jax_checkpoint.save_engine_checkpoint(str(tmp_path / name / "jax"), tree, jcfg, name)
        jp, jcfg2, _, _ = jax_checkpoint.load_engine_checkpoint(str(tmp_path / name / "jax"))
        numpy_tree = jax.tree_util.tree_map(np.asarray, tree)
        port_tree = llama.params_from_jax(numpy_tree, tcfg, device="cpu")
        checkpoint.save_engine_checkpoint(str(tmp_path / name / "port"), port_tree, tcfg, name)
        tp, tcfg2, _, _ = checkpoint.load_engine_checkpoint(str(tmp_path / name / "port"), "cpu")
        assert_trees_equal(tp, llama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                                     tcfg2, device="cpu"))
        assert tcfg2 == tcfg and jcfg2.fused_interleave == tcfg2.fused_interleave == 1


def test_converted_trees_roundtrip(tmp_path):
    """Leaves a converted checkpoint carries beyond ``init_params``' layout
    round-trip and are held to the config: DeepSeek's ``latent_norm`` with
    q-LoRA's ``w_dq``/``q_latent_norm`` (``wq`` then reads the q latent),
    and Qwen2's QKV biases."""
    _, mla = pair("deepseek-yarn")
    tree = llama.init_params(mla, seed=6, device="cpu")
    for layer in tree["layers"]:
        layer["latent_norm"] = torch.rand(mla.kv_lora_rank)
        layer["w_dq"] = torch.randn(mla.hidden_size, 24)
        layer["q_latent_norm"] = torch.rand(24)
        layer["wq"] = torch.randn(24, layer["wq"].shape[1])
    checkpoint.save_engine_checkpoint(str(tmp_path / "mla"), tree, mla, "mla")
    assert_trees_equal(checkpoint.load_engine_checkpoint(str(tmp_path / "mla"), "cpu")[0],
                       tree)
    _, dense = pair("tiny")
    tree = llama.init_params(dense, seed=6, device="cpu")
    for layer in tree["layers"]:
        for k, n in (("bq", 64), ("bk", 32), ("bv", 32)):
            layer[k] = torch.randn(n)
    checkpoint.save_engine_checkpoint(str(tmp_path / "bias"), tree, dense, "b")
    assert_trees_equal(checkpoint.load_engine_checkpoint(str(tmp_path / "bias"), "cpu")[0],
                       tree)
    del tree["layers"][1]["bv"]
    with pytest.raises(ValueError, match="layers.1.bv missing"):
        checkpoint.save_engine_checkpoint(str(tmp_path / "bias2"), tree, dense, "b")


def test_mismatched_checkpoint_raises_before_reading(tmp_path):
    """A checkpoint whose leaves do not fit its config (the config edited, a
    leaf's dtype changed, a leaf missing or extra) raises ValueError naming
    the leaf, before any tensor is read; a tree that does not fit the
    caller's config is refused before anything is written."""
    _, cfg = pair("tiny")
    params = llama.init_params(cfg, seed=0, device="cpu")
    path = tmp_path / "ck"
    checkpoint.save_engine_checkpoint(str(path), params, cfg, "m")
    meta = json.loads((path / "engine_meta.json").read_text())
    bad = dict(meta, model_config=dict(meta["model_config"], intermediate_size=96))
    (path / "engine_meta.json").write_text(json.dumps(bad))
    read = []
    orig = st.SafetensorsFile.get_tensor
    st.SafetensorsFile.get_tensor = lambda self, *a, **k: read.append(a) or orig(self, *a, **k)
    try:
        with pytest.raises(ValueError, match="w_gate is \\[64, 128\\]"):
            checkpoint.load_engine_checkpoint(str(path), "cpu")
        (path / "engine_meta.json").write_text(json.dumps(dict(meta, dtype="float16")))
        with pytest.raises(ValueError, match="torch.float16"):
            checkpoint.load_engine_checkpoint(str(path), "cpu")
    finally:
        st.SafetensorsFile.get_tensor = orig
    assert read == []
    (path / "engine_meta.json").write_text(json.dumps(meta))
    flat = llama.flatten_params(params)
    extra = dict(flat, **{"layers.0.o_bias": torch.zeros(64)})
    st.save_file(extra, str(path / "params" / "model.safetensors"))
    with pytest.raises(ValueError, match="o_bias is not a leaf"):
        checkpoint.load_engine_checkpoint(str(path), "cpu")
    del flat["lm_head"]
    st.save_file(flat, str(path / "params" / "model.safetensors"))
    with pytest.raises(ValueError, match="lm_head missing"):
        checkpoint.load_engine_checkpoint(str(path), "cpu")
    narrow = dataclasses.replace(cfg, intermediate_size=96)
    with pytest.raises(ValueError, match="does not fit its config"):
        checkpoint.save_engine_checkpoint(str(tmp_path / "x"), params, narrow, "m")
    assert not (tmp_path / "x").exists()


def test_a_second_save_replaces_the_first(tmp_path):
    """Periodic re-checkpointing to a fixed path overwrites: the second
    save's tree and identity are what loads."""
    _, cfg = pair("tiny")
    checkpoint.save_engine_checkpoint(str(tmp_path), llama.init_params(cfg, 1, "cpu"), cfg,
                                      "a", "1")
    second = llama.init_params(cfg, 2, "cpu")
    checkpoint.save_engine_checkpoint(str(tmp_path), second, cfg, "b", "2")
    params, _, name, seed = checkpoint.load_engine_checkpoint(str(tmp_path), "cpu")
    assert (name, seed) == ("b", "2")
    assert_trees_equal(params, second)
    assert sorted(p.name for p in (tmp_path / "params").iterdir()) == ["model.safetensors"]


def test_default_device_is_cuda(tmp_path):
    _, cfg = pair("tiny")
    checkpoint.save_engine_checkpoint(str(tmp_path), llama.init_params(cfg, 0, "cpu"), cfg, "m")
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda_loader.py holds the default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load_engine_checkpoint(str(tmp_path))

