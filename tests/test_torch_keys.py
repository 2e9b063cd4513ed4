"""The port's block-key hashing against the JAX package, byte for byte.

Block keys are the contract between engines and the indexer, so the
port's copies of canonical CBOR, FNV-1a and the chunked token database
must reproduce ``llmd_kv_cache_tpu``'s keys exactly: token chains, parent
keys, hash seeds, model names and multimodal taints. The LRU cache behind
the index is checked against the JAX copy's semantics too.
"""

import numpy as np
import pytest

from llmd_kv_cache_tpu.core.extra_keys import BlockExtraFeatures as JaxFeatures
from llmd_kv_cache_tpu.core.extra_keys import parse_raw_extra_keys as jax_parse
from llmd_kv_cache_tpu.core.token_processor import (
    ChunkedTokenDatabase as JaxDatabase,
)
from llmd_kv_cache_tpu.core.token_processor import (
    TokenProcessorConfig as JaxConfig,
)
from llmd_kv_cache_tpu.utils.cbor import canonical_cbor_encode as jax_cbor
from llmd_kv_cache_tpu.utils.fnv import fnv1a_64 as jax_fnv
from llmd_kv_cache_tpu.utils.lru import LRUCache as JaxLRU
from llmd_kv_cache_tpu_torch.core.extra_keys import BlockExtraFeatures, parse_raw_extra_keys
from llmd_kv_cache_tpu_torch.core.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llmd_kv_cache_tpu_torch.utils.cbor import canonical_cbor_encode
from llmd_kv_cache_tpu_torch.utils.fnv import fnv1a_64
from llmd_kv_cache_tpu_torch.utils.lru import LRUCache


@pytest.mark.parametrize("block_size", [4, 16])
@pytest.mark.parametrize("hash_seed", ["", "42", "seed-é"])
@pytest.mark.parametrize("prefix_cache_tokens", [0, 1 << 20])
def test_token_chains_are_byte_equal(block_size, hash_seed, prefix_cache_tokens):
    rng = np.random.default_rng(block_size + len(hash_seed))
    kw = dict(block_size_tokens=block_size, hash_seed=hash_seed,
              prefix_cache_tokens=prefix_cache_tokens)
    # The port's default chain is the native one; its Python chain and both
    # of JAX's are held to it.
    ours = ChunkedTokenDatabase(TokenProcessorConfig(**kw))
    ours_python = ChunkedTokenDatabase(TokenProcessorConfig(**kw), use_native=False)
    ref = JaxDatabase(JaxConfig(**kw), use_native=False)
    ref_native = JaxDatabase(JaxConfig(**kw))
    base = rng.integers(0, 2**31, 5 * block_size + 3).tolist()
    for model in ("tiny", "meta-llama/Llama-3.1-8B", ""):
        # Whole prompt, growing prefixes (the prefix-cache path), a partial
        # block only, and large token ids (multi-byte CBOR heads).
        for tokens in (base, base[:2 * block_size], base + [1, 2, 3] * block_size,
                       base[:block_size - 1], [2**32 + 7] * block_size):
            want = ref.tokens_to_kv_block_keys(0, tokens, model)
            assert ours_python.tokens_to_kv_block_keys(0, tokens, model) == want
            if max(tokens) >= 2**32:
                # Past uint32 only the Python chains go: the native chain
                # takes uint32 token ids and raises, as JAX's native one does.
                for native in (ours, ref_native):
                    with pytest.raises(OverflowError):
                        native.tokens_to_kv_block_keys(0, tokens, model)
                got = ours_python.tokens_to_kv_block_keys(0, tokens, model)
            else:
                got = ours.tokens_to_kv_block_keys(0, tokens, model)
            assert got == want
            if got:
                # Continuing a chain from a parent key.
                assert (ours.tokens_to_kv_block_keys(got[-1], base, model)
                        == ref.tokens_to_kv_block_keys(got[-1], base, model))


def test_multimodal_taint_is_byte_equal():
    ours = ChunkedTokenDatabase(TokenProcessorConfig(block_size_tokens=4))
    ref = JaxDatabase(JaxConfig(block_size_tokens=4), use_native=False)
    tokens = list(range(10, 22))
    features = [None, BlockExtraFeatures(["img-a"]), BlockExtraFeatures(["x", "y"])]
    jax_features = [None, JaxFeatures(["img-a"]), JaxFeatures(["x", "y"])]
    got = ours.tokens_to_kv_block_keys(0, tokens, "m", features)
    assert got == ref.tokens_to_kv_block_keys(0, tokens, "m", jax_features)
    assert got[0] == ours.tokens_to_kv_block_keys(0, tokens, "m")[0]
    assert got[1] != ours.tokens_to_kv_block_keys(0, tokens, "m")[1]
    with pytest.raises(ValueError, match="extra_features length"):
        ours.tokens_to_kv_block_keys(0, tokens, "m", features[:2])
    raw = [["h1", ["h2", 3]], None, [7, "h3"], []]
    assert [None if f is None else f.mm_hashes for f in parse_raw_extra_keys(raw)] == \
        [None if f is None else f.mm_hashes for f in jax_parse(raw)]


@pytest.mark.parametrize("payload", [
    [0, [1, 2, 3], None],
    [2**64 - 1, list(range(30)), [{"Hash": "abc"}, {"Hash": "é"}]],
    [-1, -24, -25, -256, -(2**40)],
    {"b": 1, "aa": 2, 10: [True, False, None]},
    [b"\x00\x01", "text", 1.5, 23, 24, 255, 256, 65535, 65536, 2**32],
])
def test_canonical_cbor_and_fnv_are_byte_equal(payload):
    encoded = canonical_cbor_encode(payload)
    assert encoded == jax_cbor(payload)
    assert fnv1a_64(encoded) == jax_fnv(encoded)


def test_lru_matches_jax_copy():
    ops = [("add", 1), ("add", 2), ("get", 1), ("add", 3), ("peek", 2), ("add", 4),
           ("remove", 3), ("add", 5), ("get", 2)]
    ours, ref = LRUCache(3), JaxLRU(3)
    for op, key in ops:
        args = (key, key * 10) if op == "add" else (key,)
        assert getattr(ours, op)(*args) == getattr(ref, op)(*args)
        assert ours.keys() == ref.keys()
    assert ours.get_or_create(9, lambda: 90) == ref.get_or_create(9, lambda: 90)
    assert len(ours) == len(ref) and (9 in ours) == (9 in ref)
    with pytest.raises(ValueError):
        LRUCache(0)
