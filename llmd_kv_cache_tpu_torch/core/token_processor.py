"""Token → block-key hash chain.

Port of ``llmd_kv_cache_tpu/core/token_processor.py`` (counterpart of
reference ``pkg/kvcache/kvblock/token_processor.go``). Text-only blocks are
hashed by the native chain of ``csrc/kvindex`` (``index.native``, built at
first use); multimodal-tainted blocks by the Python encoder here. The keys
are byte-identical to the JAX package's either way. This is the
content-addressing scheme the whole indexer rests on; it must stay
byte-compatible with the engines' own block hashing:

- tokens are chunked into fixed-size blocks (default 16); a trailing
  partial block is dropped (``token_processor.go:184-197``)
- each block's key is ``FNV-64a(canonical-CBOR([parent, chunk, extra]))``
  chained on the previous block's key (``:146-158,160-176``)
- the chain seed is ``FNV-64a(hash_seed)`` mixed with the model name via
  one extra hash step ``hash(init, None, model_name)`` (``:114-118,131-134``)
- ``hash_seed`` must align with the engines' ``PYTHONHASHSEED``-equivalent
  (``:43-47``)
- per-block multimodal extras taint the hash: ``extra`` is the block's list
  of MM identifier entries encoded as ``[{"Hash": h}, ...]`` maps, matching
  the reference's Go-struct CBOR encoding of ``[]MMHash`` (``:167-173``
  with ``extra_keys.go:26-28``); text-only blocks hash ``extra = null``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..utils.cbor import canonical_cbor_encode
from ..utils.fnv import fnv1a_64
from ..utils.lockdep import new_lock
from .extra_keys import BlockExtraFeatures
from .keys import EMPTY_BLOCK_HASH, BlockHash

DEFAULT_BLOCK_SIZE = 16  # vLLM's default tokens-per-block
# Prefix-key cache budget in *tokens* (not entries): multi-turn sessions
# re-send the same growing prefix, so ~4M tokens covers hundreds of long
# chat sessions while bounding memory at tens of MB of ints.
DEFAULT_PREFIX_CACHE_TOKENS = 4 * 2**20


@dataclass
class TokenProcessorConfig:
    """Configuration for the token processor.

    ``block_size_tokens``: tokens per canonical block (0 → default 16).
    ``hash_seed``: seeds the chain like vLLM's NONE_HASH; deployers must
    align it across engines and indexer.
    ``prefix_cache_tokens``: token budget for the incremental prefix-key
    cache (0 disables; re-hashing every block on every call).
    """

    block_size_tokens: int = DEFAULT_BLOCK_SIZE
    hash_seed: str = ""
    prefix_cache_tokens: int = DEFAULT_PREFIX_CACHE_TOKENS

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TokenProcessorConfig":
        if not d:
            return cls()
        block_size = d.get("blockSizeTokens", d.get("block_size_tokens", 0)) or 0
        if block_size == 0:
            # deprecated alias accepted for config compatibility
            block_size = d.get("blockSize", d.get("block_size", 0)) or 0
        if block_size == 0:
            block_size = DEFAULT_BLOCK_SIZE
        prefix_cache = d.get("prefixCacheTokens", d.get("prefix_cache_tokens"))
        if prefix_cache is None:
            prefix_cache = DEFAULT_PREFIX_CACHE_TOKENS
        return cls(
            block_size_tokens=block_size,
            hash_seed=d.get("hashSeed", d.get("hash_seed", "")) or "",
            prefix_cache_tokens=prefix_cache,
        )


class PrefixKeyCache:
    """Bounded LRU mapping block-aligned token-prefix fingerprints →
    chained block keys.

    Keyed by ``(resolved_parent, n_tokens, fingerprint)`` where the
    fingerprint is Python's 64-bit tuple hash of the block-aligned token
    prefix. The parent alone namespaces correctly because continuation
    block hashes depend only on the parent key and the chunk — the model
    name enters the chain solely through the EMPTY-parent init step,
    which is already folded into ``resolved_parent``. Fingerprint keying
    keeps every cache operation O(1)-ish dict probes on small int tuples
    (no token tuples are retained or compared), at the price of trusting
    a 64-bit fingerprint: a collision would return another prefix's keys.
    That is a ~2^-64 event on non-adversarial traffic — routing soft
    state, acceptable for a scheduler hint; set ``prefix_cache_tokens: 0``
    where it is not.

    Besides exact matches, a small per-parent MRU bucket of recent prefix
    fingerprints enables longest-aligned-prefix matching, so a multi-turn
    session that appends a delta only hashes the delta's blocks. Bucket
    probes pre-filter on the candidate prefix's first/last token (O(1))
    before paying an O(prefix) slice+hash verification, and at most
    ``MAX_VERIFY_PROBES`` verifications run per call so cold traffic is
    not taxed by warm sessions sharing the model seed.

    Each entry also carries the keys as a ready ``np.uint64`` array so
    the native fused score path skips its per-call ``asarray``
    conversion. Eviction is by total cached tokens (LRU order), not entry
    count; a single coarse lock guards all state.
    """

    BUCKET_LIMIT = 16  # recent prefixes tracked per parent seed
    MAX_VERIFY_PROBES = 2  # full slice+hash verifications per call

    def __init__(self, capacity_tokens: int):
        self._capacity = capacity_tokens
        self._mu = new_lock()
        # (parent, n_tokens, fp) → (keys_tuple, keys_arr)
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        # parent → MRU list of (n_tokens, fp, first_token, last_token)
        self._buckets: dict[int, list[tuple]] = {}
        self._cached_tokens = 0
        self.hits = 0  # calls that reused at least one cached block
        self.misses = 0  # calls that reused nothing
        self.hit_blocks = 0  # block keys served from cache
        self.miss_blocks = 0  # block keys that had to be hashed

    def match(self, parent: int, trimmed: tuple):
        """Find the longest cached block-aligned prefix of ``trimmed``.

        Returns ``(fp, keys_tuple, keys_arr)`` — ``fp`` is the full
        fingerprint of ``trimmed`` (reused by ``store`` so the caller
        never hashes twice), and ``keys_tuple`` covers the matched prefix
        (empty on a full miss; ``len(trimmed)``-covering on an exact hit).
        """
        fp = hash(trimmed)
        n = len(trimmed)
        with self._mu:
            exact_key = (parent, n, fp)
            exact = self._entries.get(exact_key)
            if exact is not None:
                self._entries.move_to_end(exact_key)
                return fp, exact[0], exact[1]
            bucket = self._buckets.get(parent)
            if not bucket:
                return fp, (), None
            first = trimmed[0]
            candidates = [
                row for row in bucket
                if row[0] < n and row[2] == first and row[3] == trimmed[row[0] - 1]
            ]
        # Verify outside the lock: slicing+hashing a long prefix is the
        # expensive part and needs no cache state.
        for n_tok, row_fp, _, _ in candidates[: self.MAX_VERIFY_PROBES]:
            if hash(trimmed[:n_tok]) != row_fp:
                continue
            with self._mu:
                entry = self._entries.get((parent, n_tok, row_fp))
                if entry is None:  # evicted between probe and verify
                    continue
                self._entries.move_to_end((parent, n_tok, row_fp))
                return fp, entry[0], entry[1]
        return fp, (), None

    def store(self, parent: int, trimmed_len: int, fp: int,
              keys: tuple, keys_arr, first_token: int, last_token: int) -> None:
        with self._mu:
            entry_key = (parent, trimmed_len, fp)
            if entry_key in self._entries:
                self._entries.move_to_end(entry_key)
                return
            self._entries[entry_key] = (keys, keys_arr)
            self._cached_tokens += trimmed_len
            bucket = self._buckets.setdefault(parent, [])
            bucket.insert(0, (trimmed_len, fp, first_token, last_token))
            if len(bucket) > self.BUCKET_LIMIT:
                n_tok, old_fp, _, _ = bucket.pop()
                self._drop(parent, n_tok, old_fp)
            while self._cached_tokens > self._capacity and self._entries:
                old_parent, n_tok, old_fp = next(iter(self._entries))
                bkt = self._buckets.get(old_parent)
                if bkt is not None:
                    for i, row in enumerate(bkt):
                        if row[0] == n_tok and row[1] == old_fp:
                            del bkt[i]
                            break
                    if not bkt:
                        del self._buckets[old_parent]
                self._drop(old_parent, n_tok, old_fp)

    def _drop(self, parent: int, n_tokens: int, fp: int) -> None:
        if self._entries.pop((parent, n_tokens, fp), None) is not None:
            self._cached_tokens -= n_tokens

    def note(self, matched_blocks: int, hashed_blocks: int) -> None:
        with self._mu:
            self.hit_blocks += matched_blocks
            self.miss_blocks += hashed_blocks
            if matched_blocks:
                self.hits += 1
            else:
                self.misses += 1

    def stats(self) -> dict:
        with self._mu:
            total = self.hit_blocks + self.miss_blocks
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_blocks": self.hit_blocks,
                "miss_blocks": self.miss_blocks,
                "block_hit_rate": (self.hit_blocks / total) if total else 0.0,
                "entries": len(self._entries),
                "cached_tokens": self._cached_tokens,
            }


class ChunkedTokenDatabase:
    """Concrete token processor implementing the chained block-hash scheme.

    Text-only blocks take the native (C++) chain; multimodal-tainted
    blocks always use the Python encoder. Both produce identical hashes.
    ``use_native=False`` hashes every block in Python (the equivalence
    tests' reference); with ``use_native=True`` the library is loaded here,
    and a failed build raises: the chain never switches quietly.
    """

    def __init__(self, config: Optional[TokenProcessorConfig] = None,
                 use_native: bool = True):
        cfg = config or TokenProcessorConfig()
        block_size = cfg.block_size_tokens or DEFAULT_BLOCK_SIZE
        if block_size <= 0:
            raise ValueError(
                f"block_size_tokens must be greater than 0, got {cfg.block_size_tokens}"
            )
        self._block_size = block_size
        self._hash_seed = cfg.hash_seed
        self._init_hash = fnv1a_64(self._hash_seed.encode("utf-8"))
        # Per-model seed cache: the init step hashes the model name into the
        # chain once; memoize since model cardinality is tiny.
        self._model_seed_cache: dict[str, int] = {}
        self._native = None
        if use_native:
            from ..index import native as _native_mod

            _native_mod.load_library()
            self._native = _native_mod
        self._prefix_cache: Optional[PrefixKeyCache] = (
            PrefixKeyCache(cfg.prefix_cache_tokens)
            if cfg.prefix_cache_tokens > 0 else None
        )
        # Blocks actually hashed (native or Python), across all call paths.
        # Approximate under concurrency (unlocked increment); used by the
        # perf_smoke test to prove the cache short-circuits hashing.
        self.hash_calls = 0

    @property
    def block_size(self) -> int:
        return self._block_size

    def prefix_cache_stats(self) -> Optional[dict]:
        """Hit/miss counters of the prefix-key cache (None when disabled)."""
        return self._prefix_cache.stats() if self._prefix_cache is not None else None

    def _hash(self, parent: int, tokens: Optional[Sequence[int]], extra) -> int:
        # `tokens` is hashed as passed: lists and tuples (and their slices)
        # produce identical canonical-CBOR arrays, so no copy is taken here.
        payload = [parent, tokens, extra]
        return fnv1a_64(canonical_cbor_encode(payload))

    def _get_init_hash(self, model_name: str) -> int:
        cached = self._model_seed_cache.get(model_name)
        if cached is None:
            cached = self._hash(self._init_hash, None, model_name)
            self._model_seed_cache[model_name] = cached
        return cached

    def _hash_text_chain(
        self, parent: int, tokens: Sequence[int], n_chunks: int
    ) -> list[BlockHash]:
        """Hash full text-only blocks, native when available. Trailing
        partial tokens are ignored."""
        self.hash_calls += n_chunks
        if self._native is not None:
            return self._native.hash_chain(parent, tokens, self._block_size)
        bs = self._block_size
        keys: list[BlockHash] = []
        prefix = parent
        for i in range(n_chunks):
            prefix = self._hash(prefix, tokens[i * bs:(i + 1) * bs], None)
            keys.append(prefix)
        return keys

    def _hash_text_chain_with_array(
        self, parent: int, tokens: Sequence[int], n_chunks: int
    ):
        """Like ``_hash_text_chain`` but also returns the keys as a
        ``np.uint64`` array for the prefix cache, so warm score calls hand
        the native fused scorer a ready array."""
        self.hash_calls += n_chunks
        if self._native is not None:
            return self._native.hash_chain_with_array(
                parent, tokens, self._block_size)
        bs = self._block_size
        keys: list[BlockHash] = []
        prefix = parent
        for i in range(n_chunks):
            prefix = self._hash(prefix, tokens[i * bs:(i + 1) * bs], None)
            keys.append(prefix)
        return keys, np.asarray(keys, np.uint64)

    def _hash_tainted_chain(
        self,
        parent: int,
        tokens: Sequence[int],
        extra_features: Sequence[Optional[BlockExtraFeatures]],
    ) -> list[BlockHash]:
        """Python path for multimodal-tainted chains: per-block ``extra``
        feeds the hash, so neither the native chain nor the prefix cache
        may serve these."""
        self.hash_calls += len(extra_features)
        bs = self._block_size
        keys: list[BlockHash] = []
        prefix = parent
        for i, features in enumerate(extra_features):
            extra = None
            if features is not None:
                extra = [{"Hash": h} for h in features.mm_hashes]
            prefix = self._hash(prefix, tokens[i * bs:(i + 1) * bs], extra)
            keys.append(prefix)
        return keys

    def tokens_to_kv_block_keys(
        self,
        parent_key: BlockHash,
        tokens: Sequence[int],
        model_name: str,
        extra_features: Optional[Sequence[Optional[BlockExtraFeatures]]] = None,
    ) -> list[BlockHash]:
        """Convert tokens into chained block keys.

        ``parent_key`` continues an existing chain (``EMPTY_BLOCK_HASH`` to
        start fresh from the model-seeded init hash). ``extra_features``, if
        given, must have exactly one entry per full token chunk.
        """
        return self.tokens_to_kv_block_keys_with_array(
            parent_key, tokens, model_name, extra_features)[0]

    def tokens_to_kv_block_keys_with_array(
        self,
        parent_key: BlockHash,
        tokens: Sequence[int],
        model_name: str,
        extra_features: Optional[Sequence[Optional[BlockExtraFeatures]]] = None,
    ):
        """Like ``tokens_to_kv_block_keys`` but returns ``(keys, arr)``
        where ``arr`` is the same keys as a ``np.uint64`` array when the
        prefix cache produced one (else None). The array feeds
        ``NativeIndex.score`` directly, skipping its per-call ``asarray``
        over thousands of keys on warm sessions.
        """
        parent = parent_key if parent_key != EMPTY_BLOCK_HASH else self._get_init_hash(model_name)

        n_chunks = len(tokens) // self._block_size
        if n_chunks == 0:
            return [], None

        if extra_features is not None and len(extra_features) != n_chunks:
            raise ValueError(
                f"extra_features length {len(extra_features)} does not match "
                f"token chunk count {n_chunks} (block_size_tokens="
                f"{self._block_size}, tokens={len(tokens)})"
            )

        if extra_features is not None and any(f is not None for f in extra_features):
            return self._hash_tainted_chain(parent, tokens, extra_features), None

        cache = self._prefix_cache
        if cache is None:
            return self._hash_text_chain(parent, tokens, n_chunks), None

        # Incremental path: reuse the longest cached block-aligned prefix
        # under this parent and hash only the suffix chunks. The cache is
        # fingerprint-keyed over the block-aligned token prefix (trailing
        # partial tokens never influence keys, so they must not defeat
        # exact matches); ``match`` hands back the full-prefix fingerprint
        # so the store below never hashes the tokens a second time.
        aligned = n_chunks * self._block_size
        trimmed = tuple(tokens) if len(tokens) == aligned else tuple(tokens[:aligned])
        fp, cached_keys, cached_arr = cache.match(parent, trimmed)
        matched = len(cached_keys)
        if matched == n_chunks:
            cache.note(matched, 0)
            return list(cached_keys), cached_arr
        sub_parent = cached_keys[-1] if matched else parent
        suffix_keys, suffix_arr = self._hash_text_chain_with_array(
            sub_parent, trimmed[matched * self._block_size:], n_chunks - matched
        )
        if matched:
            keys_t = cached_keys + tuple(suffix_keys)
            arr = None
            if cached_arr is not None and suffix_arr is not None:
                arr = np.concatenate([cached_arr, suffix_arr])
        else:
            keys_t = tuple(suffix_keys)
            arr = suffix_arr
        cache.store(parent, aligned, fp, keys_t, arr,
                    trimmed[0], trimmed[-1])
        cache.note(matched, n_chunks - matched)
        return list(keys_t), arr


