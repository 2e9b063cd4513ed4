"""Tokenizer backends: HuggingFace loading with cache + a hermetic fallback.

Port of ``llmd_kv_cache_tpu/services/tokenizer/backends.py`` (counterpart
of reference ``tokenizer_service/tokenizer.py``): per-model
tokenizer instances loaded once and cached. Two backends:

- ``hf:`` / plain names → ``transformers.AutoTokenizer`` (local files or
  hub cache; this image has zero egress, so hub names must already be
  cached or be local paths)
- ``simple:`` → a deterministic hermetic tokenizer (hash-bucketed word
  ids) used by tests and smoke deployments; supports a minimal chat
  template so render paths are exercisable without model downloads

``transformers`` is imported in ``HFTokenizer``'s constructor: the card's
machine has no ``transformers``, and ``SimpleTokenizer`` is stdlib only.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Protocol

from ...utils.lockdep import new_lock


class Tokenizer(Protocol):
    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]: ...

    def encode_with_offsets(
        self, text: str, add_special_tokens: bool = True
    ) -> tuple[list[int], list[tuple[int, int]]]: ...

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True,
        chat_template: Optional[str] = None, tools: Optional[list] = None,
        **kwargs,
    ) -> str: ...


class SimpleTokenizer:
    """Hermetic whitespace tokenizer: token id = stable hash of the word.

    Deterministic across processes (sha1-based, not PYTHONHASHSEED), so
    indexer and engine sides agree on ids — which is all the cache layer
    needs from a tokenizer.
    """

    VOCAB = 32000
    BOS = 1

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids, _ = self.encode_with_offsets(text, add_special_tokens)
        return ids

    def encode_with_offsets(self, text, add_special_tokens=True):
        ids: list[int] = []
        offsets: list[tuple[int, int]] = []
        if add_special_tokens:
            ids.append(self.BOS)
            offsets.append((0, 0))
        pos = 0
        for word in text.split():
            start = text.index(word, pos)
            end = start + len(word)
            pos = end
            digest = hashlib.sha1(word.encode("utf-8")).digest()
            ids.append(2 + int.from_bytes(digest[:4], "big") % (self.VOCAB - 2))
            offsets.append((start, end))
        return ids, offsets

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            chat_template=None, tools=None, **kwargs):
        parts = []
        for m in messages:
            content = m["content"]
            if isinstance(content, list):  # structured parts: join text parts
                content = " ".join(
                    p.get("text", "") for p in content if isinstance(p, dict)
                )
            line = f"<|{m['role']}|> {content}"
            if m.get("tool_calls"):
                names = ",".join(
                    str(tc.get("function", {}).get("name", tc.get("name", "?")))
                    if isinstance(tc, dict) else str(tc)
                    for tc in m["tool_calls"]
                )
                line += f" <|tool_calls|> {names}"
            parts.append(line)
        if tools:
            parts.insert(0, f"<|tools|> {len(tools)}")
        if kwargs.get("documents"):
            parts.insert(0, f"<|documents|> {len(kwargs['documents'])}")
        if add_generation_prompt:
            parts.append("<|assistant|>")
        return "\n".join(parts)


class HFTokenizer:
    """transformers-backed tokenizer adapter."""

    def __init__(self, model_name: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(model_name)

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def encode_with_offsets(self, text, add_special_tokens=True):
        enc = self._tok(
            text,
            add_special_tokens=add_special_tokens,
            return_offsets_mapping=True,
        )
        return list(enc["input_ids"]), [tuple(o) for o in enc["offset_mapping"]]

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            chat_template=None, tools=None, **kwargs):
        return self._tok.apply_chat_template(
            messages,
            tokenize=False,
            add_generation_prompt=add_generation_prompt,
            chat_template=chat_template,
            tools=tools,
            **kwargs,
        )


class TokenizerRegistry:
    """Thread-safe per-model tokenizer cache with eager initialization.

    Loading happens under a per-model lock so a slow HF load for one model
    never stalls requests for already-loaded models.
    """

    def __init__(self) -> None:
        self._lock = new_lock()
        self._tokenizers: dict[str, Tokenizer] = {}
        self._model_locks: dict[str, threading.Lock] = {}

    def get(self, model_name: str) -> Tokenizer:
        with self._lock:
            tok = self._tokenizers.get(model_name)
            if tok is not None:
                return tok
            model_lock = self._model_locks.setdefault(model_name, new_lock())
        with model_lock:
            with self._lock:
                tok = self._tokenizers.get(model_name)
                if tok is not None:
                    return tok
            tok = self._load(model_name)
            with self._lock:
                self._tokenizers[model_name] = tok
            return tok

    @staticmethod
    def _load(model_name: str) -> Tokenizer:
        if model_name.startswith("simple:") or model_name == "simple":
            return SimpleTokenizer()
        if model_name.startswith("hf:"):
            model_name = model_name[len("hf:"):]
        return HFTokenizer(model_name)
