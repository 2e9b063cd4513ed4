"""Tokenizer RPC message types with msgpack wire encoding.

Port of ``llmd_kv_cache_tpu/services/tokenizer/messages.py``. Role parity
with reference ``api/tokenizerpb/tokenizer.proto``: the same five-call
surface and field sets, carried as msgpack maps (string keys,
forward-compatible: unknown keys are ignored on decode). Packed with
``utils.msgpack_codec``, byte-equal to the JAX package's
``msgpack.packb(..., use_bin_type=True)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ...utils.msgpack_codec import packb as _pack
from ...utils.msgpack_codec import unpackb as _unpack


@dataclass
class InitializeTokenizerRequest:
    model_name: str

    def to_bytes(self) -> bytes:
        return _pack({"model_name": self.model_name})

    @classmethod
    def from_bytes(cls, b: bytes) -> "InitializeTokenizerRequest":
        d = _unpack(b)
        return cls(model_name=d.get("model_name", ""))


@dataclass
class InitializeTokenizerResponse:
    success: bool = True
    error: str = ""

    def to_bytes(self) -> bytes:
        return _pack({"success": self.success, "error": self.error})

    @classmethod
    def from_bytes(cls, b: bytes) -> "InitializeTokenizerResponse":
        d = _unpack(b)
        return cls(success=d.get("success", False), error=d.get("error", ""))


@dataclass
class TokenizeRequest:
    model_name: str
    text: str
    add_special_tokens: bool = True
    return_offsets: bool = False

    def to_bytes(self) -> bytes:
        return _pack(
            {
                "model_name": self.model_name,
                "text": self.text,
                "add_special_tokens": self.add_special_tokens,
                "return_offsets": self.return_offsets,
            }
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "TokenizeRequest":
        d = _unpack(b)
        return cls(
            model_name=d.get("model_name", ""),
            text=d.get("text", ""),
            add_special_tokens=d.get("add_special_tokens", True),
            return_offsets=d.get("return_offsets", False),
        )


@dataclass
class TokenizeResponse:
    token_ids: list[int] = field(default_factory=list)
    offsets: list[tuple[int, int]] = field(default_factory=list)
    error: str = ""

    def to_bytes(self) -> bytes:
        return _pack(
            {
                "token_ids": self.token_ids,
                "offsets": [list(o) for o in self.offsets],
                "error": self.error,
            }
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "TokenizeResponse":
        d = _unpack(b)
        return cls(
            token_ids=list(d.get("token_ids", [])),
            offsets=[tuple(o) for o in d.get("offsets", [])],
            error=d.get("error", ""),
        )


@dataclass
class ChatMessage:
    role: str
    content: Any  # str or structured content parts (list of dicts)
    # Assistant tool calls (list of dicts), passed through to the chat
    # template when present.
    tool_calls: Optional[list] = None


@dataclass
class RenderChatRequest:
    model_name: str
    messages: list[ChatMessage] = field(default_factory=list)
    chat_template: Optional[str] = None
    add_generation_prompt: bool = True
    tools: Optional[list[dict]] = None
    template_kwargs: dict = field(default_factory=dict)

    def to_bytes(self) -> bytes:
        return _pack(
            {
                "model_name": self.model_name,
                "messages": [
                    {"role": m.role, "content": m.content,
                     "tool_calls": m.tool_calls}
                    for m in self.messages
                ],
                "chat_template": self.chat_template,
                "add_generation_prompt": self.add_generation_prompt,
                "tools": self.tools,
                "template_kwargs": self.template_kwargs,
            }
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "RenderChatRequest":
        d = _unpack(b)
        return cls(
            model_name=d.get("model_name", ""),
            messages=[
                ChatMessage(role=m.get("role", ""), content=m.get("content"),
                            tool_calls=m.get("tool_calls"))
                for m in d.get("messages", [])
            ],
            chat_template=d.get("chat_template"),
            add_generation_prompt=d.get("add_generation_prompt", True),
            tools=d.get("tools"),
            template_kwargs=d.get("template_kwargs", {}) or {},
        )


@dataclass
class RenderChatResponse:
    token_ids: list[int] = field(default_factory=list)
    rendered_text: str = ""
    # modality → content-hash identifiers, aligned with placeholders
    mm_hashes: dict[str, list[str]] = field(default_factory=dict)
    # modality → [(offset, length)] placeholder token ranges
    mm_placeholders: dict[str, list[tuple[int, int]]] = field(default_factory=dict)
    error: str = ""

    def to_bytes(self) -> bytes:
        return _pack(
            {
                "token_ids": self.token_ids,
                "rendered_text": self.rendered_text,
                "mm_hashes": self.mm_hashes,
                "mm_placeholders": {
                    k: [list(p) for p in v] for k, v in self.mm_placeholders.items()
                },
                "error": self.error,
            }
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "RenderChatResponse":
        d = _unpack(b)
        return cls(
            token_ids=list(d.get("token_ids", [])),
            rendered_text=d.get("rendered_text", ""),
            mm_hashes={k: list(v) for k, v in (d.get("mm_hashes") or {}).items()},
            mm_placeholders={
                k: [tuple(p) for p in v]
                for k, v in (d.get("mm_placeholders") or {}).items()
            },
            error=d.get("error", ""),
        )


@dataclass
class RenderCompletionRequest:
    model_name: str
    prompt: str
    add_special_tokens: bool = True

    def to_bytes(self) -> bytes:
        return _pack(
            {
                "model_name": self.model_name,
                "prompt": self.prompt,
                "add_special_tokens": self.add_special_tokens,
            }
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "RenderCompletionRequest":
        d = _unpack(b)
        return cls(
            model_name=d.get("model_name", ""),
            prompt=d.get("prompt", ""),
            add_special_tokens=d.get("add_special_tokens", True),
        )
