"""Tokenizer/renderer sidecar: gRPC over a Unix domain socket.

Port of ``llmd_kv_cache_tpu/services/tokenizer``; counterpart of reference ``services/uds_tokenizer`` + ``pkg/tokenization``:
the indexer needs exact token ids (and multimodal hashes/placeholders) to
content-address prompts the same way the engines do, so tokenization and
chat-template rendering run in a Python sidecar sharing the engines'
tokenizer stack, reached over a local socket.

Wire: gRPC generic handlers with msgpack-encoded messages (the reference
uses protobuf; the RPC surface — Tokenize / InitializeTokenizer /
RenderChatCompletion / RenderCompletion — is the same, and msgpack keeps
this image free of protoc codegen). The protobuf contract of the
reference is served beside it (``pb_service``). ``grpc`` is imported only
where a server or client is made.
"""

from .messages import (
    ChatMessage,
    RenderChatRequest,
    RenderChatResponse,
    TokenizeRequest,
    TokenizeResponse,
)
from .service import TokenizerService, serve_uds
from .client import UdsTokenizerClient

__all__ = [
    "ChatMessage",
    "RenderChatRequest",
    "RenderChatResponse",
    "TokenizeRequest",
    "TokenizeResponse",
    "TokenizerService",
    "serve_uds",
    "UdsTokenizerClient",
]
