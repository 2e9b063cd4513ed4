"""gRPC tokenizer service over a Unix domain socket.

Port of ``llmd_kv_cache_tpu/services/tokenizer/service.py``; counterpart of reference ``services/uds_tokenizer`` (asyncio gRPC server on
a unix socket, ``run_grpc_server.py``) and its servicer
(``tokenizer_grpc_service.py``). RPCs are registered through generic
method handlers with msgpack serializers — no codegen.

RPC surface (service ``kvtpu.tokenizer.TokenizationService``):
  InitializeTokenizer  — eager per-model load (clients call once, with
                         retries, before serving traffic)
  Tokenize             — text → token ids (+ byte offsets)
  RenderCompletion     — completion prompt → token ids
  RenderChatCompletion — chat messages (+ tools, template kwargs,
                         multimodal parts) → token ids + MM hashes and
                         placeholder ranges for extra-key computation

:class:`TokenizerService` is transport-independent and stdlib-only (it
serves in-process on the card); ``grpc`` is imported where a server is
made (:func:`serve_uds`), held on the CPU.
"""

from __future__ import annotations

import hashlib
import uuid
from concurrent import futures
from typing import Optional

from ...telemetry.tracing import tracer
from ...utils.logging import get_logger
from ...utils.net import grpc_target
from .backends import TokenizerRegistry
from .messages import (
    InitializeTokenizerRequest,
    InitializeTokenizerResponse,
    RenderChatRequest,
    RenderChatResponse,
    RenderCompletionRequest,
    TokenizeRequest,
    TokenizeResponse,
)

logger = get_logger("services.tokenizer")

SERVICE_NAME = "kvtpu.tokenizer.TokenizationService"
MAX_MESSAGE_BYTES = 100 * 1024 * 1024  # match reference caps (uds_tokenizer.go:109-122)


class TokenizerService:
    """RPC implementations (transport-independent)."""

    def __init__(self, registry: Optional[TokenizerRegistry] = None):
        self.registry = registry or TokenizerRegistry()

    # -- RPCs --

    def initialize_tokenizer(
        self, req: InitializeTokenizerRequest
    ) -> InitializeTokenizerResponse:
        try:
            self.registry.get(req.model_name)
            return InitializeTokenizerResponse(success=True)
        except Exception as e:
            logger.exception("tokenizer init failed for %s", req.model_name)
            return InitializeTokenizerResponse(success=False, error=str(e))

    def tokenize(self, req: TokenizeRequest) -> TokenizeResponse:
        try:
            tok = self.registry.get(req.model_name)
            if req.return_offsets:
                ids, offsets = tok.encode_with_offsets(
                    req.text, add_special_tokens=req.add_special_tokens
                )
                return TokenizeResponse(token_ids=ids, offsets=offsets)
            ids = tok.encode(req.text, add_special_tokens=req.add_special_tokens)
            return TokenizeResponse(token_ids=ids)
        except Exception as e:
            logger.exception("tokenize failed")
            return TokenizeResponse(error=str(e))

    def render_completion(self, req: RenderCompletionRequest) -> TokenizeResponse:
        return self.tokenize(
            TokenizeRequest(
                model_name=req.model_name,
                text=req.prompt,
                add_special_tokens=req.add_special_tokens,
            )
        )

    def render_chat_completion(self, req: RenderChatRequest) -> RenderChatResponse:
        try:
            tok = self.registry.get(req.model_name)
            messages = []
            for m in req.messages:
                d = {"role": m.role, "content": m.content}
                if m.tool_calls:
                    d["tool_calls"] = m.tool_calls
                messages.append(d)

            # Multimodal parts are replaced by per-item UNIQUE sentinels
            # before template rendering. Uniqueness (uuid per item) makes
            # placeholder location collision-proof: user text can never
            # contain the sentinel, and each occurrence maps 1:1 to its
            # item in document order. Content hashes feed block extra-keys.
            mm_items: list[tuple[str, str, str]] = []  # (sentinel, modality, hash)
            for m in messages:
                if not isinstance(m["content"], list):
                    continue
                new_parts = []
                for part in m["content"]:
                    modality = _part_modality(part) if isinstance(part, dict) else None
                    if modality is None:
                        new_parts.append(part)
                        continue
                    payload = _part_payload(part)
                    identifier = hashlib.sha256(payload).hexdigest()
                    sentinel = f"<|mm-{uuid.uuid4().hex[:12]}|>"
                    mm_items.append((sentinel, modality, identifier))
                    new_parts.append({"type": "text", "text": sentinel})
                m["content"] = new_parts

            rendered = tok.apply_chat_template(
                messages,
                add_generation_prompt=req.add_generation_prompt,
                chat_template=req.chat_template,
                tools=req.tools,
                **req.template_kwargs,
            )

            if not mm_items:
                ids = tok.encode(rendered, add_special_tokens=True)
                return RenderChatResponse(token_ids=ids, rendered_text=rendered)

            # Build the token stream segment-by-segment so every placeholder
            # offset is known exactly (no token-subsequence guessing, which
            # breaks when BPE merges markers with their neighbors): text
            # segments are tokenized independently with the placeholder
            # marker tokens spliced between them.
            ids: list[int] = []
            mm_hashes: dict[str, list[str]] = {}
            mm_placeholders: dict[str, list[tuple[int, int]]] = {}
            rest = rendered
            display_text = rendered
            for sentinel, modality, identifier in mm_items:
                before, sep, rest = rest.partition(sentinel)
                display_text = display_text.replace(sentinel, f"<|{modality}|>", 1)
                if not sep:
                    # Template dropped the part (e.g. text-only template):
                    # no placeholder, and no hash — the item is absent from
                    # the token stream, so it must not taint blocks. Restore
                    # the unconsumed text for the remaining sentinels.
                    rest = before
                    continue
                # Specials (BOS) go on the first *encoded* segment, wherever
                # that falls — templates may drop earlier items.
                seg_ids = tok.encode(before, add_special_tokens=not ids)
                ids.extend(seg_ids)
                marker_ids = tok.encode(f"<|{modality}|>", add_special_tokens=False)
                mm_hashes.setdefault(modality, []).append(identifier)
                mm_placeholders.setdefault(modality, []).append(
                    (len(ids), len(marker_ids))
                )
                ids.extend(marker_ids)
            if rest:
                ids.extend(tok.encode(rest, add_special_tokens=not ids))

            return RenderChatResponse(
                token_ids=ids,
                rendered_text=display_text,
                mm_hashes=mm_hashes,
                mm_placeholders=mm_placeholders,
            )
        except Exception as e:
            logger.exception("render chat failed")
            return RenderChatResponse(error=str(e))


def _part_modality(part: dict) -> Optional[str]:
    t = part.get("type", "")
    if t in ("image", "image_url", "input_image"):
        return "image"
    if t in ("audio", "input_audio"):
        return "audio"
    if t == "video":
        return "video"
    return None


def _part_payload(part: dict) -> bytes:
    for key in ("data", "image_url", "url", "audio", "video"):
        v = part.get(key)
        if isinstance(v, dict):
            v = v.get("url", "")
        if v:
            return str(v).encode("utf-8")
    return repr(sorted(part.items())).encode("utf-8")


def _make_grpc_handler(service: TokenizerService):
    """Register RPCs as generic unary-unary handlers with msgpack codecs."""
    import grpc

    rpcs = {
        "InitializeTokenizer": (
            service.initialize_tokenizer,
            InitializeTokenizerRequest.from_bytes,
            lambda resp: resp.to_bytes(),
        ),
        "Tokenize": (
            service.tokenize,
            TokenizeRequest.from_bytes,
            lambda resp: resp.to_bytes(),
        ),
        "RenderCompletion": (
            service.render_completion,
            RenderCompletionRequest.from_bytes,
            lambda resp: resp.to_bytes(),
        ),
        "RenderChatCompletion": (
            service.render_chat_completion,
            RenderChatRequest.from_bytes,
            lambda resp: resp.to_bytes(),
        ),
    }

    method_handlers = {}
    for name, (fn, deserialize, serialize) in rpcs.items():
        def make(fn=fn, name=name):
            def handler(request, context):
                # Server-side half of the W3C hop: parent this span under
                # the caller's traceparent metadata when present, so one
                # trace covers client call + server work.
                with tracer().span(
                    f"llm_d.kv_cache.tokenizer.{name}",
                    parent_traceparent=extract_traceparent(context),
                ):
                    return fn(request)
            return handler

        method_handlers[name] = grpc.unary_unary_rpc_method_handler(
            make(),
            request_deserializer=deserialize,
            response_serializer=serialize,
        )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, method_handlers)


def extract_traceparent(context) -> Optional[str]:
    """Pull the W3C ``traceparent`` from gRPC invocation metadata (None
    when absent or the context does not expose metadata)."""
    if context is None:
        return None
    try:
        metadata = context.invocation_metadata()
    except Exception:  # pragma: no cover - non-grpc test doubles  # lint: allow-swallow
        return None
    if not metadata:
        return None
    for key, value in metadata:
        if key == "traceparent" and isinstance(value, str):
            return value
    return None


def serve_uds(
    socket_path: str,
    service: Optional[TokenizerService] = None,
    max_workers: int = 8,
):
    """Start the tokenizer gRPC server bound to ``unix:<socket_path>``.

    Returns the started server (caller stops it). Pass a plain filesystem
    path (``unix:`` is prepended) or a full gRPC address like
    ``127.0.0.1:0`` for TCP tests.
    """
    import grpc

    from .pb_service import make_pb_handler

    service = service or TokenizerService()
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
        ],
    )
    # Two wires, one server: the native msgpack convention and the
    # reference's protobuf contract (what llm-d's Go client speaks).
    server.add_generic_rpc_handlers(
        (_make_grpc_handler(service), make_pb_handler(service))
    )
    address = grpc_target(socket_path)
    server.add_insecure_port(address)
    server.start()
    logger.info("tokenizer service on %s", address)
    return server


def main() -> None:  # pragma: no cover - deployment entry point
    import argparse

    from ...utils.logging import configure_from_env

    configure_from_env()
    parser = argparse.ArgumentParser(description="kvtpu tokenizer sidecar")
    parser.add_argument("--socket", default="/tmp/kvtpu-tokenizer.sock")
    parser.add_argument("--max-workers", type=int, default=8)
    args = parser.parse_args()
    server = serve_uds(args.socket, max_workers=args.max_workers)
    server.wait_for_termination()


if __name__ == "__main__":  # pragma: no cover
    main()
