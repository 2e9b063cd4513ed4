"""Protobuf adapter for the tokenizer service.

Port of ``llmd_kv_cache_tpu/services/tokenizer/pb_service.py``. Serves the reference's ``tokenization.TokenizationService`` contract
(``api/tokenizerpb/tokenizer.proto:188-210``, spoken by the Go EPP's
``uds_tokenizer.go`` client) on the same gRPC server as the native
msgpack surface, by translating protobuf messages to the
transport-independent :class:`TokenizerService` calls.

Error model matches the reference servicer: failures are reported in the
response's ``success``/``error_message`` fields, not as gRPC status codes. ``tokenizer_pb2`` builds its messages at first
use and ``grpc`` is imported in :func:`make_pb_handler`, so importing this
module needs neither.
"""

from __future__ import annotations

import json
import uuid

from ...utils.logging import get_logger
from ..tokenizerpb import tokenizer_pb2 as pb
from .messages import (
    ChatMessage,
    InitializeTokenizerRequest,
    RenderChatRequest,
    TokenizeRequest,
)
from .service import TokenizerService

logger = get_logger("services.tokenizer.pb")

PROTO_SERVICE_NAME = "tokenization.TokenizationService"


def _value_to_py(v: pb.Value):
    kind = v.WhichOneof("value")
    if kind == "string_value":
        return v.string_value
    if kind == "number_value":
        return v.number_value
    if kind == "bool_value":
        return v.bool_value
    if kind == "list_value":
        return [_value_to_py(x) for x in v.list_value.values]
    if kind == "struct_value":
        return {k: _value_to_py(x) for k, x in v.struct_value.fields.items()}
    return None


def _message_to_internal(m: pb.ChatMessage) -> ChatMessage:
    if m.HasField("content"):
        content = m.content
    elif m.content_parts:
        parts = []
        for part in m.content_parts:
            if part.type == "image_url" and part.HasField("image_url"):
                parts.append(
                    {"type": "image_url", "image_url": {"url": part.image_url.url}}
                )
            else:
                parts.append({"type": "text",
                              "text": part.text if part.HasField("text") else ""})
        content = parts
    else:
        content = ""
    msg = ChatMessage(role=m.role, content=content)
    if m.HasField("tool_calls_json") and m.tool_calls_json:
        try:
            msg.tool_calls = json.loads(m.tool_calls_json)
        except json.JSONDecodeError:
            logger.warning("unparseable tool_calls_json; ignoring")
    return msg


class TokenizerPbServicer:
    """Protobuf-facing RPC implementations delegating to TokenizerService."""

    def __init__(self, service: TokenizerService):
        self.service = service

    def tokenize(self, req: pb.TokenizeRequest, _ctx) -> pb.TokenizeResponse:
        resp = self.service.tokenize(
            TokenizeRequest(
                model_name=req.model_name,
                text=req.input,
                add_special_tokens=req.add_special_tokens,
                return_offsets=True,
            )
        )
        if resp.error:
            return pb.TokenizeResponse(success=False, error_message=resp.error)
        flat = [x for pair in resp.offsets for x in pair]
        return pb.TokenizeResponse(
            input_ids=resp.token_ids, success=True, offset_pairs=flat
        )

    def initialize_tokenizer(
        self, req: pb.InitializeTokenizerRequest, _ctx
    ) -> pb.InitializeTokenizerResponse:
        # enable_thinking / add_generation_prompt are per-render options in
        # this implementation (applied at RenderChatCompletion time), not
        # load-time state; accepted here for wire compatibility.
        resp = self.service.initialize_tokenizer(
            InitializeTokenizerRequest(model_name=req.model_name)
        )
        return pb.InitializeTokenizerResponse(
            success=resp.success, error_message=resp.error
        )

    def render_chat_template(
        self, req: pb.ChatTemplateRequest, _ctx
    ) -> pb.ChatTemplateResponse:
        """Deprecated RPC: render-only (no tokenization)."""
        try:
            tok = self.service.registry.get(req.model_name)
            messages = []
            for turn in req.conversation_turns:
                for m in turn.messages:
                    im = _message_to_internal(m)
                    d = {"role": im.role, "content": im.content}
                    if im.tool_calls:
                        d["tool_calls"] = im.tool_calls
                    messages.append(d)
            kwargs = {k: _value_to_py(v)
                      for k, v in req.chat_template_kwargs.items()}
            if req.continue_final_message:
                kwargs["continue_final_message"] = True
            tools = [
                {k: _value_to_py(v) for k, v in t.tool.items()}
                for t in req.tools
            ]
            documents = [
                {k: _value_to_py(v) for k, v in doc.document.items()}
                for doc in req.documents
            ]
            if documents:
                kwargs["documents"] = documents
            rendered = tok.apply_chat_template(
                messages,
                add_generation_prompt=req.add_generation_prompt,
                chat_template=req.chat_template or None,
                tools=tools or None,
                **kwargs,
            )
            return pb.ChatTemplateResponse(rendered_prompt=rendered, success=True)
        except Exception as e:
            logger.exception("RenderChatTemplate failed")
            return pb.ChatTemplateResponse(success=False, error_message=str(e))

    def render_completion(
        self, req: pb.RenderCompletionRequest, _ctx
    ) -> pb.RenderCompletionResponse:
        resp = self.service.tokenize(
            TokenizeRequest(model_name=req.model_name, text=req.prompt)
        )
        if resp.error:
            return pb.RenderCompletionResponse(
                success=False, error_message=resp.error
            )
        return pb.RenderCompletionResponse(
            request_id=f"rndr-{uuid.uuid4().hex}",
            token_ids=resp.token_ids,
            success=True,
        )

    def render_chat_completion(
        self, req: pb.RenderChatCompletionRequest, _ctx
    ) -> pb.RenderChatCompletionResponse:
        tools = None
        if req.HasField("tools_json") and req.tools_json:
            try:
                tools = json.loads(req.tools_json)
            except json.JSONDecodeError as e:
                return pb.RenderChatCompletionResponse(
                    success=False, error_message=f"bad tools_json: {e}"
                )
        kwargs = {}
        if req.HasField("chat_template_kwargs") and req.chat_template_kwargs:
            try:
                kwargs = json.loads(req.chat_template_kwargs)
            except json.JSONDecodeError as e:
                return pb.RenderChatCompletionResponse(
                    success=False, error_message=f"bad chat_template_kwargs: {e}"
                )
        if req.continue_final_message:
            kwargs["continue_final_message"] = True
        add_gen = (
            req.add_generation_prompt
            if req.HasField("add_generation_prompt")
            else True
        )
        resp = self.service.render_chat_completion(
            RenderChatRequest(
                model_name=req.model_name,
                messages=[_message_to_internal(m) for m in req.messages],
                chat_template=req.chat_template or None,
                add_generation_prompt=add_gen,
                tools=tools,
                template_kwargs=kwargs,
            )
        )
        if resp.error:
            return pb.RenderChatCompletionResponse(
                success=False, error_message=resp.error
            )
        features = pb.MultiModalFeatures()
        for modality, hashes in resp.mm_hashes.items():
            features.mm_hashes[modality].values.extend(hashes)
        for modality, ranges in resp.mm_placeholders.items():
            features.mm_placeholders[modality].ranges.extend(
                pb.PlaceholderRange(offset=o, length=n) for o, n in ranges
            )
        return pb.RenderChatCompletionResponse(
            request_id=f"chat-{uuid.uuid4().hex}",
            token_ids=resp.token_ids,
            features=features,
            success=True,
        )


def make_pb_handler(service: TokenizerService):
    """Generic handler (a ``grpc.GenericRpcHandler``) serving the protobuf
    contract; add alongside the msgpack handler on one server."""
    import grpc

    servicer = TokenizerPbServicer(service)
    rpcs = {
        "Tokenize": (servicer.tokenize,
                     pb.TokenizeRequest, pb.TokenizeResponse),
        "RenderChatTemplate": (servicer.render_chat_template,
                               pb.ChatTemplateRequest, pb.ChatTemplateResponse),
        "InitializeTokenizer": (servicer.initialize_tokenizer,
                                pb.InitializeTokenizerRequest,
                                pb.InitializeTokenizerResponse),
        "RenderChatCompletion": (servicer.render_chat_completion,
                                 pb.RenderChatCompletionRequest,
                                 pb.RenderChatCompletionResponse),
        "RenderCompletion": (servicer.render_completion,
                             pb.RenderCompletionRequest,
                             pb.RenderCompletionResponse),
    }
    method_handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
        for name, (fn, req_cls, resp_cls) in rpcs.items()
    }
    return grpc.method_handlers_generic_handler(PROTO_SERVICE_NAME, method_handlers)
