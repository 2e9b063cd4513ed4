"""Tokenizer service client.

Port of ``llmd_kv_cache_tpu/services/tokenizer/client.py``; counterpart of reference ``pkg/tokenization/uds_tokenizer.go``: gRPC client
over ``unix://`` (TCP for tests) with large message caps, keepalive,
per-model initialization with bounded retry/backoff, and the Encode /
Render / RenderChat calls the indexer's prompt path needs. Also provides
``score_path_features``: rendered chat → (token_ids, extra_features) ready
for ``Indexer.score_tokens``. ``grpc`` is imported in the client's
constructor and the retry predicate (the client runs on the CPU only).
"""

from __future__ import annotations

from typing import Optional

from ...core.extra_keys import BlockExtraFeatures, PlaceholderRange, compute_block_extra_features
from ...resilience.failpoints import FaultInjected, failpoints
from ...resilience.policy import RetryPolicy, RetryExhausted, call_with_retry
from ...telemetry.tracing import current_traceparent, tracer
from ...utils.logging import get_logger
from ...utils.net import grpc_target
from .messages import (
    ChatMessage,
    InitializeTokenizerRequest,
    InitializeTokenizerResponse,
    RenderChatRequest,
    RenderChatResponse,
    RenderCompletionRequest,
    TokenizeRequest,
    TokenizeResponse,
)
from .service import MAX_MESSAGE_BYTES, SERVICE_NAME

logger = get_logger("services.tokenizer.client")

_INIT_RETRIES = 5
_INIT_BACKOFF_S = 0.5

# Error-mode fires at the entry of every outgoing RPC (chaos: flaky
# tokenizer sidecar). Injected faults are retried like transport errors.
FP_TOKENIZER_RPC = "services.tokenizer.rpc"

# Data-path RPCs ride the request hot path, so the budget is tight: one
# fast retry absorbs a transient blip, anything longer surfaces to the
# caller. Init gets its own longer policy (server may still be starting).
DEFAULT_RPC_RETRY_POLICY = RetryPolicy(
    max_attempts=2, base_delay_s=0.05, max_delay_s=0.5, deadline_s=5.0
)
_INIT_RETRY_POLICY = RetryPolicy(
    max_attempts=_INIT_RETRIES, base_delay_s=_INIT_BACKOFF_S, max_delay_s=5.0
)


class _InitFailed(Exception):
    """Application-level init failure (bad model name etc.): deterministic,
    retrying cannot help."""


def is_retryable(exc: BaseException) -> bool:
    """Transient transport failures only; application-level status codes
    (FAILED_PRECONDITION, INVALID_ARGUMENT, …) are deterministic and must
    surface to the caller untouched. The indexer client shares it."""
    if isinstance(exc, FaultInjected):
        return True
    import grpc  # an RpcError exists only where a gRPC client made it

    if isinstance(exc, grpc.RpcError):
        code = exc.code() if callable(getattr(exc, "code", None)) else None
        return code in (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED,
                        grpc.StatusCode.RESOURCE_EXHAUSTED)
    return False


class UdsTokenizerClient:
    """Blocking client for the tokenizer sidecar."""

    def __init__(self, address: str, timeout_s: float = 30.0,
                 retry_policy: Optional[RetryPolicy] = None):
        import grpc

        self._channel = grpc.insecure_channel(
            grpc_target(address),
            options=[
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                ("grpc.keepalive_time_ms", 30_000),
            ],
        )
        self._timeout = timeout_s
        self.retry_policy = retry_policy or DEFAULT_RPC_RETRY_POLICY
        self._initialized_models: set[str] = set()

        def unary(method, req_serializer, resp_deserializer):
            return self._channel.unary_unary(
                f"/{SERVICE_NAME}/{method}",
                request_serializer=req_serializer,
                response_deserializer=resp_deserializer,
            )

        self._init = unary(
            "InitializeTokenizer",
            lambda r: r.to_bytes(),
            InitializeTokenizerResponse.from_bytes,
        )
        self._tokenize = unary(
            "Tokenize", lambda r: r.to_bytes(), TokenizeResponse.from_bytes
        )
        self._render_completion = unary(
            "RenderCompletion", lambda r: r.to_bytes(), TokenizeResponse.from_bytes
        )
        self._render_chat = unary(
            "RenderChatCompletion", lambda r: r.to_bytes(), RenderChatResponse.from_bytes
        )

    def _call(self, rpc, request, method: str = ""):
        """Issue one unary RPC under the retry policy; transient transport
        errors and injected faults are retried. On exhaustion the last
        underlying error is re-raised so callers keep the grpc.RpcError
        contract.

        The ambient W3C trace context rides as ``traceparent`` gRPC
        metadata (injected per attempt), so the server-side span parents
        into the caller's trace across the UDS hop. The ambient request
        deadline rides as ``kvtpu-deadline-ms`` metadata the same way and
        caps the transport timeout — an already-expired budget fails the
        call before any wire traffic.
        """
        from ...resilience.deadline import (
            current_deadline,
            deadline_metadata,
            effective_timeout,
        )

        with tracer().span("llm_d.kv_cache.tokenizer.rpc", method=method):
            tp = current_traceparent()
            md = (("traceparent", tp),) if tp else ()
            md = md + tuple(deadline_metadata())
            metadata = md or None
            dl = current_deadline()
            timeout = effective_timeout(self._timeout)

            def attempt():
                if dl is not None:
                    dl.check("services.tokenizer.rpc")
                failpoints.hit(FP_TOKENIZER_RPC)
                return rpc(request, timeout=timeout, metadata=metadata)

            try:
                return call_with_retry(
                    attempt, self.retry_policy, retryable=is_retryable
                )
            except RetryExhausted as e:
                raise e.__cause__

    def initialize(self, model_name: str) -> None:
        """Eager per-model init with bounded retry/backoff
        (``uds_tokenizer.go:162-193``). Transport failures (server still
        starting) retry; application-level failures are deterministic and
        fail fast."""
        import grpc

        if model_name in self._initialized_models:
            return

        def attempt():
            failpoints.hit(FP_TOKENIZER_RPC)
            resp = self._init(
                InitializeTokenizerRequest(model_name), timeout=self._timeout
            )
            if not resp.success:
                raise _InitFailed(resp.error)
            return resp

        try:
            call_with_retry(attempt, _INIT_RETRY_POLICY, retryable=is_retryable)
        except (_InitFailed, RetryExhausted, grpc.RpcError) as e:
            cause = e.__cause__ if isinstance(e, RetryExhausted) else e
            raise RuntimeError(
                f"tokenizer init failed for {model_name}: {cause}"
            ) from e
        self._initialized_models.add(model_name)

    def encode(
        self,
        model_name: str,
        text: str,
        add_special_tokens: bool = True,
        return_offsets: bool = False,
    ) -> TokenizeResponse:
        resp = self._call(
            self._tokenize,
            method="Tokenize",
            request=TokenizeRequest(
                model_name=model_name,
                text=text,
                add_special_tokens=add_special_tokens,
                return_offsets=return_offsets,
            ),
        )
        if resp.error:
            raise RuntimeError(f"tokenize failed: {resp.error}")
        return resp

    def render(self, model_name: str, prompt: str,
               add_special_tokens: bool = True) -> list[int]:
        resp = self._call(
            self._render_completion,
            method="RenderCompletion",
            request=RenderCompletionRequest(
                model_name=model_name, prompt=prompt,
                add_special_tokens=add_special_tokens,
            ),
        )
        if resp.error:
            raise RuntimeError(f"render failed: {resp.error}")
        return resp.token_ids

    def render_chat(
        self,
        model_name: str,
        messages: list[ChatMessage],
        chat_template: Optional[str] = None,
        add_generation_prompt: bool = True,
        tools: Optional[list[dict]] = None,
        **template_kwargs,
    ) -> RenderChatResponse:
        resp = self._call(
            self._render_chat,
            method="RenderChatCompletion",
            request=RenderChatRequest(
                model_name=model_name,
                messages=messages,
                chat_template=chat_template,
                add_generation_prompt=add_generation_prompt,
                tools=tools,
                template_kwargs=template_kwargs,
            ),
        )
        if resp.error:
            raise RuntimeError(f"render chat failed: {resp.error}")
        return resp

    def score_path_features(
        self,
        model_name: str,
        messages: list[ChatMessage],
        block_size: int,
        **render_kwargs,
    ) -> tuple[list[int], Optional[list[Optional[BlockExtraFeatures]]]]:
        """Render a chat and produce (token_ids, extra_features) for
        ``Indexer.score_tokens`` — the deprecated in-process prompt path of
        the reference (``indexer.go:202-229``) as a client-side helper."""
        resp = self.render_chat(model_name, messages, **render_kwargs)
        placeholders = {
            modality: [PlaceholderRange(offset=o, length=n) for o, n in spans]
            for modality, spans in resp.mm_placeholders.items()
        }
        features = compute_block_extra_features(
            resp.mm_hashes, placeholders, block_size, len(resp.token_ids)
        )
        return resp.token_ids, features

    def close(self) -> None:
        self._channel.close()
