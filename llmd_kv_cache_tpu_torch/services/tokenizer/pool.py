"""Tokenization worker pool + prompt-based scoring path.

Port of ``llmd_kv_cache_tpu/services/tokenizer/pool.py``; counterpart of reference ``pkg/tokenization/pool.go`` (worker pool over a
rate-limited queue with blocking ``Tokenize`` and bounded retries) and the
deprecated ``Indexer.GetPodScores(prompt)`` path (``indexer.go:202-229``):
schedulers that only have the raw prompt/chat go through here; schedulers
that already have token ids call ``Indexer.score_tokens`` directly.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

from ...core.extra_keys import BlockExtraFeatures
from ...metrics.collector import TOKENIZATION_LATENCY
from ...scoring.indexer import Indexer
from ...utils.logging import get_logger
from .client import UdsTokenizerClient
from .messages import ChatMessage

logger = get_logger("services.tokenizer.pool")

_MAX_ATTEMPTS = 3  # reference pool drops a task after 3 failures


@dataclass
class TokenizationPoolConfig:
    workers: int = 5
    queue_size: int = 1024
    request_timeout_s: float = 30.0


class _Task:
    __slots__ = ("model_name", "prompt", "messages", "block_size", "result",
                 "done", "error")

    def __init__(self, model_name, prompt, messages, block_size):
        self.model_name = model_name
        self.prompt = prompt
        self.messages = messages
        self.block_size = block_size
        self.result = None
        self.error: Optional[str] = None
        self.done = threading.Event()


class TokenizationPool:
    """Bounded worker pool around the UDS tokenizer client."""

    def __init__(self, client: UdsTokenizerClient,
                 cfg: Optional[TokenizationPoolConfig] = None,
                 block_size: int = 16):
        self.client = client
        self.cfg = cfg or TokenizationPoolConfig()
        self.block_size = block_size
        self._queue: queue.Queue = queue.Queue(maxsize=self.cfg.queue_size)
        self._threads: list[threading.Thread] = []
        self._stop = object()
        self._started = False

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for i in range(self.cfg.workers):
            t = threading.Thread(target=self._worker, name=f"tok-pool-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        if not self._started:
            return
        for _ in self._threads:
            self._queue.put(self._stop)
        for t in self._threads:
            t.join()
        self._threads.clear()
        self._started = False

    def _worker(self) -> None:
        while True:
            task = self._queue.get()  # lint: allow-no-deadline (worker parks for work; shutdown via sentinel)
            try:
                if task is self._stop:
                    return
                self._run_task(task)
            finally:
                self._queue.task_done()

    def _run_task(self, task: _Task) -> None:
        import grpc

        start = time.perf_counter()
        for attempt in range(_MAX_ATTEMPTS):
            try:
                if task.messages is not None:
                    task.result = self.client.score_path_features(
                        task.model_name, task.messages, task.block_size
                    )
                else:
                    resp = self.client.encode(task.model_name, task.prompt)
                    task.result = (resp.token_ids, None)
                TOKENIZATION_LATENCY.observe(time.perf_counter() - start)
                task.done.set()
                return
            except grpc.RpcError as e:
                # Transport failures are retryable, with backoff so a
                # briefly-overloaded sidecar isn't hammered.
                task.error = str(e)
                logger.warning("tokenize attempt %d/%d failed: %s",
                               attempt + 1, _MAX_ATTEMPTS, e)
                if attempt < _MAX_ATTEMPTS - 1:
                    time.sleep(0.1 * (attempt + 1))
            except Exception as e:
                # Application-level failures (bad model, render error) are
                # deterministic: fail immediately.
                task.error = str(e)
                break
        task.done.set()  # dropped

    def tokenize(
        self,
        model_name: str,
        prompt: Optional[str] = None,
        messages: Optional[Sequence[ChatMessage]] = None,
        block_size: Optional[int] = None,
    ) -> tuple[list[int], Optional[list[Optional[BlockExtraFeatures]]]]:
        """Blocking tokenize/render through the pool.

        One overall deadline (``request_timeout_s``) covers queueing and
        execution.
        """
        if (prompt is None) == (messages is None):
            raise ValueError("provide exactly one of prompt or messages")
        if messages is not None and not messages:
            raise ValueError("messages must be non-empty")
        task = _Task(model_name, prompt,
                     list(messages) if messages is not None else None,
                     block_size if block_size is not None else self.block_size)
        deadline = time.monotonic() + self.cfg.request_timeout_s
        try:
            self._queue.put(task, timeout=self.cfg.request_timeout_s)
        except queue.Full:
            raise TimeoutError("tokenization queue full") from None
        if not task.done.wait(max(deadline - time.monotonic(), 0.0)):
            raise TimeoutError("tokenization timed out")
        if task.result is None:
            raise RuntimeError(f"tokenization failed: {task.error}")
        return task.result


class PromptScorer:
    """``GetPodScores(prompt)``: render + score in one call."""

    def __init__(self, indexer: Indexer, pool: TokenizationPool):
        self.indexer = indexer
        self.pool = pool

    def get_pod_scores(
        self,
        model_name: str,
        prompt: Optional[str] = None,
        messages: Optional[Sequence[ChatMessage]] = None,
        pod_identifiers: Optional[set[str]] = None,
    ) -> dict[str, float]:
        # Block size comes from the indexer's own processor so multimodal
        # features are computed at exactly the scoring granularity.
        tokens, features = self.pool.tokenize(
            model_name, prompt, messages,
            block_size=self.indexer.token_processor.block_size,
        )
        return self.indexer.score_tokens(
            tokens, model_name, pod_identifiers, features
        )
