"""Engine-specific event adapters (copy of ``llmd_kv_cache_tpu/events/adapters``)."""

from .vllm import VLLMAdapter
from .sglang import SGLangAdapter


def create_adapter(engine_type: str = "vllm"):
    """Select an adapter by engine type (reference ``engineadapter/adapter.go``)."""
    engine_type = (engine_type or "vllm").lower()
    if engine_type == "vllm":
        return VLLMAdapter()
    if engine_type == "sglang":
        return SGLangAdapter()
    raise ValueError(f"unknown engine type: {engine_type}")


__all__ = ["VLLMAdapter", "SGLangAdapter", "create_adapter"]
