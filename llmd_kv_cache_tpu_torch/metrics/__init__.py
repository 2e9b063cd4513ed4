"""Metric families (port of ``llmd_kv_cache_tpu/metrics``) on an in-repo
registry with Prometheus text exposition (``metrics.registry``)."""

from .registry import REGISTRY, generate_latest

__all__ = ["REGISTRY", "generate_latest"]
