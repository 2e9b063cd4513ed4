"""Resilience primitives of the offload tier: copies of the JAX package's
``resilience.failpoints``, ``resilience.policy`` and
``resilience.integrity``."""
