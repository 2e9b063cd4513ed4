"""gRPC address normalization shared by the sidecar services (port of
``llmd_kv_cache_tpu/utils/net.py``)."""

from __future__ import annotations


def grpc_target(address: str) -> str:
    """Normalize an address for gRPC bind/dial.

    - explicit schemes (``unix:``, ``dns://`` etc.) pass through
    - bare filesystem paths (no colon, or leading ``/``) become ``unix:``
    - ``host:port`` strings pass through as TCP targets
    """
    if "://" in address or address.startswith("unix:"):
        return address
    if address.startswith("/") or ":" not in address:
        return f"unix:{address}"
    return address
