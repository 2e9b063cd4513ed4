"""Pod digests over an index's ``dump_state()`` (the pure helpers of
``llmd_kv_cache_tpu/recovery/reconcile.py``).

A pod digest is order-independent::

    digest(pod) = XOR over blocks of fnv1a_64(cbor([request_key, row]))

where ``row`` is the snapshot row ``[pod, tier, flags, group_idx]``.
XOR-of-hashes makes the digest insensitive to iteration order and O(1) to
compare. The indexer service answers ``GetPodDigest`` and ``GetPodBlocks``
with these. The rest of the JAX module (``DigestSource``,
``IndexDigestSource``, ``AntiEntropyReconciler``, ``DivergenceAuditor``)
comes with the recovery and cluster planes (ROADMAP A.8.6).
"""

from __future__ import annotations

from typing import Optional

from ..utils.cbor import canonical_cbor_encode
from ..utils.fnv import fnv1a_64


def _row_hash(request_key: int, row: list) -> int:
    return fnv1a_64(canonical_cbor_encode([request_key, list(row)]))


def pod_blocks_from_state(state: Optional[dict], pod: str) -> dict:
    """``{request_key: {row_tuple, ...}}`` for one pod, from a
    ``dump_state()`` document."""
    out: dict = {}
    if not state:
        return out
    for request_key, rows in state.get("entries", []):
        mine = {tuple(r) for r in rows if r[0] == pod}
        if mine:
            out[request_key] = mine
    return out


def digest_from_blocks(blocks: dict) -> dict:
    """Order-independent ``{"count": n, "digest": x}`` over pod blocks."""
    digest = 0
    count = 0
    for request_key, rows in blocks.items():
        for row in rows:
            digest ^= _row_hash(request_key, list(row))
            count += 1
    return {"count": count, "digest": digest}
