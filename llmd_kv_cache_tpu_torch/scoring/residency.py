"""Transferred-prefix residency for role-aware decode-pod scoring.

Copy of ``llmd_kv_cache_tpu/scoring/residency.py``, with a plain
``threading.Lock`` where the JAX package takes a lockdep-witnessed lock.

Disaggregated serving (offload.handoff) moves a request's prefill KV to a
decode pod through the shared transfer tier. While that transfer is in
flight the global index knows nothing yet — the storage tier's tokenless
BlockStored only lands when a store completes, and it names no *decode*
pod at all. This tracker is the scorer-side view of that gap: the handoff
coordinator registers which blocks are headed to (in flight) or already
pullable by (landed) each decode pod, and ``bonus`` converts that into a
consecutive-from-0 prefix score the indexer adds for ``role="decode"``
requests — landed blocks at full weight, in-flight blocks discounted
(they may still shed or fail), the whole bonus scaled by the transfer
tier's restore-latency discount when the index exposes one
(``index.cost_aware.CostAwareMemoryIndex.tier_discount``).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence


class ResidencyTracker:
    """Per-decode-pod transferred-block residency, with in-flight discount.

    Claims are released when the handoff settles
    (:meth:`release_pod_claims`): from then on the storage tier's own
    BlockStored advertisements carry the residency signal through the
    normal index path, and keeping stale claims would double-count it.
    """

    def __init__(self, landed_weight: float = 1.0,
                 in_flight_discount: float = 0.5):
        self.landed_weight = landed_weight
        self.in_flight_discount = in_flight_discount
        self._mu = threading.Lock()
        # block hash → {decode pod → landed?}
        self._claims: dict[int, dict[str, bool]] = {}
        self._pod_blocks: dict[str, set[int]] = {}
        # Optional transfer-tier restore-latency discount, wired by
        # Indexer.attach_residency when the index has a tier_discount
        # hook. Applied only here — i.e. only when residency scoring is
        # on — never to the base prefix scores.
        self.tier_discount_fn: Optional[Callable[[], float]] = None

    # -- coordinator-side updates ---------------------------------------

    def on_transfer_started(self, pod: str,
                            block_hashes: Sequence[int]) -> None:
        with self._mu:
            blocks = self._pod_blocks.setdefault(pod, set())
            for h in block_hashes:
                self._claims.setdefault(h, {}).setdefault(pod, False)
                blocks.add(h)

    def on_landed(self, pod: str, block_hashes: Sequence[int]) -> None:
        with self._mu:
            blocks = self._pod_blocks.setdefault(pod, set())
            for h in block_hashes:
                self._claims.setdefault(h, {})[pod] = True
                blocks.add(h)

    def on_released(self, pod: str, block_hashes: Sequence[int]) -> None:
        """Drop specific claims (a shed/failed chunk never lands)."""
        with self._mu:
            blocks = self._pod_blocks.get(pod)
            for h in block_hashes:
                pods = self._claims.get(h)
                if pods is not None:
                    pods.pop(pod, None)
                    if not pods:
                        del self._claims[h]
                if blocks is not None:
                    blocks.discard(h)

    def release_pod_claims(self, pod: str) -> None:
        """Drop every claim for ``pod`` (its handoff settled)."""
        with self._mu:
            blocks = self._pod_blocks.pop(pod, set())
            for h in blocks:
                pods = self._claims.get(h)
                if pods is not None:
                    pods.pop(pod, None)
                    if not pods:
                        del self._claims[h]

    # -- scorer-side read ------------------------------------------------

    def bonus(
        self,
        block_keys: Sequence[int],
        pod_identifiers: Optional[set[str]] = None,
    ) -> dict[str, float]:
        """Consecutive-from-0 residency bonus per decode pod.

        Same accumulation rule as the longest-prefix scorer: a pod's
        bonus runs along the key chain until its first unclaimed block.
        """
        with self._mu:
            pods = [
                p for p in self._pod_blocks
                if self._pod_blocks[p]
                and (not pod_identifiers or p in pod_identifiers)
            ]
            if not pods:
                return {}
            claims = {k: dict(self._claims.get(k, {})) for k in block_keys}
        discount = self.discount()
        out: dict[str, float] = {}
        for pod in pods:
            total = 0.0
            for key in block_keys:
                landed = claims.get(key, {}).get(pod)
                if landed is None:
                    break
                total += (self.landed_weight if landed
                          else self.in_flight_discount)
            if total > 0.0:
                out[pod] = total * discount
        return out

    def claim_rows(
        self,
        block_keys: Sequence[int],
        pod_identifiers: Optional[set[str]] = None,
    ) -> list[tuple[str, int, bool]]:
        """Sparse ``(pod, key_index, landed)`` rows for the native fold-in.

        The same claim view :meth:`bonus` walks, flattened positionally so
        ``kvidx_score_chunked`` can run the consecutive-from-0 walk inside
        the index lock: a pod with no row at index 0 accumulates nothing,
        exactly like ``bonus``'s break-at-first-unclaimed rule. Returns
        an empty list when no (allowed) pod holds claims — callers skip
        the native residency arguments entirely then.
        """
        with self._mu:
            pods = {
                p for p in self._pod_blocks
                if self._pod_blocks[p]
                and (not pod_identifiers or p in pod_identifiers)
            }
            if not pods:
                return []
            rows: list[tuple[str, int, bool]] = []
            for idx, key in enumerate(block_keys):
                claimants = self._claims.get(key)
                if not claimants:
                    continue
                for pod, landed in claimants.items():
                    if pod in pods:
                        rows.append((pod, idx, landed))
            return rows

    def discount(self) -> float:
        """Evaluate the transfer-tier restore-latency discount (1.0 when
        absent or failing) — the scalar :meth:`bonus` multiplies in."""
        if self.tier_discount_fn is None:
            return 1.0
        try:
            return float(self.tier_discount_fn())
        except Exception:  # pragma: no cover  # lint: allow-swallow
            return 1.0

    def debug(self) -> dict:
        with self._mu:
            return {
                "claimed_blocks": len(self._claims),
                "pods": {p: len(b) for p, b in self._pod_blocks.items()},
            }
