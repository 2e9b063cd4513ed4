"""Inter-shard RPC client + cross-replica anti-entropy digest source.

Port of ``llmd_kv_cache_tpu/cluster/remote.py``. Frames pack and unpack
with ``utils.msgpack_codec``, byte-equal to the JAX client's
``msgpack.packb(..., use_bin_type=True)``; ``grpc`` is reached only in
:class:`ShardClient`'s constructor, through ``services.channel_pool``.
:class:`LocalShardClient` (the port's own) hands the same frame bytes to
an in-process ``IndexerService``'s shard surface, for a fleet that runs
in one process or on a host without ``grpc``.

:class:`ShardClient` speaks the msgpack-over-gRPC shard surface of
``services.indexer_service`` (``LookupBlocks`` for scatter-gather,
``ListPods``/``GetPodDigest``/``GetPodBlocks`` for repair), over the
shared channel pool and under the same retry policy as scoring RPCs.

:class:`RemoteShardDigestSource` lifts the intra-process anti-entropy
reconciler to inter-node repair: it implements the
``recovery.reconcile.DigestSource`` protocol over the *other* replicas
of a shard's key range. A restarted shard bootstraps from its own
snapshot+journal, then reconciles against its peers — every key it owns
with ``replication_factor >= 2`` has at least one other live owner, so
the union of peer views (filtered to locally-owned keys) is the truth
to converge to.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.keys import BlockHash, PodEntry
from ..recovery.reconcile import digest_from_blocks
from ..resilience.policy import RetryPolicy
from ..utils.logging import get_logger
from ..utils.msgpack_codec import packb, unpackb
from .ring import HashRing

logger = get_logger("cluster.remote")


def entry_from_row(row: Sequence) -> PodEntry:
    """Snapshot wire row ``[pod, tier, flags, group_idx]`` → PodEntry."""
    return PodEntry(
        pod_identifier=row[0],
        device_tier=row[1],
        speculative=bool(int(row[2]) & 1),
        has_group=bool(int(row[2]) & 2),
        group_idx=row[3],
    )


def _pack(d: dict) -> bytes:
    return packb(d)


def _unpack(b: bytes) -> dict:
    return unpackb(b)


class ShardClient:
    """Router/peer-side client for one indexer shard replica."""

    def __init__(self, address: str, timeout_s: float = 2.0,
                 retry_policy: Optional[RetryPolicy] = None):
        # Deferred to call time elsewhere would hide config typos; the
        # shared pool makes construction cheap enough to do eagerly.
        from ..services import channel_pool
        from ..services.indexer_service import DEFAULT_RPC_RETRY_POLICY, SERVICE_NAME

        self.address = address
        self._channel = channel_pool.acquire(address)

        def method(name: str):
            return self._channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=_pack,
                response_deserializer=_unpack,
            )

        self._bind(method, timeout_s, retry_policy or DEFAULT_RPC_RETRY_POLICY)

    def _bind(self, method, timeout_s: float, retry_policy: RetryPolicy) -> None:
        self._timeout = timeout_s
        self.retry_policy = retry_policy
        self._lookup_blocks = method("LookupBlocks")
        self._lookup_blocks_batch = method("LookupBlocksBatch")
        self._list_pods = method("ListPods")
        self._pod_digest = method("GetPodDigest")
        self._pod_blocks = method("GetPodBlocks")

    def lookup_blocks(
        self,
        keys: Sequence[BlockHash],
        pods: Optional[Sequence[str]] = None,
        timeout: Optional[float] = None,
        deadline: Optional["object"] = None,
        hedge: bool = False,
        epoch: int = 0,
    ) -> dict:
        """Raw lookup: ``{"hits": {key: [PodEntry,...]}, "degraded": bool,
        "shard": str, "epoch": int}``. Raises grpc.RpcError on transport
        failure (the router's breaker/failover logic owns error handling).

        ``deadline`` (a resilience.deadline.Deadline) rides the frame as
        the tolerant ``deadline_ms`` relative budget and caps the client
        timeout; ``hedge`` tags the frame so shards can count hedged load;
        ``epoch`` stamps the caller's topology epoch (cluster.membership)
        the same tolerant way, and the server's own epoch rides back on
        the response for piggyback learning (all three keys are ignored
        by older peers)."""
        from ..resilience.deadline import Deadline
        from ..services.indexer_service import _call_rpc

        frame = {"keys": [int(k) for k in keys], "pods": list(pods or [])}
        eff_timeout = timeout if timeout is not None else self._timeout
        if isinstance(deadline, Deadline):
            frame["deadline_ms"] = deadline.to_wire_ms()
            eff_timeout = deadline.cap_timeout(eff_timeout)
        if hedge:
            frame["hedge"] = True
        if epoch:
            frame["epoch"] = int(epoch)
        resp = _call_rpc(
            self._lookup_blocks,
            frame,
            eff_timeout,
            self.retry_policy,
        )
        hits: dict[BlockHash, list[PodEntry]] = {}
        for key, rows in resp.get("hits", []):
            hits[int(key)] = [entry_from_row(r) for r in rows]
        return {
            "hits": hits,
            "degraded": bool(resp.get("degraded", False)),
            "shard": resp.get("shard", "") or "",
            "epoch": int(resp.get("epoch", 0) or 0),
        }

    def lookup_blocks_batch(
        self,
        chunks: Sequence[Sequence[BlockHash]],
        pods: Optional[Sequence[str]] = None,
        timeout: Optional[float] = None,
        deadline: Optional["object"] = None,
        hedge: bool = False,
        epoch: int = 0,
    ) -> dict:
        """Framed multi-chunk lookup (the batched fan-out data plane):
        one RPC carries a whole gather window's worth of early-exit
        chunks and the shard answers them in order with per-chunk
        continuation flags, early-exiting at its first incomplete chunk.

        Returns ``{"hits": {key: [PodEntry,...]}, "cont": [bool,...],
        "degraded": bool, "shard": str}`` with ``hits`` flattened across
        the answered chunks — the router re-derives chunk boundaries from
        its own key order, so a response missing ``cont`` (or answering
        the flat old-frame shape) degrades gracefully to "every answered
        key counts". Raises grpc.RpcError on transport failure, including
        UNIMPLEMENTED from a pre-batch shard (the router's cue to fall
        back to per-chunk ``lookup_blocks``)."""
        from ..resilience.deadline import Deadline
        from ..services.indexer_service import _call_rpc

        frame = {
            "chunks": [[int(k) for k in c] for c in chunks],
            "pods": list(pods or []),
        }
        eff_timeout = timeout if timeout is not None else self._timeout
        if isinstance(deadline, Deadline):
            frame["deadline_ms"] = deadline.to_wire_ms()
            eff_timeout = deadline.cap_timeout(eff_timeout)
        if hedge:
            frame["hedge"] = True
        if epoch:
            frame["epoch"] = int(epoch)
        resp = _call_rpc(
            self._lookup_blocks_batch,
            frame,
            eff_timeout,
            self.retry_policy,
        )
        raw = resp.get("chunks")
        if raw is None:
            # Old-frame tolerance: a peer that answered the flat
            # LookupBlocks layout — one implicit chunk.
            raw = [resp.get("hits", [])]
        hits: dict[BlockHash, list[PodEntry]] = {}
        for chunk_hits in raw:
            for key, rows in chunk_hits:
                hits[int(key)] = [entry_from_row(r) for r in rows]
        return {
            "hits": hits,
            "cont": [bool(f) for f in resp.get("cont", []) or []],
            "degraded": bool(resp.get("degraded", False)),
            "shard": resp.get("shard", "") or "",
            "epoch": int(resp.get("epoch", 0) or 0),
        }

    def list_pods(self, timeout: Optional[float] = None) -> list[str]:
        from ..services.indexer_service import _call_rpc

        resp = _call_rpc(self._list_pods, {},
                         timeout if timeout is not None else self._timeout,
                         self.retry_policy)
        return list(resp.get("pods", []))

    def pod_digest(self, pod: str, timeout: Optional[float] = None) -> dict:
        from ..services.indexer_service import _call_rpc

        resp = _call_rpc(self._pod_digest, {"pod": pod},
                         timeout if timeout is not None else self._timeout,
                         self.retry_policy)
        return {"count": int(resp.get("count", 0)),
                "digest": int(resp.get("digest", 0))}

    def pod_blocks(self, pod: str, timeout: Optional[float] = None) -> dict:
        """``{request_key: {row_tuple, ...}}`` — the reconcile wire shape."""
        from ..services.indexer_service import _call_rpc

        resp = _call_rpc(self._pod_blocks, {"pod": pod},
                         timeout if timeout is not None else self._timeout,
                         self.retry_policy)
        return {
            int(key): {tuple(r) for r in rows}
            for key, rows in resp.get("blocks", [])
        }

    def close(self) -> None:
        from ..services import channel_pool

        channel_pool.release(self.address)


class _LocalContext:
    """The call's metadata (trace context, deadline) as a gRPC servicer
    context shows it to the service."""

    def __init__(self, metadata):
        self._metadata = tuple(metadata or ())

    def invocation_metadata(self):
        return self._metadata


class LocalShardClient(ShardClient):
    """A :class:`ShardClient` over an in-process ``IndexerService``.

    Each call packs its frame as ``ShardClient`` sends it on the wire, the
    service unpacks it, answers through its shard surface
    (``lookup_blocks_rpc``, ``lookup_blocks_batch_rpc``, ...), and the
    answer crosses back as packed bytes: the frames, the retry policy, the
    failpoints and the response parsing are ``ShardClient``'s own, with no
    channel. ``frames`` counts the request bytes carried."""

    def __init__(self, service, address: str = "", timeout_s: float = 2.0,
                 retry_policy: Optional[RetryPolicy] = None):
        from ..services.indexer_service import (
            DEFAULT_RPC_RETRY_POLICY,
            _pack_dict,
            _unpack_dict,
        )

        self.address = address or f"local:{service.shard_id}"
        self.service = service
        self.frames = 0
        self.frame_bytes = 0
        handlers = {
            "LookupBlocks": service.lookup_blocks_rpc,
            "LookupBlocksBatch": service.lookup_blocks_batch_rpc,
            "ListPods": service.list_pods_rpc,
            "GetPodDigest": service.pod_digest_rpc,
            "GetPodBlocks": service.pod_blocks_rpc,
        }

        def method(name: str):
            handler = handlers[name]

            def call(request, timeout=None, metadata=None):
                wire = _pack(request)
                self.frames += 1
                self.frame_bytes += len(wire)
                answer = handler(_unpack_dict(wire), _LocalContext(metadata))
                return _unpack(_pack_dict(answer))
            return call

        self._bind(method, timeout_s, retry_policy or DEFAULT_RPC_RETRY_POLICY)

    def close(self) -> None:
        pass


class RemoteShardDigestSource:
    """``DigestSource`` over the union of a shard's replica peers.

    ``blocks(pod)`` merges every reachable peer's advertised blocks,
    filtered to the keys ``shard_id`` owns — exactly the set the local
    index should converge to. ``digest(pod)`` is computed client-side
    from that merged view (peers answer with their *own* key ranges, so
    their server-side digests are not directly comparable); this trades
    a full fetch per round for correctness, which is fine at repair
    cadence. Unreachable peers are skipped — repair proceeds on the
    replicas that are up.
    """

    def __init__(self, peers: Sequence[ShardClient], ring: HashRing,
                 shard_id: str, replication_factor: int = 2):
        self.peers = list(peers)
        self.ring = ring
        self.shard_id = shard_id
        self.replication_factor = max(1, replication_factor)

    def _owns(self, key: BlockHash) -> bool:
        return self.shard_id in self.ring.owners(key, self.replication_factor)

    def pods(self) -> list:
        seen: set[str] = set()
        for peer in self.peers:
            try:
                seen.update(peer.list_pods())
            except Exception:  # dead peer; repair on the rest
                logger.warning("digest peer %s unreachable (ListPods)", peer.address)
        return sorted(seen)

    def blocks(self, pod: str) -> dict:
        merged: dict = {}
        for peer in self.peers:
            try:
                view = peer.pod_blocks(pod)
            except Exception:  # dead peer; repair on the rest
                logger.warning("digest peer %s unreachable (GetPodBlocks)", peer.address)
                continue
            for key, rows in view.items():
                if self._owns(key):
                    merged.setdefault(key, set()).update(rows)
        return merged

    def digest(self, pod: str) -> dict:
        return digest_from_blocks(self.blocks(pod))
