"""Sharded indexer control plane (port of ``llmd_kv_cache_tpu/cluster``):
consistent-hash partitioning of the block index across N indexer shard
replicas, scatter-gather scoring, replica failover, hedged fan-out, and
the epoch-fenced membership plane (leases + fencing tokens). Host code:
it imports neither ``grpc`` nor ``msgpack`` at import; ``grpc`` is reached
only in ``remote.ShardClient``'s constructor, through
``services.channel_pool.acquire``."""

from .config import ClusterConfig
from .membership import FenceDecision, Lease, MembershipTable
from .ring import HashRing, assignment_fingerprint, moved_partitions, plan_owners
from .router import DegradedShardError, RouterScore, ShardRouter
from .sharded_index import ShardedIndex, ShardFilterIndex

__all__ = [
    "ClusterConfig",
    "DegradedShardError",
    "FenceDecision",
    "HashRing",
    "Lease",
    "MembershipTable",
    "RouterScore",
    "ShardRouter",
    "ShardedIndex",
    "ShardFilterIndex",
    "assignment_fingerprint",
    "moved_partitions",
    "plan_owners",
]
