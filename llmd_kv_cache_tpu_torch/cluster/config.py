"""Cluster configuration: shard membership + fan-out knobs.

Copy of ``llmd_kv_cache_tpu/cluster/config.py``.

Rides the usual camelCase/snake_case ``from_dict`` convention
(docs/configuration.md "clusterConfig"). The membership list is static
config — the same list every scheduler and every shard replica reads —
so all parties derive the identical :class:`~.ring.HashRing` (the ring's
determinism guarantee depends on it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .ring import (
    DEFAULT_LOAD_FACTOR,
    DEFAULT_PARTITIONS,
    DEFAULT_VIRTUAL_NODES,
    HashRing,
)

# A degraded shard's keys are simply treated as index misses: the prefix
# chain breaks at the first unavailable block and scoring proceeds on
# what the healthy shards returned. The alternative ("fail") turns an
# unreachable shard into a scoring error — only for deployments that
# prefer loud failure over quietly shorter prefixes.
DEGRADED_SERVE_SKIP = "skip"
DEGRADED_SERVE_FAIL = "fail"


@dataclass
class ClusterConfig:
    """Sharded indexer control-plane knobs."""

    # Shard membership: one gRPC address per indexer shard replica. The
    # addresses double as shard ids unless shard_ids overrides them.
    shard_addresses: list[str] = field(default_factory=list)
    # Optional stable shard ids (defaults to the addresses). Useful when
    # addresses are ephemeral but identity must survive reschedules.
    shard_ids: list[str] = field(default_factory=list)
    # This replica's own shard id; empty on scheduler/router-side configs.
    shard_id: str = ""
    # shardCount is advisory/validation only: when set it must match the
    # membership size (catching config drift between fleet manifests).
    shard_count: int = 0
    # Ring shape (see cluster.ring).
    virtual_nodes: int = DEFAULT_VIRTUAL_NODES
    partitions: int = DEFAULT_PARTITIONS
    load_factor: float = DEFAULT_LOAD_FACTOR
    # How many distinct shards ingest each block key (1 = no redundancy;
    # 2 lets scoring fail over and anti-entropy repair a restarted shard).
    replication_factor: int = 2
    # Scatter-gather fan-out: per-chunk RPC deadline and the chunk size in
    # block keys (generalizes the single-index lookupChunkSize early exit
    # to cross-shard fan-out).
    fanout_timeout_s: float = 2.0
    fanout_chunk_blocks: int = 128
    # Batched fan-out (docs/architecture.md "Native data plane"): how many
    # early-exit chunks ride one framed LookupBlocksBatch RPC per shard.
    # Each gather window covers fanout_chunk_blocks * fanout_batch_chunks
    # keys with ONE RPC per owning shard instead of one per chunk; the
    # shard early-exits server-side at its first incomplete chunk and the
    # router truncates the merged map in chunk order, so scores stay
    # byte-identical to the per-chunk path. 0 disables (per-chunk RPCs).
    fanout_batch_chunks: int = 8
    degraded_serve_mode: str = DEGRADED_SERVE_SKIP
    # Ring-plan prefix cache entries (0 disables): (ring version, key
    # count, last chained key) → per-key owner plan.
    plan_cache_size: int = 2048
    # One overall scatter-gather deadline per chunk (seconds). 0 derives
    # it from fanout_timeout_s (the gather never outlives one RPC budget,
    # however many failovers/hedges run inside it). The ambient request
    # deadline, when present, caps it further.
    fanout_deadline_s: float = 0.0
    # Inter-shard circuit breaker (resilience.policy.CircuitBreaker).
    breaker_failure_threshold: int = 3
    breaker_reset_timeout_s: float = 5.0
    # Tail-tolerant hedged fan-out (resilience.hedging): when a shard's
    # RPC outlives its adaptive latency-quantile trigger, the same lookup
    # is issued to the keys' replica owner and the first response wins.
    hedge_enabled: bool = True
    # Latency quantile that arms the hedge trigger per shard (p95: only
    # the slowest ~5% of RPCs ever hedge on a healthy shard).
    hedge_quantile: float = 0.95
    # Floor on the hedge trigger delay — never hedge faster than this
    # even when a shard's quantile estimate collapses.
    hedge_min_delay_s: float = 0.002
    # Hedge budget: token bucket refilled by primary traffic. rate is the
    # steady-state hedge fraction cap; burst bounds accumulated credit.
    hedge_budget_rate: float = 0.1
    hedge_budget_burst: float = 8.0
    # Epoch fencing (cluster.membership): how receivers treat traffic
    # stamped with an older topology epoch than their own, and the
    # renewable pod-lease window that fences zombies deterministically.
    # "warn" counts/flags but serves (safe rollout default — legacy peers
    # never stamp an epoch at all); "reject" refuses stale writes.
    fence_mode: str = "warn"
    lease_ttl_s: float = 30.0
    lease_renew_s: float = 10.0

    def membership(self) -> list[str]:
        """Shard ids, index-aligned with shard_addresses."""
        if self.shard_ids:
            if len(self.shard_ids) != len(self.shard_addresses):
                raise ValueError(
                    f"shardIds ({len(self.shard_ids)}) and shardAddresses "
                    f"({len(self.shard_addresses)}) must be index-aligned"
                )
            return list(self.shard_ids)
        return list(self.shard_addresses)

    def address_of(self, shard_id: str) -> str:
        members = self.membership()
        try:
            return self.shard_addresses[members.index(shard_id)]
        except ValueError:
            raise KeyError(f"unknown shard id {shard_id!r}") from None

    def build_ring(self, epoch: int = 0) -> HashRing:
        members = self.membership()
        if self.shard_count and self.shard_count != len(members):
            raise ValueError(
                f"shardCount={self.shard_count} disagrees with the "
                f"{len(members)}-entry membership list"
            )
        return HashRing(
            members,
            virtual_nodes=self.virtual_nodes,
            partitions=self.partitions,
            load_factor=self.load_factor,
            epoch=epoch,
        )

    @property
    def enabled(self) -> bool:
        return len(self.shard_addresses) > 0

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ClusterConfig":
        if not d:
            return cls()
        vnodes = d.get("virtualNodes", d.get("virtual_nodes"))
        parts = d.get("partitions")
        rf = d.get("replicationFactor", d.get("replication_factor"))
        chunk = d.get("fanoutChunkBlocks", d.get("fanout_chunk_blocks"))
        batch = d.get("fanoutBatchChunks", d.get("fanout_batch_chunks"))
        plan = d.get("planCacheSize", d.get("plan_cache_size"))
        thresh = d.get("breakerFailureThreshold", d.get("breaker_failure_threshold"))
        return cls(
            shard_addresses=list(
                d.get("shardAddresses", d.get("shard_addresses", []))
            ),
            shard_ids=list(d.get("shardIds", d.get("shard_ids", []))),
            shard_id=d.get("shardId", d.get("shard_id", "")) or "",
            shard_count=d.get("shardCount", d.get("shard_count", 0)) or 0,
            virtual_nodes=DEFAULT_VIRTUAL_NODES if vnodes is None else vnodes,
            partitions=DEFAULT_PARTITIONS if parts is None else parts,
            load_factor=d.get(
                "loadFactor", d.get("load_factor", DEFAULT_LOAD_FACTOR)
            ),
            replication_factor=2 if rf is None else rf,
            fanout_timeout_s=d.get(
                "fanoutTimeoutS", d.get("fanout_timeout_s", 2.0)
            ),
            fanout_chunk_blocks=128 if chunk is None else chunk,
            fanout_batch_chunks=8 if batch is None else batch,
            degraded_serve_mode=d.get(
                "degradedServeMode",
                d.get("degraded_serve_mode", DEGRADED_SERVE_SKIP),
            )
            or DEGRADED_SERVE_SKIP,
            plan_cache_size=2048 if plan is None else plan,
            fanout_deadline_s=d.get(
                "fanoutDeadlineS", d.get("fanout_deadline_s", 0.0)
            ),
            breaker_failure_threshold=3 if thresh is None else thresh,
            breaker_reset_timeout_s=d.get(
                "breakerResetTimeoutS", d.get("breaker_reset_timeout_s", 5.0)
            ),
            hedge_enabled=bool(d.get(
                "hedgeEnabled", d.get("hedge_enabled", True)
            )),
            hedge_quantile=d.get(
                "hedgeQuantile", d.get("hedge_quantile", 0.95)
            ),
            hedge_min_delay_s=d.get(
                "hedgeMinDelayS", d.get("hedge_min_delay_s", 0.002)
            ),
            hedge_budget_rate=d.get(
                "hedgeBudgetRate", d.get("hedge_budget_rate", 0.1)
            ),
            hedge_budget_burst=d.get(
                "hedgeBudgetBurst", d.get("hedge_budget_burst", 8.0)
            ),
            fence_mode=d.get("fenceMode", d.get("fence_mode", "warn"))
            or "warn",
            lease_ttl_s=d.get("leaseTtlS", d.get("lease_ttl_s", 30.0)),
            lease_renew_s=d.get("leaseRenewS", d.get("lease_renew_s", 10.0)),
        )
