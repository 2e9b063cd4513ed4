"""Epoch-fenced membership: topology epochs, pod leases, zombie fencing.

Copy of ``llmd_kv_cache_tpu/cluster/membership.py``: the same fence
decisions, ``FP_RENEW_PREFIX`` failpoints (the port's registry),
``KIND_FENCE`` flight records and lease/fence/epoch metric families.

The fleet's classic split-brain/zombie failures share one root cause: an
actor keeps acting on a topology the rest of the fleet has moved past —
a pod resumes from a GC pause and keeps ingesting, a router scores
against a stale ring mid-rebalance, a warm-restarted controller re-runs
a mutation a newer controller already made. The standard remedy
(GFS/Chubby lease discipline, the fencing-token pattern) is implemented
here as two small primitives:

- a monotonic **topology epoch**, minted by the fleet controller on
  every topology mutation and stamped as tolerant wire metadata (the
  ``deadline_ms`` arrival pattern) on shard RPCs, score requests,
  KV-event batches, and handoff begins. Receivers refuse — or flag, per
  the ``fenceMode: reject|warn`` knob — traffic carrying an *older*
  epoch than their own, and **learn** newer epochs from any incoming
  stamp (gossip-by-piggyback: propagation needs no new service, any
  traffic at all carries the bump).
- renewable **pod leases** bound to the current epoch. A pod that stops
  renewing (paused, partitioned, live-locked) lapses past ``leaseTtlS``;
  from then on its writes are fenced *deterministically* — not "demoted
  when latency looks bad" but "rejected until it re-admits through the
  warm-restart gate" (:class:`~..recovery.manager.RecoveryManager`
  readiness), which forces the zombie back through snapshot/journal
  replay before its view of the world counts again.

Epoch ``0`` on any wire means "unstamped" (a legacy peer) and is never
fenced — rollout stays compatible in ``warn`` mode by construction.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from ..metrics.collector import (
    LEASE_ACTIVE,
    LEASE_EXPIRED,
    LEASE_READMISSIONS,
    LEASE_RENEWALS,
    record_fence_rejection,
    record_topology_epoch,
)
from ..resilience.failpoints import failpoints
from ..telemetry.flight_recorder import KIND_FENCE
from ..telemetry.flight_recorder import record as fr_record
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger

logger = get_logger("cluster.membership")

FENCE_WARN = "warn"
FENCE_REJECT = "reject"
_FENCE_MODES = (FENCE_WARN, FENCE_REJECT)

# Fence reasons (the {reason} label of kvtpu_fence_rejections_total).
REASON_STALE_EPOCH = "stale_epoch"
REASON_LEASE_LAPSED = "lease_lapsed"
REASON_NOT_READMITTED = "not_readmitted"

# First topology every fleet starts at; wire epoch 0 = "unstamped".
GENESIS_EPOCH = 1

# Failpoint consulted on each lease renewal: ``membership.renew.<pod>``
# armed in ``pause`` mode ages the lease by the virtual stall instead of
# renewing it — a GC-paused zombie without a real sleep anywhere.
FP_RENEW_PREFIX = "membership.renew."


@dataclass(frozen=True)
class FenceDecision:
    """Outcome of one fence check at a receiving site."""

    allowed: bool
    reason: str = ""  # "" when clean; a REASON_* otherwise
    # True when the traffic was stale but fenceMode=warn let it through
    # (the metric/flight-record still fired — dashboards see the zombie
    # before the knob is flipped to reject).
    flagged: bool = False
    # Receiver's topology epoch at decision time (stamped on responses
    # so the sender learns it — the piggyback half of gossip).
    epoch: int = 0


@dataclass
class Lease:
    """One pod's renewable membership lease."""

    pod_id: str
    epoch: int  # topology epoch the last grant/renewal bound to
    granted_ts: float
    renewed_ts: float
    ttl_s: float
    lapsed: bool = False  # set once per lapse episode (metric edge)

    def remaining_s(self, now: float) -> float:
        return self.ttl_s - (now - self.renewed_ts)

    def age_s(self, now: float) -> float:
        return now - self.renewed_ts


class MembershipTable:
    """Thread-safe epoch + lease registry shared by the receiving sites.

    One instance per process (the indexer service owns it and hands it
    to the event pool, the router, and the debug surface). All methods
    are cheap enough for the score hot path: a clean :meth:`check_request`
    is a lock-free integer compare returning a cached decision (CPython
    attribute reads are atomic; the cached decision is swapped under the
    lock whenever the epoch advances).
    """

    def __init__(
        self,
        fence_mode: str = FENCE_WARN,
        lease_ttl_s: float = 30.0,
        lease_renew_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        epoch: int = GENESIS_EPOCH,
    ):
        if fence_mode not in _FENCE_MODES:
            raise ValueError(
                f"fenceMode must be one of {_FENCE_MODES}, got {fence_mode!r}"
            )
        if lease_ttl_s <= 0 or lease_renew_s <= 0:
            raise ValueError("leaseTtlS and leaseRenewS must be positive")
        if lease_renew_s >= lease_ttl_s:
            raise ValueError(
                f"leaseRenewS ({lease_renew_s}) must be shorter than "
                f"leaseTtlS ({lease_ttl_s}) or a single missed renewal lapses"
            )
        self.fence_mode = fence_mode
        self.lease_ttl_s = float(lease_ttl_s)
        self.lease_renew_s = float(lease_renew_s)
        self._clock = clock
        self._mu = new_lock()
        self._epoch = max(int(epoch), GENESIS_EPOCH)
        self._leases: dict[str, Lease] = {}
        # Epoch-bump observers (the router swaps its ring plan here);
        # called outside the lock with the new epoch.
        self._listeners: list[Callable[[int], None]] = []
        # Last few rejections for kvdiag's membership section.
        self._recent: deque = deque(maxlen=32)
        self.rejections = 0
        self.flagged = 0
        # Singleton clean verdict for the hot path: one per epoch, so a
        # same-epoch check is a compare + cached return, no allocation.
        self._clean = FenceDecision(allowed=True, epoch=self._epoch)
        record_topology_epoch(self._epoch)

    @classmethod
    def from_cluster_config(cls, cfg, clock: Callable[[], float] = time.monotonic
                            ) -> "MembershipTable":
        return cls(
            fence_mode=getattr(cfg, "fence_mode", FENCE_WARN) or FENCE_WARN,
            lease_ttl_s=getattr(cfg, "lease_ttl_s", 30.0),
            lease_renew_s=getattr(cfg, "lease_renew_s", 10.0),
            clock=clock,
        )

    # -- topology epoch ---------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._mu:
            return self._epoch

    def add_epoch_listener(self, fn: Callable[[int], None]) -> None:
        with self._mu:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def observe_epoch(self, epoch: int, source: str = "") -> bool:
        """Learn a possibly-newer epoch from incoming traffic (or from the
        controller's commit). Returns True when the local epoch advanced."""
        epoch = int(epoch)
        with self._mu:
            if epoch <= self._epoch:
                return False
            self._epoch = epoch
            self._clean = FenceDecision(allowed=True, epoch=epoch)
            listeners = list(self._listeners)
        record_topology_epoch(epoch)
        fr_record(KIND_FENCE, {"event": "epoch_learned", "epoch": epoch,
                                  "source": source})
        logger.info("topology epoch advanced to %d (source=%s)", epoch, source)
        for fn in listeners:
            try:
                fn(epoch)
            except Exception:  # observers must not break the plane
                logger.exception("epoch listener failed")
        return True

    # -- leases -----------------------------------------------------------

    def grant(self, pod_id: str) -> Lease:
        """Admit a pod under a fresh lease bound to the current epoch."""
        now = self._clock()
        with self._mu:
            lease = Lease(pod_id=pod_id, epoch=self._epoch, granted_ts=now,
                          renewed_ts=now, ttl_s=self.lease_ttl_s)
            self._leases[pod_id] = lease
        self._update_lease_gauge()
        return lease

    def renew(self, pod_id: str) -> bool:
        """One renewal heartbeat. A pod mid-GC-pause misses these; the
        ``membership.renew.<pod>`` pause failpoint simulates exactly that
        by *aging* the lease instead of renewing it."""
        stall = failpoints.pause_seconds(FP_RENEW_PREFIX + pod_id)
        now = self._clock()
        with self._mu:
            lease = self._leases.get(pod_id)
            if lease is None:
                return False
            if stall > 0.0:
                # The renewal the zombie never sent: rewind the stamp so
                # the lease looks exactly ``stall`` seconds colder.
                lease.renewed_ts -= stall
                lapsed = self._lapse_locked(lease, now)
            else:
                if self._lapse_locked(lease, now):
                    # Lapsed leases don't renew — the pod must readmit
                    # through the warm-restart gate.
                    lapsed = True
                else:
                    lease.renewed_ts = now
                    lease.epoch = self._epoch
                    LEASE_RENEWALS.inc()
                    lapsed = False
        self._update_lease_gauge()
        return not lapsed and stall == 0.0

    def lease_valid(self, pod_id: str) -> bool:
        now = self._clock()
        with self._mu:
            lease = self._leases.get(pod_id)
            if lease is None:
                return False
            return not self._lapse_locked(lease, now)

    def readmit(self, pod_id: str, gate=None) -> bool:
        """Re-admit a lapsed pod through the warm-restart gate.

        ``gate`` is the pod's :class:`~..recovery.manager.RecoveryManager`
        (anything with a truthy ``ready``): a zombie cannot simply ask
        back in — it must have re-run snapshot-restore + journal replay
        so its index view is rebuilt, not resumed."""
        if gate is not None:
            ready = gate.ready() if callable(getattr(gate, "ready", None)) \
                else getattr(gate, "ready", False)
            if not ready:
                self._reject("membership.readmit", REASON_NOT_READMITTED,
                             pod_id=pod_id, hard=True)
                return False
        self.grant(pod_id)
        LEASE_READMISSIONS.inc()
        fr_record(KIND_FENCE, {"event": "readmitted", "pod": pod_id,
                                  "epoch": self.epoch})
        return True

    def _lapse_locked(self, lease: Lease, now: float) -> bool:
        """Check + latch a lease's lapse state (callers hold the lock)."""
        if lease.remaining_s(now) >= 0.0:
            return lease.lapsed
        if not lease.lapsed:
            lease.lapsed = True
            LEASE_EXPIRED.inc()
            logger.warning("lease for pod %s lapsed (%.1fs past TTL)",
                           lease.pod_id, -lease.remaining_s(now))
        return True

    def _update_lease_gauge(self) -> None:
        now = self._clock()
        with self._mu:
            live = sum(1 for l in self._leases.values()
                       if l.remaining_s(now) >= 0.0)
        LEASE_ACTIVE.set(live)

    # -- fence checks -----------------------------------------------------

    def check_request(self, epoch: int, site: str) -> FenceDecision:
        """Read-path fence (score/lookup): epoch staleness only.

        Newer stamps are learned (piggyback); epoch 0 is a legacy peer
        and always clean."""
        # Hot path: same-epoch (or unstamped legacy) traffic. Lock-free —
        # a torn read across _epoch/_clean at worst detours to the slow
        # path below, never misclassifies.
        clean = self._clean
        if epoch == clean.epoch or not epoch:
            return clean
        epoch = int(epoch or 0)
        with self._mu:
            mine = self._epoch
        if epoch > mine:
            self.observe_epoch(epoch, source=site)
            return FenceDecision(allowed=True, epoch=epoch)
        if epoch and epoch < mine:
            return self._reject(site, REASON_STALE_EPOCH, stamp=epoch)
        return self._clean

    def check_write(self, pod_id: str, epoch: int, site: str) -> FenceDecision:
        """Write-path fence (event ingest, handoff): the epoch check plus
        the zombie check — a pod under lease management whose lease
        lapsed gets its writes refused until it re-admits. Pods never
        granted a lease (legacy / solo deployments) are not fenced."""
        now = self._clock()
        with self._mu:
            mine = self._epoch
            lease = self._leases.get(pod_id)
            lapsed = lease is not None and self._lapse_locked(lease, now)
        if lapsed:
            return self._reject(site, REASON_LEASE_LAPSED, pod_id=pod_id)
        return self.check_request(epoch, site)

    def _reject(self, site: str, reason: str, pod_id: str = "",
                stamp: int = 0, hard: bool = False) -> FenceDecision:
        mine = self.epoch
        record_fence_rejection(site, reason)
        fr_record(KIND_FENCE, {"event": "rejected", "site": site,
                                  "reason": reason, "pod": pod_id,
                                  "stamp": stamp, "epoch": mine})
        entry = {"ts": time.time(), "site": site, "reason": reason,
                 "pod": pod_id, "stamp": stamp, "epoch": mine}
        rejecting = hard or self.fence_mode == FENCE_REJECT
        with self._mu:
            self._recent.append(entry)
            if rejecting:
                self.rejections += 1
            else:
                self.flagged += 1
        if rejecting:
            return FenceDecision(allowed=False, reason=reason, epoch=mine)
        return FenceDecision(allowed=True, reason=reason, flagged=True,
                             epoch=mine)

    # -- introspection ----------------------------------------------------

    def debug_view(self) -> dict:
        """The ``/debug/membership`` payload (and kvdiag's fleet section):
        epoch, per-pod lease ages, and the recent rejection ring."""
        now = self._clock()
        with self._mu:
            leases = {
                pod: {
                    "epoch": l.epoch,
                    "age_s": round(l.age_s(now), 3),
                    "remaining_s": round(l.remaining_s(now), 3),
                    "lapsed": l.lapsed or l.remaining_s(now) < 0.0,
                }
                for pod, l in sorted(self._leases.items())
            }
            return {
                "epoch": self._epoch,
                "fence_mode": self.fence_mode,
                "lease_ttl_s": self.lease_ttl_s,
                "lease_renew_s": self.lease_renew_s,
                "leases": leases,
                "rejections": self.rejections,
                "flagged": self.flagged,
                "recent_rejections": list(self._recent),
            }
