"""Online working-set analytics: reuse distances + miss-ratio curves.

Copy of ``llmd_kv_cache_tpu/telemetry/workingset.py``.

The fleet can trace, profile, and alert on itself, but
capacity questions — "would 2x HBM double the hit ratio?", "which
offloaded blocks are written and never read back?", "how much cross-pod
duplication exists?" — need *reuse* measurements, not latency ones.
This module is that measurement substrate (stdlib only), feeding the
SSD-admission and cross-tenant-dedup ROADMAP items.

Design (SHARDS-style spatial hash sampling):

- A block key is **sampled** iff ``mix64(key) < rate * 2^64`` — a fixed
  spatial filter, so every process that sees a key makes the *same*
  sampling decision (no coordination, no PYTHONHASHSEED dependence) and
  the sampled stream is an unbiased 1-in-``1/rate`` subset of distinct
  blocks. The recording hooks themselves are a single batch enqueue
  (they ride the score p50); per-key work drains amortized.
- For sampled keys, an exact LRU **stack distance** is computed among
  sampled keys (OrderedDict recency list + Fenwick tree over logical
  access timestamps, periodically renumbered), then scaled by
  ``1/rate``: the SHARDS estimator. Distances land in a geometric
  (ratio 2^0.25) histogram, from which the **miss-ratio curve** — estimated
  hit ratio as a function of cache capacity — is evaluated at any
  capacity grid (``estimate_hit_ratio``). Cold (first-touch) accesses
  are counted separately; they miss at every capacity.
- Tracked state is bounded: at most ``max_tracked_blocks`` sampled keys
  per scope; beyond that the coldest sampled key is forgotten (its next
  access counts as cold — the estimator degrades toward pessimism, not
  bias explosion).
- A **written-never-read ledger** on the offload admission path (sampled
  stored keys vs. sampled restored keys), an **eviction-age histogram**
  fed from ``BlockManager`` evictions, and a **duplication estimator**
  (fraction of sampled index keys resident on >= 2 pods) ride along in
  the same windows.
- Every ``window_s`` the live state is sealed into a window on an
  evict-oldest ring and exported at ``/debug/workingset?since=`` with
  the same cursor semantics as ``/debug/spans`` / ``/debug/pyprof``;
  the fleet collector merges windows sample-weighted
  (:func:`merge_workingset_windows`) into the ``kvdiag --fleet``
  what-if capacity table.
- The tracker self-measures: wall time inside record calls accumulates
  into ``overhead_frac`` per window (plus ``kvtpu_workingset_*``
  families), and ``bench.py --workingset`` gates it < 1% of the
  score-path p50 *and* validates the sampled MRC against an
  exact-simulation oracle.

Scopes are tiers within one process ("hbm", "storage", "index"); the
per-pod dimension comes from the window's ``process`` identity, exactly
like pyprof windows.
"""

from __future__ import annotations

import time
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .tracing import process_identity

logger = get_logger("telemetry.workingset")

_MASK64 = (1 << 64) - 1

# Tier scope names (window["scopes"] keys). Per-pod curves come from the
# window's process identity, so scopes stay tier-only.
SCOPE_HBM = "hbm"
SCOPE_CPU = "cpu"
SCOPE_STORAGE = "storage"
SCOPE_INDEX = "index"


def _metrics():
    """Lazy metric handles so the module (and kvdiag, which imports the
    merge helpers) stays importable without the metrics stack."""
    try:
        from ..metrics.collector import (
            WORKINGSET_OVERHEAD_SECONDS,
            WORKINGSET_SAMPLED_TOTAL,
            WORKINGSET_TRACKED_BLOCKS,
            WORKINGSET_WINDOWS_DROPPED,
        )

        return (WORKINGSET_SAMPLED_TOTAL, WORKINGSET_OVERHEAD_SECONDS,
                WORKINGSET_TRACKED_BLOCKS, WORKINGSET_WINDOWS_DROPPED)
    except Exception:  # pragma: no cover - metrics stack absent
        return None


def mix64(x: int) -> int:
    """splitmix64 finalizer: a deterministic 64-bit avalanche.

    Block keys are usually content hashes already, but admission paths
    also see small test keys (0, 1, 2, ...); the mix makes the spatial
    filter uniform for both without any per-process state.
    """
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def key64(key) -> int:
    """64-bit spatial-sampling hash for a block key (int/str/bytes)."""
    if isinstance(key, int):
        return mix64(key & _MASK64)
    if isinstance(key, str):
        key = key.encode("utf-8", "surrogatepass")
    # Two salted crc32 halves: cheap, stdlib, process-independent.
    return mix64((zlib.crc32(key) << 32) | zlib.crc32(key, 0x9E3779B9))


@dataclass(frozen=True)
class WorkingSetConfig:
    """``fleetTelemetry.workingset`` knobs (camelCase in config files)."""

    enabled: bool = False
    # Spatial sampling rate R: a key is tracked iff hash(key) < R * 2^64.
    # Estimates are unbiased in R; cost is linear in R. SHARDS reports
    # ~1% MRC error at R=0.01 on real traces; the toy fleet's traces are
    # short, so default higher for tighter small-sample error.
    sample_rate: float = 0.05
    # Windowing: seal live state every window_s; keep max_windows sealed
    # windows on the evict-oldest export ring.
    window_s: float = 10.0
    max_windows: int = 30
    # Hard cap on tracked sampled keys per scope (LRU forget beyond it)
    # and on the never-read / duplication key sets.
    max_tracked_blocks: int = 4096

    @classmethod
    def from_dict(cls, data: Optional[dict]) -> "WorkingSetConfig":
        if not data:
            return cls()

        def k(camel: str, snake: str, default):
            if camel in data:
                return data[camel]
            if snake in data:
                return data[snake]
            return default

        d = cls()
        return cls(
            enabled=bool(k("enabled", "enabled", d.enabled)),
            sample_rate=float(k("sampleRate", "sample_rate", d.sample_rate)),
            window_s=float(k("windowS", "window_s", d.window_s)),
            max_windows=int(k("maxWindows", "max_windows", d.max_windows)),
            max_tracked_blocks=int(
                k("maxTrackedBlocks", "max_tracked_blocks",
                  d.max_tracked_blocks)),
        )


# Geometric distance buckets: ~2^(1/4) ratio. Bucket i holds scaled
# distances in (UPPER[i-1], UPPER[i]]; hit_ratio(C) sums buckets with
# upper bound <= C, so the MRC capacity resolution is the bucket ratio
# (a ≤19% capacity quantization, conservative direction).
_BUCKET_UPPERS: List[int] = []
_v = 1
while _v < 1 << 40:
    _BUCKET_UPPERS.append(_v)
    nxt = max(_v + 1, int(_v * 1.189207115002721))
    _v = nxt


def distance_bucket(scaled_distance: float) -> int:
    """Upper bound of the geometric bucket holding ``scaled_distance``."""
    lo, hi = 0, len(_BUCKET_UPPERS) - 1
    if scaled_distance <= 1:
        return 1
    while lo < hi:
        mid = (lo + hi) // 2
        if _BUCKET_UPPERS[mid] >= scaled_distance:
            hi = mid
        else:
            lo = mid + 1
    return _BUCKET_UPPERS[lo]


class _Fenwick:
    """Fenwick/BIT over logical access timestamps (1-based)."""

    __slots__ = ("n", "tree")

    def __init__(self, n: int):
        self.n = n
        self.tree = [0] * (n + 1)

    def add(self, i: int, delta: int) -> None:
        i += 1
        while i <= self.n:
            self.tree[i] += delta
            i += i & (-i)

    def prefix(self, i: int) -> int:
        """Sum of [0, i]."""
        i += 1
        s = 0
        while i > 0:
            s += self.tree[i]
            i -= i & (-i)
        return s


class _ScopeState:
    """Exact LRU stack distances among sampled keys for one scope.

    ``last`` is an OrderedDict key -> logical timestamp in recency order
    (oldest first); a Fenwick tree marks each tracked key's most recent
    timestamp so the distinct-keys-since-last-access count is two prefix
    sums. Timestamps are renumbered in-place when the logical clock
    reaches the tree size (amortized O(log n) per sampled access).
    """

    __slots__ = ("last", "bit", "clock", "cap", "tree_size",
                 "accesses", "sampled", "cold", "hits", "hist",
                 "capacity_blocks")

    def __init__(self, cap: int):
        self.cap = max(16, cap)
        self.tree_size = 8 * self.cap
        self.last: OrderedDict = OrderedDict()
        self.bit = _Fenwick(self.tree_size)
        self.clock = 0
        # Window-delta counters (reset at seal).
        self.accesses = 0
        self.sampled = 0
        self.cold = 0
        self.hits = 0
        self.hist: Dict[int, int] = {}
        self.capacity_blocks = 0

    def _renumber(self) -> None:
        self.bit = _Fenwick(self.tree_size)
        for i, key in enumerate(self.last):
            self.last[key] = i
            self.bit.add(i, 1)
        self.clock = len(self.last)

    def touch(self, key) -> Optional[int]:
        """Record a sampled access; returns the raw (unscaled) stack
        distance among sampled keys, or None for a cold first touch."""
        if self.clock >= self.tree_size:
            self._renumber()
        prev = self.last.get(key)
        t = self.clock
        self.clock += 1
        if prev is None:
            distance = None
            if len(self.last) >= self.cap:
                _, old_ts = self.last.popitem(last=False)
                self.bit.add(old_ts, -1)
        else:
            # Distinct sampled keys touched strictly after prev: each
            # tracked key's latest access is a marked timestamp.
            distance = self.bit.prefix(t - 1) - self.bit.prefix(prev)
            self.bit.add(prev, -1)
            self.last.move_to_end(key)
        self.last[key] = t
        self.bit.add(t, 1)
        return distance


class WorkingSetTracker:
    """The per-process working-set sampler + windowed exporter."""

    def __init__(
        self,
        config: Optional[WorkingSetConfig] = None,
        clock=time.monotonic,
    ):
        self.cfg = config or WorkingSetConfig(enabled=True)
        rate = min(max(self.cfg.sample_rate, 1e-6), 1.0)
        self.sample_rate = rate
        self._threshold = int(rate * (1 << 64))
        self._clock = clock
        self._lock = new_lock()
        self._scopes: Dict[str, _ScopeState] = {}
        # Spatial-filter memo: key -> bool(sampled). Steady-state cost of
        # an unsampled access is this one dict hit; cleared (cheaply
        # recomputed) when it outgrows the tracked-key budget.
        self._filter: Dict[object, bool] = {}
        self._filter_cap = 8 * max(16, self.cfg.max_tracked_blocks)
        # Written-never-read ledger over sampled offloaded keys
        # (cumulative; snapshot per window).
        self._offload_written: Dict[object, bool] = {}  # key -> read yet?
        self._offload_read_count = 0
        # Duplication estimator over sampled index keys: key -> pod count
        # seen in the latest lookup that resolved it.
        self._dup: OrderedDict = OrderedDict()
        # Eviction-age histogram (seconds, window delta).
        self._evict_hist: Dict[float, int] = {}
        self._window_started = clock()
        self._window_overhead_s = 0.0
        self._windows: deque = deque(maxlen=max(1, self.cfg.max_windows))
        self._next_seq = 0
        self.dropped = 0
        self.sampled_total = 0
        self.overhead_s_total = 0.0
        # Deferred-processing queue: the recording hooks ride latency-
        # critical paths (one per score call), so they only append the
        # batch here — one C-level deque op — and the per-key work
        # (filter, stack distance, histograms) runs in :meth:`_drain`,
        # amortized over every ``_drain_every``-th call and forced on
        # rotate/export. deque.append is GIL-atomic, so the enqueue
        # needs no lock.
        self._pending: deque = deque()
        self._drain_every = 128

    # -- spatial filter ----------------------------------------------------

    def _is_sampled(self, key) -> bool:
        f = self._filter
        v = f.get(key)
        if v is None:
            v = key64(key) < self._threshold
            if len(f) >= self._filter_cap:
                f.clear()
            f[key] = v
        return v

    def _scope(self, scope: str) -> _ScopeState:
        st = self._scopes.get(scope)
        if st is None:
            st = self._scopes[scope] = _ScopeState(self.cfg.max_tracked_blocks)
        return st

    # -- recording hooks ---------------------------------------------------

    def record_accesses(self, scope: str, keys: Sequence, hits: int = 0) -> None:
        """Record one access per key against ``scope``'s reuse stream.

        ``hits`` is how many of these accesses actually hit in the real
        cache behind this scope (measured, not modeled) — reported next
        to the MRC so operators can sanity-check the model.

        Hot-path contract: this is one deque append plus a length check.
        The per-key work happens in :meth:`_drain`, which runs inline on
        every ``_drain_every``-th call (off the p50; the self-reported
        overhead metric bills the full drain cost) and on every
        rotate/export. Callers must not mutate ``keys`` afterwards.
        """
        q = self._pending
        if len(q) >= self._drain_every:
            self._drain()
        q.append((scope, keys, hits, None))

    def record_index_lookup(
        self,
        keys: Sequence,
        key_to_pods: Optional[dict],
        hits: int = 0,
    ) -> None:
        """Index-lookup hook (scoring hot path): feeds the global "index"
        reuse stream and, when the per-key pod map is available (Python
        scoring path), the cross-pod duplication estimator. Same
        single-append hot-path contract as :meth:`record_accesses`."""
        q = self._pending
        if len(q) >= self._drain_every:
            self._drain()
        q.append((SCOPE_INDEX, keys, hits, key_to_pods or None))

    def _drain(self) -> None:
        """Process every queued access batch (filter → stack distance →
        histograms → dup ledger). Amortized onto one in every
        ``_drain_every`` recording calls, and forced before any seal or
        export so readers always see a fully-applied stream."""
        q = self._pending
        if not q:
            return
        t0 = time.perf_counter()
        threshold = self._threshold
        filter_cap = self._filter_cap
        f = self._filter
        drained_sampled = 0
        with self._lock:
            inv = 1.0 / self.sample_rate
            dup = self._dup
            dup_cap = self.cfg.max_tracked_blocks
            while True:
                try:
                    scope, keys, hits, key_to_pods = q.popleft()
                except IndexError:
                    break
                st = self._scope(scope)
                st.accesses += len(keys)
                st.hits += hits
                sampled = []
                for k in keys:
                    v = f.get(k)
                    if v is None:
                        v = key64(k) < threshold
                        if len(f) >= filter_cap:
                            f.clear()
                        f[k] = v
                    if v:
                        sampled.append(k)
                if sampled:
                    st.sampled += len(sampled)
                    drained_sampled += len(sampled)
                    touch = st.touch
                    hist = st.hist
                    for k in sampled:
                        d = touch(k)
                        if d is None:
                            st.cold += 1
                        else:
                            b = distance_bucket((d + 1) * inv)
                            hist[b] = hist.get(b, 0) + 1
                if key_to_pods:
                    for k, pods in key_to_pods.items():
                        v = f.get(k)
                        if v is None:
                            v = key64(k) < threshold
                            f[k] = v
                        if not v:
                            continue
                        if k in dup:
                            dup.move_to_end(k)
                        elif len(dup) >= dup_cap:
                            dup.popitem(last=False)
                        dup[k] = len(pods)
            self.sampled_total += drained_sampled
            elapsed = time.perf_counter() - t0
            self._window_overhead_s += elapsed
            self.overhead_s_total += elapsed
        if drained_sampled:
            m = _metrics()
            if m is not None:
                m[0].inc(drained_sampled)
                m[1].inc(elapsed)
                m[2].set(sum(len(s.last) for s in self._scopes.values()))

    def record_offload_write(self, keys: Sequence) -> None:
        """Offload-store admission hook: sampled keys enter the
        written-never-read ledger as unread."""
        t0 = time.perf_counter()
        is_sampled = self._is_sampled
        sampled = [k for k in keys if is_sampled(k)]
        if not sampled:
            return
        with self._lock:
            written = self._offload_written
            cap = self.cfg.max_tracked_blocks
            for k in sampled:
                if k not in written and len(written) >= cap:
                    evicted_read = written.pop(next(iter(written)))
                    if evicted_read:
                        self._offload_read_count -= 1
                if not written.get(k, False):
                    written[k] = False
            elapsed = time.perf_counter() - t0
            self._window_overhead_s += elapsed
            self.overhead_s_total += elapsed

    def record_offload_read(self, keys: Sequence, hits: int = 0) -> None:
        """Offload-restore hook: storage-tier reuse stream + marks the
        hit prefix as read in the never-read ledger."""
        self.record_accesses(SCOPE_STORAGE, keys, hits=hits)
        t0 = time.perf_counter()
        is_sampled = self._is_sampled
        sampled = [k for k in keys[:hits] if is_sampled(k)]
        if not sampled:
            return
        with self._lock:
            written = self._offload_written
            for k in sampled:
                if k in written and not written[k]:
                    written[k] = True
                    self._offload_read_count += 1
            elapsed = time.perf_counter() - t0
            self._window_overhead_s += elapsed
            self.overhead_s_total += elapsed

    def record_eviction_age(self, age_s: float) -> None:
        """BlockManager eviction hook: time from last use to eviction."""
        with self._lock:
            b = float(distance_bucket(max(age_s, 0.0) * 16.0)) / 16.0
            self._evict_hist[b] = self._evict_hist.get(b, 0) + 1

    def set_capacity(self, scope: str, blocks: int) -> None:
        """Declare the real capacity (in blocks) behind a scope; the
        what-if table is evaluated at multiples of it."""
        with self._lock:
            self._scope(scope).capacity_blocks = int(blocks)

    # -- windowing / export ------------------------------------------------

    def _seal_locked(self, now: float) -> None:
        wall = max(now - self._window_started, 1e-9)
        written = len(self._offload_written)
        read = self._offload_read_count
        multi = sum(1 for c in self._dup.values() if c >= 2)
        tracked = len(self._dup)
        window = {
            "seq": self._next_seq,
            "process": process_identity() or "",
            "start_unix": time.time() - wall,
            "duration_s": round(wall, 3),
            "sample_rate": self.sample_rate,
            "scopes": {
                scope: {
                    "accesses": st.accesses,
                    "sampled": st.sampled,
                    "cold": st.cold,
                    "hits": st.hits,
                    "capacity_blocks": st.capacity_blocks,
                    "tracked": len(st.last),
                    "hist": {str(b): c for b, c in sorted(st.hist.items())},
                }
                for scope, st in self._scopes.items()
            },
            "never_read": {
                "written": written,
                "read": read,
                "fraction": round((written - read) / written, 4)
                if written else 0.0,
            },
            "duplication": {
                "tracked": tracked,
                "multi_pod": multi,
                "share": round(multi / tracked, 4) if tracked else 0.0,
            },
            "eviction_age": {
                str(b): c for b, c in sorted(self._evict_hist.items())
            },
            "overhead_s": round(self._window_overhead_s, 6),
            "overhead_frac": round(self._window_overhead_s / wall, 6),
        }
        self._next_seq += 1
        if len(self._windows) == self._windows.maxlen:
            self.dropped += 1
            m = _metrics()
            if m is not None:
                m[3].inc()
        self._windows.append(window)
        # Reuse state (last-access maps, never-read ledger, dup keys)
        # carries across windows — reuse has no window boundary; only the
        # delta counters reset.
        for st in self._scopes.values():
            st.accesses = st.sampled = st.cold = st.hits = 0
            st.hist = {}
        self._evict_hist = {}
        self._window_started = now
        self._window_overhead_s = 0.0

    def rotate(self, force: bool = False) -> None:
        """Seal the live window when due (or unconditionally with force).
        Empty windows seal too: cursor math stays uniform."""
        self._drain()
        with self._lock:
            now = self._clock()
            if force or now - self._window_started >= self.cfg.window_s:
                self._seal_locked(now)

    def export_since(self, since: int = -1) -> dict:
        """``/debug/workingset`` payload, mirroring ``/debug/spans`` and
        ``/debug/pyprof`` cursors: sealed windows with ``seq > since``
        (oldest first), the next cursor, and the drop count."""
        self.rotate()
        with self._lock:
            windows = [w for w in self._windows if w["seq"] > since]
            return {
                "windows": windows,
                "next_seq": self._next_seq - 1,
                "dropped": self.dropped,
                "sample_rate": self.sample_rate,
            }

    def debug_view(self) -> dict:
        self._drain()
        with self._lock:
            return {
                "sample_rate": self.sample_rate,
                "window_s": self.cfg.window_s,
                "windows_sealed": self._next_seq,
                "windows_buffered": len(self._windows),
                "windows_dropped": self.dropped,
                "sampled_total": self.sampled_total,
                "overhead_s_total": round(self.overhead_s_total, 6),
                "scopes": {
                    scope: {
                        "tracked": len(st.last),
                        "capacity_blocks": st.capacity_blocks,
                    }
                    for scope, st in self._scopes.items()
                },
            }


# -- process-global wiring (mirrors install_span_exporter) -------------------

_active_tracker: Optional[WorkingSetTracker] = None


def install_workingset_tracker(
    tracker: Optional[WorkingSetTracker] = None,
) -> WorkingSetTracker:
    """Install (or create) the process's working-set tracker."""
    global _active_tracker
    if tracker is None:
        tracker = WorkingSetTracker()
    _active_tracker = tracker
    return tracker


def active_workingset_tracker() -> Optional[WorkingSetTracker]:
    return _active_tracker


def uninstall_workingset_tracker() -> None:
    global _active_tracker
    _active_tracker = None


# -- fleet-merge helpers (collector + kvdiag side) ---------------------------


def estimate_hit_ratio(
    hist: Dict[str, int], cold: int, capacity_blocks: float
) -> float:
    """SHARDS MRC point estimate: fraction of sampled accesses whose
    scaled reuse distance fits in ``capacity_blocks`` (cold accesses
    miss at every capacity)."""
    total = cold + sum(hist.values())
    if total <= 0:
        return 0.0
    hits = sum(c for b, c in hist.items() if float(b) <= capacity_blocks)
    return hits / total


def merge_workingset_windows(windows: Iterable[dict]) -> dict:
    """Sample-weighted fleet merge of per-pod workingset windows.

    Histogram counts estimate ``count / rate`` real accesses, so windows
    from pods running different sample rates merge by weighting each
    window's counts with ``1/rate``; the merged hit-ratio estimates stay
    unbiased. Never-read and duplication ledgers merge the same way.
    Returns per-scope merged histograms plus fleet HBM capacity — the
    input to :func:`whatif_table`.
    """
    scopes: Dict[str, dict] = {}
    never = {"written": 0.0, "read": 0.0}
    dup = {"tracked": 0.0, "multi_pod": 0.0}
    evict: Dict[str, float] = {}
    capacity_by_proc: Dict[str, int] = {}
    processes = set()
    for w in windows:
        inv = 1.0 / max(w.get("sample_rate", 1.0), 1e-9)
        processes.add(w.get("process", ""))
        for scope, st in (w.get("scopes") or {}).items():
            agg = scopes.setdefault(scope, {
                "accesses": 0, "sampled": 0.0, "cold": 0.0, "hits": 0,
                "hist": {},
            })
            agg["accesses"] += st.get("accesses", 0)
            agg["sampled"] += st.get("sampled", 0) * inv
            agg["cold"] += st.get("cold", 0) * inv
            agg["hits"] += st.get("hits", 0)
            hist = agg["hist"]
            for b, c in (st.get("hist") or {}).items():
                hist[b] = hist.get(b, 0.0) + c * inv
            if scope == SCOPE_HBM and st.get("capacity_blocks"):
                capacity_by_proc[w.get("process", "")] = \
                    st["capacity_blocks"]
        nr = w.get("never_read") or {}
        never["written"] += nr.get("written", 0) * inv
        never["read"] += nr.get("read", 0) * inv
        d = w.get("duplication") or {}
        dup["tracked"] += d.get("tracked", 0) * inv
        dup["multi_pod"] += d.get("multi_pod", 0) * inv
        for b, c in (w.get("eviction_age") or {}).items():
            evict[b] = evict.get(b, 0.0) + c
    never["fraction"] = (
        round((never["written"] - never["read"]) / never["written"], 4)
        if never["written"] else 0.0)
    dup["share"] = (round(dup["multi_pod"] / dup["tracked"], 4)
                    if dup["tracked"] else 0.0)
    return {
        "processes": sorted(p for p in processes if p),
        "scopes": scopes,
        "never_read": never,
        "duplication": dup,
        "eviction_age": evict,
        "hbm_capacity_blocks": sum(capacity_by_proc.values()),
        "hbm_capacity_by_process": capacity_by_proc,
    }


def whatif_table(
    merged: dict,
    factors: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
    scope: str = SCOPE_HBM,
) -> List[dict]:
    """Evaluate the merged MRC at multiples of current capacity.

    Falls back to the "index" scope's reuse stream when the requested
    scope saw no traffic (an indexer-only fleet still has a global
    reuse curve worth printing).
    """
    st = (merged.get("scopes") or {}).get(scope)
    if not st or not (st.get("cold") or st.get("hist")):
        st = (merged.get("scopes") or {}).get(SCOPE_INDEX)
    capacity = merged.get("hbm_capacity_blocks") or 0
    rows = []
    for f in factors:
        cap = capacity * f
        ratio = (estimate_hit_ratio(st["hist"], st["cold"], cap)
                 if st and capacity else 0.0)
        rows.append({
            "factor": f,
            "capacity_blocks": int(cap),
            "est_hit_ratio": round(ratio, 4),
        })
    return rows
