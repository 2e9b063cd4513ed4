"""Runtime lockdep witness: opt-in deadlock detection for library locks.

Copy of ``llmd_kv_cache_tpu/utils/lockdep.py``.

The static pass (``hack/lint_concurrency.py``) proves properties about
the *source*; this module witnesses them at *runtime*. Every lock the
library constructs goes through :func:`new_lock` / :func:`new_rlock` /
:func:`new_condition`. With ``KVTPU_LOCKDEP=1`` (exported by
``make unit-test-race`` and ``make chaos``) those factories return
instrumented wrappers that, in the style of the Linux kernel's lockdep:

- record per-thread acquisition stacks (which locks this thread holds,
  and the Python stack at each acquire);
- key locks by *site* (``file:line`` of construction), so every
  ``Pool._lag_mu`` across all instances is one node — a B→A ordering
  seen in one test plus an A→B in another is still a reported cycle;
- maintain the observed lock-order graph and raise
  :class:`LockOrderViolation` on the first acquisition that closes a
  cycle — on the *potential* deadlock, not the once-in-a-thousand-runs
  interleaving that actually wedges;
- raise :class:`LockReentryViolation` when a thread re-acquires a
  non-reentrant lock it already holds (the self-deadlock class the
  static CONC-REENTRY rule targets);
- enforce a hold-time budget (``KVTPU_LOCKDEP_BUDGET_S``, default off):
  releasing a lock held longer than the budget raises
  :class:`LockHoldBudgetViolation`, catching slow critical sections that
  the CONC-BLOCKING rule's syntactic patterns miss.

Before raising, the witness dumps the offending acquisition stacks and
the order-graph edge through the flight recorder (``KIND_LOCKDEP``), so
a violation inside a worker thread still leaves a black-box capture even
if the raising thread's traceback is swallowed by a ``Thread.run``.

When ``KVTPU_LOCKDEP`` is unset the factories return plain
``threading`` primitives — zero wrapper frames, zero overhead, which is
why call sites use the factories unconditionally rather than branching
themselves.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Optional

__all__ = [
    "new_lock",
    "new_rlock",
    "new_condition",
    "LockdepError",
    "LockOrderViolation",
    "LockReentryViolation",
    "LockHoldBudgetViolation",
    "enabled",
    "set_enabled",
    "reset",
    "graph_snapshot",
]

_STACK_LIMIT = 12  # frames kept per acquisition record


class LockdepError(RuntimeError):
    """Base class for lockdep violations."""


class LockOrderViolation(LockdepError):
    """An acquisition closed a cycle in the observed lock-order graph."""


class LockReentryViolation(LockdepError):
    """A thread re-acquired a non-reentrant lock it already holds."""


class LockHoldBudgetViolation(LockdepError):
    """A lock was held longer than ``KVTPU_LOCKDEP_BUDGET_S``."""


def _env_enabled() -> bool:
    return os.environ.get("KVTPU_LOCKDEP") == "1"


def _env_budget() -> Optional[float]:
    raw = os.environ.get("KVTPU_LOCKDEP_BUDGET_S", "")
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0 else None


_enabled = _env_enabled()
_budget_s = _env_budget()


class _State:
    """Process-wide witness state: the order graph and per-thread stacks.

    One plain ``threading.Lock`` guards the graph; per-thread held
    stacks live in ``threading.local`` and need no locking. The guard is
    deliberately *not* a lockdep lock (the witness must not witness
    itself) and nothing blocking runs under it.
    """

    def __init__(self):
        self.mu = threading.Lock()
        # site -> set of sites observed acquired while `site` was held.
        self.order: dict[str, set[str]] = {}
        # (a, b) -> short description of where the a→b edge was observed.
        self.edge_sites: dict[tuple[str, str], str] = {}
        self.tls = threading.local()

    def held(self) -> list:
        stack = getattr(self.tls, "held", None)
        if stack is None:
            stack = self.tls.held = []
        return stack


_state = _State()


def enabled() -> bool:
    """Whether the witness is active (wrappers being handed out)."""
    return _enabled


def set_enabled(on: bool, budget_s: Optional[float] = None) -> None:
    """Test hook: flip the witness on/off without touching the env.

    Only affects locks created *after* the call — existing plain locks
    stay plain (the zero-overhead property is decided at construction).
    """
    global _enabled, _budget_s
    _enabled = bool(on)
    if budget_s is not None:
        _budget_s = budget_s if budget_s > 0 else None


def reset() -> None:
    """Clear the observed order graph (test isolation between cases)."""
    with _state.mu:
        _state.order.clear()
        _state.edge_sites.clear()


def graph_snapshot() -> dict[str, list[str]]:
    """Copy of the observed lock-order graph (site -> successor sites)."""
    with _state.mu:
        return {a: sorted(bs) for a, bs in _state.order.items()}


def _caller_site() -> str:
    # Frame 0=_caller_site, 1=factory, 2=construction site.
    frame = traceback.extract_stack(limit=3)[0]
    return f"{frame.filename}:{frame.lineno}"


def _fmt_stack(stack: traceback.StackSummary) -> str:
    return "".join(stack.format())


def _reaches(graph: dict[str, set[str]], src: str, dst: str) -> bool:
    """DFS reachability over the order graph (held under ``_state.mu``)."""
    seen = set()
    todo = [src]
    while todo:
        node = todo.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        todo.extend(graph.get(node, ()))
    return False


def _dump(kind: str, data: dict) -> None:
    """Black-box the violation through the flight recorder before raising."""
    try:
        from ..telemetry.flight_recorder import (  # noqa: PLC0415
            KIND_LOCKDEP,
            record,
        )

        record(KIND_LOCKDEP, dict(data, violation=kind))
    except Exception:  # lint: allow-swallow (best-effort black-box; the violation raise right after must not be masked)
        pass


class _Held:
    """One entry on a thread's held-lock stack."""

    __slots__ = ("lock", "stack", "t_acquired")

    def __init__(self, lock: "DepLock"):
        self.lock = lock
        self.stack = traceback.extract_stack(limit=_STACK_LIMIT)
        self.t_acquired = time.monotonic()


class DepLock:
    """Instrumented non-reentrant lock (lockdep-enabled ``Lock``)."""

    _reentrant = False

    def __init__(self, site: Optional[str] = None):
        self._lk = self._make_inner()
        self.site = site or _caller_site()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    # -- witness core -------------------------------------------------

    def _depth(self, held: list) -> int:
        return sum(1 for h in held if h.lock is self)

    def _before_acquire(self) -> None:
        held = _state.held()
        depth = self._depth(held)
        if depth and not self._reentrant:
            first = next(h for h in held if h.lock is self)
            msg = (
                f"non-reentrant lock {self.site} re-acquired by thread "
                f"{threading.current_thread().name} that already holds it\n"
                f"first acquisition:\n{_fmt_stack(first.stack)}"
            )
            _dump("reentry", {"site": self.site, "thread": threading.current_thread().name})
            raise LockReentryViolation(msg)
        if depth:
            return  # legal RLock re-entry adds no order edges
        for h in reversed(held):
            if h.lock.site == self.site:
                continue
            # Only the innermost held lock needs an edge: when *it* was
            # acquired the outer→inner edges were already recorded, so
            # reachability covers outer→self transitively.
            self._note_edge(h, held)
            break

    def _note_edge(self, prev: "_Held", held: list) -> None:
        a, b = prev.lock.site, self.site
        where = traceback.extract_stack(limit=_STACK_LIMIT)
        back = None
        # The dump + raise happen *after* _state.mu is released: _dump
        # walks back into the flight recorder, whose own guard must not
        # nest under the witness's internal mutex.
        with _state.mu:
            cycle = b in _state.order and _reaches(_state.order, b, a)
            if cycle:
                back = _state.edge_sites.get((b, a), "<earlier edge>")
            else:
                _state.order.setdefault(a, set()).add(b)
                caller = next(
                    (f for f in reversed(where) if f.filename != __file__),
                    where[-1],
                )
                _state.edge_sites.setdefault(
                    (a, b), f"{caller.filename}:{caller.lineno} in {caller.name}"
                )
        if cycle:
            _dump(
                "lock-order",
                {
                    "holding": a,
                    "acquiring": b,
                    "reverse_edge": back,
                    "held": [h.lock.site for h in held],
                },
            )
            raise LockOrderViolation(
                f"lock-order cycle: acquiring {b} while holding {a}, "
                f"but {b}→{a} was already observed at {back}\n"
                f"current acquisition:\n{_fmt_stack(where)}"
                f"holding {a} since:\n{_fmt_stack(prev.stack)}"
            )

    def _after_acquire(self) -> None:
        _state.held().append(_Held(self))

    def _after_release(self) -> None:
        held = _state.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                entry = held.pop(i)
                break
        else:  # pragma: no cover - release without acquire raises below us
            return
        if _budget_s is not None:
            held_for = time.monotonic() - entry.t_acquired
            if held_for > _budget_s:
                _dump(
                    "hold-budget",
                    {"site": self.site, "held_s": round(held_for, 4), "budget_s": _budget_s},
                )
                raise LockHoldBudgetViolation(
                    f"lock {self.site} held {held_for:.4f}s "
                    f"(budget {_budget_s}s)\nacquired at:\n{_fmt_stack(entry.stack)}"
                )

    # -- threading.Lock surface ---------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._before_acquire()
        got = self._lk.acquire(blocking, timeout)
        if got:
            self._after_acquire()
        return got

    def release(self) -> None:
        self._lk.release()
        self._after_release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} site={self.site}>"

    # -- Condition interop (mirrors threading.Lock's private surface) --

    def _is_owned(self) -> bool:
        return any(h.lock is self for h in _state.held())

    def _release_save(self):
        self.release()

    def _acquire_restore(self, _saved) -> None:
        self.acquire()


class DepRLock(DepLock):
    """Instrumented reentrant lock (lockdep-enabled ``RLock``)."""

    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()

    def _release_save(self):
        # Unwind the full recursion depth like threading.RLock does.
        count = self._depth(_state.held())
        for _ in range(count):
            self.release()
        return count

    def _acquire_restore(self, saved: int) -> None:
        for _ in range(saved):
            self.acquire()


def new_lock() -> "threading.Lock | DepLock":
    """A mutex for library state: plain ``Lock``, or witnessed when on."""
    if _enabled:
        return DepLock(site=_caller_site())
    return threading.Lock()


def new_rlock() -> "threading.RLock | DepRLock":
    """A reentrant mutex: plain ``RLock``, or witnessed when on."""
    if _enabled:
        return DepRLock(site=_caller_site())
    return threading.RLock()


def new_condition(lock=None) -> threading.Condition:
    """A condition variable over a lockdep-aware lock.

    ``threading.Condition`` drives its lock through ``acquire``/
    ``release``/``_is_owned``/``_release_save``/``_acquire_restore``,
    all of which :class:`DepLock` implements, so ``wait`` correctly
    drops the witnessed lock (popping it off the held stack) and
    re-acquires it (re-checking order) on wake.
    """
    if lock is None:
        lock = new_rlock()
    return threading.Condition(lock)
