"""Instrumented-lock runtime checker: lock-order inversions,
hold-while-dispatching, and mutation-without-lock, caught under tests.

The graftlint concurrency rules (tools/graftlint) prove statically that
declared shared state is only mutated under its owning lock — but a
static lock-ownership map cannot see dynamic acquisition ORDER (the
deadlock ingredient) or a lock accidentally held across a device
dispatch (the serving latency ingredient: one wedged jit call would
stall every thread queued on that lock).  This module is the runtime
half of the same contract:

* **order graph** — every enabled acquire records the edge
  ``held-lock -> acquiring-lock`` into a process-global directed graph;
  an acquire whose reverse edge is already present is a lock-order
  inversion (two threads interleaving those call sites can deadlock)
  and records a violation naming both sites.
* **hold-while-dispatching** — dispatch sites (the serving batcher's
  runner call, ``ModelEntry.predict``'s device launch) call
  `check_dispatch(site)`; if the calling thread holds ANY instrumented
  lock at that moment, a violation records which one.  Device walls are
  unbounded from the host's point of view — nothing may be held across
  them.
* **mutation ownership** — `check_owned(lock)` asserts the calling
  thread currently holds `lock`; sprinkled next to guarded-state
  mutations (or used by tests hammering a structure) it catches the
  mutation-without-lock bug class the static map enforces by
  declaration.

Overhead discipline: the checker ships DISABLED.  A disabled
`InstrumentedLock.acquire` is one module-global flag load and a
delegated ``threading.Lock.acquire`` — the serving/obs hot paths that
create their locks through `make_lock` stay inside the telemetry
off-mode <1% gate (tests/test_telemetry.py extends its microbench with
a disabled lockcheck acquire/release to pin this).  `enable()` is for
tests and debugging sessions, never production serving.

Violations are RECORDED, not raised (default): a checker that throws
from inside ``acquire`` would turn a diagnosed bug into an undiagnosed
crash in whatever thread happened to trip it.  Tests read
`violations()`; `enable(strict=True)` opts into raising
`LockCheckError` at the detection site for pinpoint stack traces.

The port's own copy of `lightgbm_tpu/utils/lockcheck.py`, which the
port's metrics registry and flight recorder make their locks with.
"""

from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "InstrumentedLock", "LockCheckError", "check_dispatch", "check_owned",
    "enable", "enabled", "held_names", "make_lock", "make_rlock",
    "reset", "violations",
]


class LockCheckError(RuntimeError):
    """Raised at the detection site under enable(strict=True)."""


_enabled = False
_strict = False
_tls = threading.local()          # .held: List[InstrumentedLock]
_graph_lock = threading.Lock()    # guards _edges and _violations
# (id(before), id(after)) -> first site.  INSTANCE-keyed, not
# name-keyed: two ServingSessions share lock NAMES ("serving.stats"),
# and a name-keyed graph would both miss real A/B-vs-B/A inversions
# between the sessions' distinct locks and conflate orders across
# instances that can never deadlock.  (ids are only meaningful while
# the locks are alive — fine for a test-scoped checker; reset()
# between tests clears the graph.)
_edges: Dict[Tuple[int, int], str] = {}
_edge_refs: List = []             # keeps edge locks alive: no id reuse
_violations: List[Dict] = []


def enable(on: bool = True, strict: bool = False) -> None:
    """Arm/disarm the checker process-wide (tests only — see module
    docstring for the overhead contract)."""
    global _enabled, _strict
    _enabled = bool(on)
    _strict = bool(strict)


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear the order graph and recorded violations (enabled state and
    existing locks persist)."""
    with _graph_lock:
        _edges.clear()
        del _edge_refs[:]
        del _violations[:]


def violations() -> List[Dict]:
    with _graph_lock:
        return list(_violations)


def _held() -> List["InstrumentedLock"]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def held_names() -> List[str]:
    """Names of instrumented locks the CALLING thread holds, in
    acquisition order."""
    return [lk.name for lk in _held()]


def _site() -> str:
    """Compact caller site (file:line of the frame outside this
    module) for violation records.  Basename EQUALITY, not endswith:
    'test_lockcheck.py'.endswith('lockcheck.py') is True, and skipping
    the checker's own test file would name a pytest frame instead of
    the violating line."""
    for frame in reversed(traceback.extract_stack(limit=8)[:-2]):
        base = frame.filename.rsplit("/", 1)[-1]
        if base != "lockcheck.py":
            return f"{base}:{frame.lineno}"
    return "?"


def _record(kind: str, detail: str) -> None:
    rec = {"kind": kind, "detail": detail, "site": _site(),
           "thread": threading.current_thread().name}
    with _graph_lock:
        _violations.append(rec)
    if _strict:
        raise LockCheckError(f"{kind}: {detail} at {rec['site']}")


class InstrumentedLock:
    """threading.Lock/RLock plus order-graph and ownership tracking.

    Transparent where it matters: ``with``-statement protocol,
    acquire/release signatures, and `locked()` all delegate.  NOT a
    drop-in for ``threading.Condition(lock)`` — Condition pokes at
    private lock internals; keep Condition-paired locks plain (the
    static graftlint map still covers their guarded state)."""

    __slots__ = ("_lock", "name", "_reentrant", "_owner", "_depth")

    def __init__(self, name: str, reentrant: bool = False):
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self.name = str(name)
        self._reentrant = bool(reentrant)
        self._owner: Optional[int] = None
        self._depth = 0

    # -- core protocol --------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            return self._lock.acquire(blocking, timeout)
        me = threading.get_ident()
        reacquire = self._reentrant and self._owner == me
        pending = []
        if not reacquire:
            # inversion DETECTION runs before blocking (strict mode must
            # fire before a real deadlock hangs us); edge RECORDING waits
            # for acquire success — a failed trylock (the deliberate
            # trylock-with-backoff deadlock-avoidance pattern) must not
            # poison the graph with an order that never held a lock
            for h in _held():
                if h is self:
                    continue
                rev = (id(self), id(h))
                with _graph_lock:
                    first = _edges.get(rev)
                if first is not None:
                    _record("lock-order-inversion",
                            f"acquiring {self.name!r} while holding "
                            f"{h.name!r}, but the opposite order was "
                            f"taken at {first}")
                else:
                    pending.append(h)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            if reacquire:
                self._depth += 1
            else:
                if pending:
                    site = _site()
                    with _graph_lock:
                        for h in pending:
                            edge = (id(h), id(self))
                            if edge not in _edges:
                                _edges[edge] = site
                                _edge_refs.append((h, self))
                self._owner = me
                self._depth = 1
                _held().append(self)
        return ok

    def release(self) -> None:
        # ownership cleanup runs whenever WE hold tracking state — even
        # if the checker was disabled mid-critical-section — or a stale
        # held entry would poison later check_dispatch/check_owned
        # calls on this thread.  The disabled steady state costs one
        # None check (owner is never set while disabled).
        if self._owner is not None and \
                self._owner == threading.get_ident():
            self._depth -= 1
            if self._depth <= 0:
                self._owner = None
                held = _held()
                if self in held:
                    held.remove(self)
        self._lock.release()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        try:
            return self._lock.locked()
        except AttributeError:  # RLock before 3.14 has no locked()
            return self._owner is not None

    # -- checker surface ------------------------------------------------
    def owned(self) -> bool:
        """Does the CALLING thread hold this lock?  Only meaningful
        while the checker is enabled (ownership is not tracked on the
        disabled fast path)."""
        return self._owner == threading.get_ident()


def make_lock(name: str) -> InstrumentedLock:
    """The lock constructor serving/obs use instead of a bare
    ``threading.Lock()``: instrumented, but one flag check from free
    while the checker is disabled (the default)."""
    return InstrumentedLock(name)


def make_rlock(name: str) -> InstrumentedLock:
    return InstrumentedLock(name, reentrant=True)


def check_owned(lock: InstrumentedLock, what: str = "") -> None:
    """Record a violation when the calling thread mutates guarded state
    without holding its owning lock.  No-op while disabled."""
    if not _enabled:
        return
    if not isinstance(lock, InstrumentedLock) or not lock.owned():
        name = getattr(lock, "name", "?")
        _record("mutation-without-lock",
                f"{what or 'guarded state'} mutated without holding "
                f"{name!r}")


def check_dispatch(site: str) -> None:
    """Record a violation when a device-dispatch site runs with ANY
    instrumented lock held (a wedged device wall would stall every
    thread queued on it).  No-op while disabled."""
    if not _enabled:
        return
    held = held_names()
    if held:
        _record("hold-while-dispatching",
                f"dispatch site {site!r} entered holding {held}")
