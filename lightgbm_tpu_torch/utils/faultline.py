"""Fault-injection harness: named points the runtime fires on its hot
paths and tests can arm.

The production code calls `fire("<point>")` at each instrumented site;
unarmed points take NO lock — one GIL-atomic dict increment — so the
hot serving/predict paths never serialize on the harness.  Arming a
point
makes the matching `fire` either raise (simulating a device/runtime
error at exactly that site) or return an action string the site knows
how to apply:

* ``raise``    — raise the armed exception (default `FaultInjected`);
  the site's normal error handling (iteration rollback, serving
  fallback, checkpoint-write recovery) must contain it.
* ``poison``   — the site corrupts its own output (the `grow_step`
  point NaN-poisons the iteration's scores) so the numeric guardrails
  (`tpu_guard_numerics`) can be exercised deterministically.
* ``truncate`` — the site writes only half its payload (the
  `checkpoint_write` point produces a torn file whose manifest CRC
  cannot match) so recovery-from-corruption paths are testable.
* ``hang``     — the site simulates an unresponsive peer: the
  collective watchdog (`parallel/collective.py`) turns it into a
  deterministic `CollectiveTimeout`.
* ``oom``      — raises a realistic device out-of-memory error:
  torch's own `torch.OutOfMemoryError` with the message of CUDA's
  caching allocator (the class exists in torch's CPU build too), so the
  `utils/membudget.py` OOM classifier and recovery ladder are
  exercised through exactly the path a real exhaustion takes.
  The ``device_alloc`` point fires inside `membudget.oom_guard` at
  every guarded device site (train step, ingest chunk, chunked
  predict, score replay).

Points are process-global and thread-safe; `reset()` disarms
everything.  Hit counters count every `fire` since the last reset, so
"arm at the k-th hit" addresses a specific iteration/request without
the site threading indices through.

Distributed addressing: multihost chaos runs must be
reproducible, so a spec can pin BOTH coordinates of a distributed
event:

* ``host=k``        — the spec only matches on the process whose
  `host_index()` is k (every other host counts the hit but never
  fires).  `host_index()` resolves, in order: an explicit
  `set_host_index()` override (single-process chaos sweeps simulating
  a fleet), the LIGHTGBM_TPU_FAULT_HOST env var, the
  `torch.distributed` rank when a process group is initialized, else 0.
* ``absolute=True`` — `at` addresses the N-th hit since the last
  `reset()` (an absolute per-process call index) instead of the N-th
  hit after `arm()`.  Since every host runs the same program, the
  (host, call-index) pair names one collective call in the whole
  group's execution, independent of when the harness armed it.

The port's own copy of `lightgbm_tpu/utils/faultline.py`: the same
points, actions and API.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Dict, List, Optional

POINTS = ("grow_step", "h2d_copy", "checkpoint_write", "serve_dispatch",
          "collective_sync", "binning_allgather", "host_drop",
          "device_alloc",
          # continual-learning stage boundaries: buffer
          # ingest, retrain launch, shadow candidate load, alias swap
          "continual_ingest", "continual_retrain",
          "continual_shadow_load", "continual_promote")

_ACTIONS = ("raise", "poison", "truncate", "hang", "oom")


class FaultInjected(RuntimeError):
    """The default exception an armed ``raise`` point throws."""


def resource_exhausted_error(point: str, **info) -> BaseException:
    """A realistic device out-of-memory error — what the ``oom`` action
    raises: `torch.OutOfMemoryError` with the message shape of CUDA's
    caching allocator, so `membudget.is_oom_error` classifies the
    injected error through EXACTLY the path a real exhaustion on the
    card takes."""
    import torch

    detail = ", ".join(f"{k}={v}" for k, v in info.items())
    msg = ("CUDA out of memory. Tried to allocate 2.00 GiB (injected by "
           f"faultline {point!r}{': ' + detail if detail else ''})")
    return torch.OutOfMemoryError(msg)


class _Spec:
    __slots__ = ("action", "exc", "at", "times", "host", "end", "where")

    def __init__(self, action: str, exc, at: int, times: int,
                 host: Optional[int] = None, end: Optional[int] = None,
                 where: Optional[Dict] = None):
        self.action = action
        self.exc = exc
        self.at = int(at)
        self.times = int(times)
        self.host = None if host is None else int(host)
        # exclusive upper hit bound (absolute specs only): the spec
        # fires on hits [at, end) or NEVER — an absolute coordinate
        # armed after its call has passed must not drift onto a later
        # call, or the (host, call-index) pair stops naming one event
        self.end = None if end is None else int(end)
        # field filter: the spec only matches fires whose `info` kwargs
        # carry every (key, value) pair — how a fleet chaos run kills
        # ONE device's dispatches (`where={"device": 3}`) while its
        # siblings keep serving
        self.where = dict(where) if where else None


_lock = threading.Lock()
_armed: Dict[str, List[_Spec]] = {}
_hits: Dict[str, int] = {}
_host_override: Optional[int] = None


def _check_point(point: str) -> None:
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r}; known: {POINTS}")


def set_host_index(host: Optional[int]) -> None:
    """Override this process's host identity for `host=`-addressed specs
    (single-process chaos sweeps simulate a fleet by iterating it)."""
    global _host_override
    _host_override = None if host is None else int(host)


def host_index() -> int:
    """This process's position in the host group, for `host=` matching.
    set_host_index() override > LIGHTGBM_TPU_FAULT_HOST env > the
    `torch.distributed` rank (only when a process group is already
    initialized) > 0."""
    if _host_override is not None:
        return _host_override
    env = os.environ.get("LIGHTGBM_TPU_FAULT_HOST", "")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        try:
            dist = torch_mod.distributed
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:  # pragma: no cover - group torn down
            return 0
    return 0


def arm(point: str, action: str = "raise", exc=None, at: int = 1,
        times: int = 1, host: Optional[int] = None,
        absolute: bool = False, where: Optional[Dict] = None) -> None:
    """Arm `point`: starting at its `at`-th hit from now, apply `action`
    for the next `times` hits.  With `absolute=True` the window is
    EXACT: hits `[at, at + times)` counted since the last `reset()` —
    a coordinate that already passed never fires (it must not drift
    onto a later call, or the (host, call-index) pair stops naming one
    event).  `host=k` restricts the spec to the process whose
    `host_index()` is k, so a multihost chaos run can kill host k at
    call-index i reproducibly.  `where={"device": 3}` restricts it to
    fires whose info kwargs match every pair — single-device chaos in a
    replicated serving fleet.  `exc` (an exception instance or class)
    overrides the default `FaultInjected` for ``raise`` actions."""
    _check_point(point)
    if action not in _ACTIONS:
        raise ValueError(f"unknown fault action {action!r}; known: {_ACTIONS}")
    if exc is None:
        exc = FaultInjected(f"injected fault at {point!r}")
    with _lock:
        base = 0 if absolute else _hits.get(point, 0)
        start = base + max(int(at), 1)
        times = max(int(times), 1)
        _armed.setdefault(point, []).append(
            _Spec(action, exc, start, times, host=host,
                  end=start + times if absolute else None, where=where))


def disarm(point: Optional[str] = None) -> None:
    with _lock:
        if point is None:
            _armed.clear()
        else:
            _armed.pop(point, None)


def reset() -> None:
    """Disarm everything, zero the hit counters, and clear any host
    override — the absolute (host, call-index) coordinate origin."""
    global _host_override
    with _lock:
        _armed.clear()
        _hits.clear()
        _host_override = None


def hits(point: str) -> int:
    _check_point(point)
    with _lock:
        return _hits.get(point, 0)


def fire(point: str, **info) -> Optional[str]:
    """One hit on `point`.  Raises when an armed ``raise`` spec matches;
    otherwise returns the matched action string ("poison"/"truncate")
    or None.  `info` kwargs are attached to raised FaultInjected
    exceptions for diagnostics.

    Unarmed fast path: no lock.  The counter update is a single dict
    store (GIL-atomic in CPython); exact hit accounting under heavy
    cross-thread contention only matters while a point is armed, and
    armed points take the locked path."""
    if point not in _armed:
        _hits[point] = _hits.get(point, 0) + 1
        return None
    with _lock:
        hit = _hits.get(point, 0) + 1
        _hits[point] = hit
        specs = _armed.get(point)
        if not specs:
            return None
        me = host_index()
        matched = None
        for spec in specs:
            if spec.host is not None and spec.host != me:
                continue  # addressed to another host: count, never fire
            if spec.where is not None and any(
                    info.get(k) != v for k, v in spec.where.items()):
                continue  # addressed to another device/entity: skip
            if spec.times > 0 and hit >= spec.at \
                    and (spec.end is None or hit < spec.end):
                spec.times -= 1
                matched = spec
                break
        if matched is not None and not any(
                s.times > 0 and (s.end is None or hit < s.end)
                for s in specs):
            del _armed[point]
    if matched is None:
        return None
    # a FIRED fault is rare and always worth counting; lazy import keeps
    # the harness importable before the package (and cycle-free)
    from ..obs import flightrecorder
    from ..obs.metrics import REGISTRY

    REGISTRY.inc("lgbm_fault_injections_total",
                 help="armed faultline specs that actually fired",
                 point=point, action=matched.action)
    # the blackbox of a chaos run must show the injection that killed it
    flightrecorder.note("fault", point, action=matched.action, **info)
    if matched.action == "raise":
        exc = matched.exc
        if isinstance(exc, type):
            exc = exc(f"injected fault at {point!r}")
        if isinstance(exc, FaultInjected) and info:
            exc.args = (f"{exc.args[0] if exc.args else point} "
                        f"({', '.join(f'{k}={v}' for k, v in info.items())})",)
        raise exc
    if matched.action == "oom":
        # a realistic allocator error so the membudget classifier —
        # not a test-only code path — turns it into DeviceOutOfMemory
        raise resource_exhausted_error(point, **info)
    return matched.action


@contextlib.contextmanager
def armed(point: str, action: str = "raise", exc=None, at: int = 1,
          times: int = 1):
    """Context-managed arm/disarm of one point."""
    arm(point, action=action, exc=exc, at=at, times=times)
    try:
        yield
    finally:
        disarm(point)
