"""Collective watchdogs: deadline + bounded retry around every
host-level collective.

The port of `lightgbm_tpu/parallel/collective.py`, with its API and
semantics.  The reference's socket collectives time out per link
(``Network`` config ``time_out``), so one dead machine fails the group
loudly; a collective that blocks forever would instead turn one lost
host into a silently hung group.  `guarded_collective` restores the
reference's semantics:

* **deadline** — the transport runs on a watchdog thread; if it has
  not returned after ``timeout_s`` a structured `CollectiveTimeout`
  raises on the caller.  The abandoned thread keeps blocking in the
  dead collective (it cannot be cancelled, only abandoned).
* **bounded retry** — a collective that RAISES is retried up to
  ``retries`` times with exponential backoff.  Timeouts and host-drops
  are never retried: after a deadline expiry the group's collective
  streams are no longer aligned.
* **fault injection** — every call fires its faultline point (default
  ``collective_sync``) plus ``host_drop``, so chaos runs can kill host
  k at call-index i deterministically (`faultline.arm(..., host=k,
  at=i, absolute=True)`).  An armed ``hang`` simulates an unresponsive
  peer through the real deadline machinery; an armed ``host_drop``
  raise becomes `HostDropped`.

In one process the host-level collectives are identities (`local=True`:
no watchdog thread, the fault points still fire).  Across processes they
ride `parallel/topology.py`'s gloo transport, whose group takes the same
deadline; a host that drops or times out records its failure in the
rendezvous store (`topology.note_failure`), so a peer whose transport
then breaks raises `HostDropped` instead of hanging.  The shard group of
`parallel/topology.py` takes its barrier timeout from the same process
defaults (`defaults()["timeout_s"]`).

Defaults are process-global (`configure`, the reference's
Network::Init analog), wired from `tpu_collective_timeout_s` /
`tpu_collective_retries` at learner init; ``timeout_s=0`` disables the
deadline while keeping injection and retry live.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from .. import obs
from ..utils import faultline
from ..utils.log import Log

# collective wait-time buckets: in-process syncs are sub-ms, barriers
# across hosts can legitimately take seconds
_WAIT_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                 1.0, 5.0, 15.0, 60.0)


def _note_wait(name: str, seconds: float) -> None:
    if obs.metrics_on():
        obs.REGISTRY.observe(
            "lgbm_collective_wait_seconds", seconds, buckets=_WAIT_BUCKETS,
            help="wall seconds blocked in host-level collectives",
            name=name)


class CollectiveTimeout(RuntimeError):
    """A host-level collective missed its watchdog deadline."""

    def __init__(self, name: str, timeout_s: float, attempts: int,
                 host: int):
        self.name = name
        self.timeout_s = float(timeout_s)
        self.attempts = int(attempts)
        self.host = int(host)
        super().__init__(
            f"collective {name!r} timed out after {timeout_s:g}s on host "
            f"{host} (attempt {attempts}); a peer likely diverged or died "
            "— rolling back to the last complete iteration")


class HostDropped(faultline.FaultInjected):
    """Injected death of this host at a collective call site."""


_DEFAULTS: Dict[str, float] = {"timeout_s": 0.0, "retries": 1,
                               "backoff_s": 0.25}
_defaults_lock = threading.Lock()


def configure(timeout_s: Optional[float] = None,
              retries: Optional[int] = None,
              backoff_s: Optional[float] = None) -> None:
    """Set the process-global watchdog defaults (Network::Init analog).
    Called at learner/dataset init from `tpu_collective_timeout_s` /
    `tpu_collective_retries`; explicit per-call arguments win."""
    with _defaults_lock:
        if timeout_s is not None:
            _DEFAULTS["timeout_s"] = max(float(timeout_s), 0.0)
        if retries is not None:
            _DEFAULTS["retries"] = max(int(retries), 0)
        if backoff_s is not None:
            _DEFAULTS["backoff_s"] = max(float(backoff_s), 0.0)


def defaults() -> Dict[str, float]:
    with _defaults_lock:
        return dict(_DEFAULTS)


def configure_from_config(config) -> None:
    """Apply `tpu_collective_timeout_s`/`tpu_collective_retries` from a
    Config.  The registry default -1 means UNSET — a booster
    constructed without these params never disturbs the process policy
    another live booster armed — while an explicit 0 really disables
    (deadline off / no retries).  The single owner of that convention;
    both wiring sites (GBDT init, distributed-dataset init) route
    through here."""
    t = float(config.tpu_collective_timeout_s)
    r = int(config.tpu_collective_retries)
    configure(timeout_s=t if t >= 0 else None,
              retries=r if r >= 0 else None)


def _run_with_deadline(fn: Callable, args, kwargs, name: str,
                       timeout_s: float, attempt: int) -> Any:
    """Run `fn` on a watchdog thread; raise CollectiveTimeout when it
    misses the deadline.  The thread is a daemon: a genuinely hung
    collective cannot be cancelled, only abandoned."""
    box: list = []

    def _target():
        try:
            box.append(("ok", fn(*args, **kwargs)))
        except BaseException as exc:  # noqa: BLE001 - re-raised on caller
            box.append(("err", exc))

    t = threading.Thread(target=_target, daemon=True,
                         name=f"collective-{name}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise CollectiveTimeout(name, timeout_s, attempt,
                                faultline.host_index())
    kind, val = box[0]
    if kind == "err":
        raise val
    return val


def guarded_collective(fn: Callable, *args,
                       name: str = "collective",
                       point: Optional[str] = "collective_sync",
                       timeout_s: Optional[float] = None,
                       retries: Optional[int] = None,
                       backoff_s: Optional[float] = None,
                       local: bool = False,
                       **kwargs) -> Any:
    """Run one host-level collective under the watchdog.

    `local=True` marks a call that degenerated to an in-process
    identity (world size 1): the deadline thread is skipped — an
    identity cannot hang — but injection (hang -> simulated
    CollectiveTimeout, host_drop -> HostDropped) and retry stay live so
    single-process chaos runs exercise the same failure surface.
    `timeout_s`/`retries`/`backoff_s` default to the `configure`d
    process globals; timeout_s=0 disables the deadline."""
    cfg = defaults()
    timeout_s = cfg["timeout_s"] if timeout_s is None else float(timeout_s)
    retries = int(cfg["retries"] if retries is None else retries)
    backoff_s = float(cfg["backoff_s"] if backoff_s is None else backoff_s)
    me = faultline.host_index()
    attempt = 0
    while True:
        attempt += 1
        # flight recorder (always-on): the begin entry is what names
        # the hung site in a blackbox dump — a collective that never
        # returns leaves a span_begin with no span_end
        obs.flightrecorder.note("span_begin", f"collective/{name}",
                                attempt=attempt, host=me)
        try:
            try:
                drop = faultline.fire("host_drop", name=name, host=me)
            except (HostDropped, KeyboardInterrupt, SystemExit):
                raise
            except BaseException as exc:
                # normalize ANY armed host_drop exception — including a
                # custom exc= like ConnectionError — to the structured
                # type: a dropped host is never a transient failure, so
                # it must bypass the retry loop below
                raise HostDropped(str(exc)) from None
            if drop is not None:
                raise HostDropped(
                    f"injected host drop at collective {name!r} "
                    f"(host {me})")
            action = None
            if point is not None:
                action = faultline.fire(point, name=name, host=me)
            if action == "hang":
                if local or timeout_s <= 0:
                    # nothing real can hang (identity call) or no
                    # deadline is armed: simulate the expiry directly —
                    # a real hang with timeout_s=0 would block forever,
                    # which is exactly what the watchdog param exists
                    # to prevent
                    raise CollectiveTimeout(name, timeout_s, attempt, me)
                # exercise the REAL deadline machinery: a sleeper that
                # outlives the deadline stands in for the hung peer
                slack = timeout_s + 1.0
                return _run_with_deadline(
                    lambda: time.sleep(slack), (), {}, name, timeout_s,
                    attempt)
            t_wait = time.perf_counter()
            with obs.span(f"collective/{name}", attempt=attempt):
                if local or timeout_s <= 0:
                    result = fn(*args, **kwargs)
                else:
                    result = _run_with_deadline(fn, args, kwargs, name,
                                                timeout_s, attempt)
            _note_wait(name, time.perf_counter() - t_wait)
            obs.flightrecorder.note("span_end", f"collective/{name}",
                                    attempt=attempt, host=me)
            if attempt > 1:
                # a retried collective that finally succeeded is a
                # recovery: counted, and recorded as an event
                obs.REGISTRY.inc("lgbm_collective_recoveries_total",
                                 name=name)
                obs.event("collective_recovered", name=name,
                          attempts=attempt)
            return result
        except (CollectiveTimeout, HostDropped, KeyboardInterrupt,
                SystemExit) as exc:
            if isinstance(exc, (CollectiveTimeout, HostDropped)):
                from .topology import note_failure

                note_failure(exc)
            if isinstance(exc, CollectiveTimeout):
                obs.REGISTRY.inc(
                    "lgbm_collective_timeouts_total",
                    help="watchdog deadline expiries", name=name)
                obs.event("collective_timeout", name=name,
                          timeout_s=timeout_s, attempt=attempt)
                # the evidence of WHAT hung must outlive the process:
                # ring the transition and flush the blackbox before the
                # structured error starts unwinding the train loop
                obs.flightrecorder.note("watchdog", "collective_timeout",
                                        name=name, timeout_s=timeout_s,
                                        attempt=attempt, host=me)
                obs.flightrecorder.dump("collective_timeout", exc=exc)
            elif isinstance(exc, HostDropped):
                obs.REGISTRY.inc("lgbm_collective_host_drops_total",
                                 name=name)
                obs.event("host_dropped", name=name, host=me)
                obs.flightrecorder.note("watchdog", "host_dropped",
                                        name=name, host=me)
                obs.flightrecorder.dump("host_dropped", exc=exc)
            raise
        except Exception as exc:  # noqa: BLE001 - transient transport error
            obs.flightrecorder.note("watchdog", "collective_error",
                                    name=name, attempt=attempt,
                                    error=type(exc).__name__)
            if attempt > retries:
                raise
            obs.REGISTRY.inc("lgbm_collective_retries_total",
                             help="transient collective errors retried",
                             name=name)
            wait = backoff_s * (2 ** (attempt - 1))
            Log.warning(
                f"collective {name!r} failed on host {me} "
                f"({type(exc).__name__}: {exc}); retry {attempt}/{retries} "
                f"in {wait:g}s")
            if wait > 0:
                time.sleep(wait)
