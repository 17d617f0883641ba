"""Always-on flight recorder: a bounded process-global ring of the last
N spans, instant events, watchdog/guard/breaker transitions and metric
snapshots, dumped atomically to ``blackbox-host<k>.json`` when the
process dies badly.

Watchdogs turn distributed hangs into structured errors, but the
evidence of *what the process was doing* died with it unless tracing
was pre-enabled.  The recorder closes that gap: it runs EVEN AT
``tpu_telemetry=off`` (so it must stay inside the <1% off-mode overhead
gate — one `note()` is a clock read + tuple + GIL-atomic deque append,
recorded only at coarse boundaries: per training round, per collective,
per state transition — never inside the per-row hot loops), and under
``tpu_telemetry=trace`` every buffered span/event mirrors in as well.

Dump triggers (all funnel through `dump(reason)`, atomic tmp+rename):

* unhandled exception — a `sys.excepthook` chain installed at import;
* `CollectiveTimeout` / `HostDropped` — `parallel.collective` dumps
  before re-raising, so the newest ring entries name the in-flight
  collective (the ``span_begin`` without a matching ``span_end``);
* SIGTERM / interrupt / XLA error mid-train — `engine.train`'s
  recovery path dumps AFTER the final checkpoint flush (the dump's
  metric snapshot then proves the checkpoint landed first);
* ``tpu_guard_numerics=raise`` firings — `models.gbdt` dumps beside
  the structured error;
* faultline-injected crashes ride the paths above (an injected raise
  propagates through the train loop's recovery, an injected hang
  through the watchdog).

The serving server exposes the live ring as ``GET /debug/blackbox``;
``tools/trace_merge.py --blackbox`` overlays multiple hosts' dumps
(entries carry wall-clock epoch seconds, comparable across hosts) to
answer "who hung first".

The dump directory resolves: `configure(dump_dir=...)` (the
``tpu_obs_blackbox_dir`` param) > ``LIGHTGBM_TPU_BLACKBOX_DIR`` env >
the live ``tpu_trace_dir`` > the working directory — EXCEPT when the
working directory is a source checkout (a ``.git`` entry is present),
which falls through to the system temp dir instead: .gitignore or
not, a crash artifact must never regrow at a repo root and ride into
a commit.  Wherever it lands, the FILENAME is always the canonical
``blackbox-host<k>.json``; callers that pass `path=` a directory get
the canonical name joined under it.

The port's own copy of `lightgbm_tpu/obs/flightrecorder.py`, the same
ring, dump format and file name.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils import lockcheck

DEFAULT_EVENTS = 512

# the ring: GIL-atomic appends (deque with maxlen), no lock on the
# record path.  Entries are tuples
# (epoch_s, kind, name, tid, fields-or-None) — dicts materialize only
# at dump/read time.
_ring: deque = deque(maxlen=DEFAULT_EVENTS)

_dump_lock = lockcheck.make_lock("obs.flightrecorder.dump")
_dump_dir = ""
_last_dump: Optional[str] = None
_dumps = 0


def _host_index() -> int:
    from ..utils import faultline

    return faultline.host_index()


def configure(events: Optional[int] = None,
              dump_dir: Optional[str] = None) -> None:
    """Resize the ring / set the dump directory.  None leaves the
    respective setting untouched (the obs no-clobber convention);
    resizing keeps the newest entries."""
    global _ring, _dump_dir
    if events is not None:
        n = max(int(events), 16)
        if n != _ring.maxlen:
            _ring = deque(list(_ring)[-n:], maxlen=n)
    if dump_dir is not None:
        _dump_dir = str(dump_dir)


def depth() -> int:
    return int(_ring.maxlen or DEFAULT_EVENTS)


def note(_kind: str, _name: str, **fields) -> None:
    """One flight-recorder entry.  Always on; called only at coarse
    boundaries (round, collective, transition) so the off-mode overhead
    gate holds.  The deque append is GIL-atomic — no lock."""
    _ring.append((time.time(), _kind, _name,
                  threading.get_ident() % 100000, fields or None))


def entries() -> List[Dict]:
    """The ring as dicts, oldest first (a live read, used by the
    serving ``GET /debug/blackbox`` route and the dump)."""
    out = []
    for t, kind, name, tid, fields in list(_ring):
        rec = {"t": round(t, 6), "kind": kind, "name": name, "tid": tid}
        if fields:
            rec["fields"] = {k: _jsonable(v) for k, v in fields.items()}
        out.append(rec)
    return out


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def reset() -> None:
    """Clear the ring (tests / fresh windows); configuration persists."""
    global _last_dump, _dumps
    _ring.clear()
    # under the dump lock like dump() itself: a reset racing a crash
    # dump must not interleave with its _last_dump/_dumps writes
    # (the ring clear above stays lock-free
    # by design, deque ops are GIL-atomic)
    with _dump_lock:
        _last_dump = None
        _dumps = 0


def last_dump() -> Optional[str]:
    return _last_dump


def blackbox_dir() -> str:
    if _dump_dir:
        return _dump_dir
    env = os.environ.get("LIGHTGBM_TPU_BLACKBOX_DIR", "")
    if env:
        return env
    from .trace import trace_dir

    td = trace_dir()
    if td:
        return td
    cwd = os.getcwd()
    if os.path.exists(os.path.join(cwd, ".git")):
        # a source checkout: a crash dump written here would sit at the
        # repo root waiting to be committed — park it in temp instead
        # (an EXPLICIT dir via param/env/path is always honored as-is)
        import tempfile

        return tempfile.gettempdir()
    return cwd


def dump(reason: str, path: Optional[str] = None,
         exc: Optional[BaseException] = None) -> Optional[str]:
    """Write the blackbox: ring entries (oldest first) + a registry
    metric snapshot + crash metadata, atomically (tmp + rename — a
    second crash mid-dump never leaves a torn file).  Repeated dumps
    overwrite ``blackbox-host<k>.json`` in place: the newest death is
    the one worth reading.  Never raises — the recorder must not turn
    a crash into a different crash."""
    global _last_dump, _dumps
    from .metrics import REGISTRY

    try:
        host = _host_index()
        if path is None:
            d = blackbox_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"blackbox-host{host}.json")
        elif os.path.isdir(path):
            # a directory keeps the canonical (gitignored) filename —
            # only an explicit FILE path may rename the dump
            path = os.path.join(path, f"blackbox-host{host}.json")
        record = {
            "reason": str(reason),
            "host": host,
            "pid": os.getpid(),
            "t": round(time.time(), 6),
            "ring_depth": depth(),
            "entries": entries(),          # oldest first; tail = newest
            "metrics": REGISTRY.snapshot(),
        }
        if exc is not None:
            record["exception"] = {"type": type(exc).__name__,
                                   "message": str(exc)}
        tmp = f"{path}.tmp.{os.getpid()}"
        with _dump_lock:
            with open(tmp, "w") as f:
                json.dump(record, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _last_dump = path
            _dumps += 1
        return path
    except Exception:  # pragma: no cover - disk full / perms
        return None


# ---------------------------------------------------------------------------
# unhandled-exception hooks (chained, installed once at import).  BOTH
# hooks: sys.excepthook never fires for non-main threads, and the
# serving runtime the recorder targets IS multithreaded (batcher
# worker, dispatch runners, HTTP handlers) — threading.excepthook
# covers those deaths.
# ---------------------------------------------------------------------------
_prev_excepthook = None
_prev_thread_hook = None


def _excepthook(exc_type, exc, tb):  # pragma: no cover - process death
    note("crash", "unhandled_exception", type=exc_type.__name__,
         message=str(exc)[:200])
    dump("unhandled_exception", exc=exc)
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _thread_excepthook(args):  # pragma: no cover - thread death
    note("crash", "unhandled_thread_exception",
         type=args.exc_type.__name__, message=str(args.exc_value)[:200],
         thread=getattr(args.thread, "name", "?"))
    dump("unhandled_thread_exception", exc=args.exc_value)
    if _prev_thread_hook is not None:
        _prev_thread_hook(args)


def _install_excepthook() -> None:
    global _prev_excepthook, _prev_thread_hook
    if sys.excepthook is not _excepthook:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
    if threading.excepthook is not _thread_excepthook:
        _prev_thread_hook = threading.excepthook
        threading.excepthook = _thread_excepthook


_install_excepthook()
