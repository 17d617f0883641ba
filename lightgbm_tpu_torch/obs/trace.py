"""Structured span tracer: nested host-side spans with monotonic walls,
Chrome-trace-event export (Perfetto-loadable), a per-host JSONL event
stream, and mirroring into torch profiler annotations.

The port of `lightgbm_tpu/obs/trace.py`.  Three telemetry modes,
process-global (`configure`, wired from the ``tpu_telemetry`` /
``tpu_trace_dir`` params at dataset and GBDT init, or the
LIGHTGBM_TPU_TELEMETRY / LIGHTGBM_TPU_TRACE_DIR env vars, the names the
JAX package reads, so one environment drives both packages):

* ``off``     — default.  Every instrumentation site degenerates to one
  module-flag check; `span()` returns a shared null context manager
  (no generator, no allocation beyond the kwargs dict).
* ``metrics`` — phase walls and counters flow into `obs.metrics.REGISTRY`
  but no spans are buffered.
* ``trace``   — additionally records nested spans (thread-local stack,
  thread/host/iteration tags), streams them as JSONL lines under
  ``tpu_trace_dir`` (``events-host<k>.jsonl``; incremental, so a dead
  run keeps everything up to the death), and mirrors each span into
  ``torch.profiler.record_function`` so the SAME names appear as user
  annotations around the kernels' launches in a torch.profiler (Kineto)
  trace.  `write_chrome_trace()` dumps the buffered spans as Chrome
  trace-event JSON (``trace-host<k>.json``) that loads directly in
  Perfetto; `tools/trace_merge.py` merges the per-host JSONL streams of
  a multi-process run into one such file.

Spans time host walls.  Telemetry never waits on the device (no
synchronize, no ``.item()``, no event wait): the device's share of a
span is the profiler's to show, through the mirror.  It never touches
random streams or device values either: model files are bit-identical
with tracing on or off.

Each thread has its own span stack and ``tid``.  A thread started on
behalf of a span (the sharded learners' shard threads) takes the
starting thread's stack with `adopt_span_stack(span_stack())`, so its
spans name the starting span as their parent.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .metrics import REGISTRY

MODES = ("off", "metrics", "trace")

# module-level fast flags: the ONLY thing hot sites read when telemetry
# is off
_METRICS = False
_TRACE = False

_state_lock = threading.Lock()
_mode = "off"
_trace_dir = ""

# span buffer (Chrome export source); bounded so week-long runs cannot
# grow memory — drops are counted, never silent
_EVENT_CAP = 500_000
_events: List[Dict] = []
_events_lock = threading.Lock()
_dropped = 0

_tls = threading.local()

# perf_counter origin: every ts is µs since process telemetry start so
# Chrome/Perfetto timelines start near zero
_T0_NS = time.perf_counter_ns()

_stream_lock = threading.Lock()
_stream = None          # open JSONL file handle
_stream_path = ""

_NULL = contextlib.nullcontext()

_MIRROR = None          # cached torch.profiler.record_function class


def _host_index() -> int:
    # lazy: the fault harness owns host-identity resolution (explicit
    # override > env > the initialized process group's rank > 0)
    from ..utils import faultline

    return faultline.host_index()


def _mirror_cls():
    """torch.profiler.record_function, imported on the first traced
    span (it makes no CUDA context)."""
    global _MIRROR
    if _MIRROR is None:
        from torch.profiler import record_function

        _MIRROR = record_function
    return _MIRROR


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def configure(mode: Optional[str] = None,
              trace_dir: Optional[str] = None) -> None:
    """Set the process-global telemetry policy.  ``mode=None`` /
    ``trace_dir=None`` leave the respective setting untouched (the
    no-clobber convention `parallel.collective.configure` uses, so a
    Booster constructed without telemetry params never disarms a policy
    another layer armed)."""
    global _mode, _trace_dir, _METRICS, _TRACE
    with _state_lock:
        if mode is not None:
            m = str(mode).strip().lower()
            if m not in MODES:
                raise ValueError(
                    f"tpu_telemetry must be one of {MODES}, got {mode!r}")
            _mode = m
            _METRICS = m in ("metrics", "trace")
            _TRACE = m == "trace"
        if trace_dir is not None:
            _trace_dir = str(trace_dir)


def configure_from_config(config) -> None:
    """Apply the ``tpu_telemetry`` / ``tpu_trace_dir`` / ``tpu_obs_*``
    params from a Config.  The registry defaults ("" / 0) mean UNSET
    (leave the process policy); an explicit value — including "off" —
    really applies."""
    mode = str(config.tpu_telemetry).strip()
    tdir = str(config.tpu_trace_dir).strip()
    configure(mode=mode or None, trace_dir=tdir or None)
    from . import flightrecorder, metrics

    ring = int(config.tpu_obs_ring_samples)
    if ring > 0:
        metrics.set_sample_ring(ring)
    bb_events = int(config.tpu_obs_blackbox_events)
    bb_dir = str(config.tpu_obs_blackbox_dir).strip()
    flightrecorder.configure(events=bb_events if bb_events > 0 else None,
                             dump_dir=bb_dir or None)


def _env_init() -> None:
    mode = os.environ.get("LIGHTGBM_TPU_TELEMETRY", "").strip()
    tdir = os.environ.get("LIGHTGBM_TPU_TRACE_DIR", "").strip()
    if mode or tdir:
        configure(mode=mode or None, trace_dir=tdir or None)


def mode() -> str:
    return _mode


def trace_dir() -> str:
    return _trace_dir


def metrics_on() -> bool:
    """True under ``metrics`` or ``trace`` — the per-iteration hot-path
    gate for registry writes."""
    return _METRICS


def tracing_on() -> bool:
    return _TRACE


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
def _now_us() -> float:
    return (time.perf_counter_ns() - _T0_NS) / 1e3


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def span_stack() -> Optional[Tuple]:
    """This thread's open spans, outermost first, for a thread started
    on their behalf (`adopt_span_stack`); None when tracing is off."""
    if not _TRACE:
        return None
    return tuple(_stack())


def adopt_span_stack(stack: Optional[Tuple]) -> None:
    """Seed this thread's span stack with another thread's
    (`span_stack()`): its spans then take the other thread's innermost
    span as their parent and nest one level below it."""
    if stack:
        _tls.stack = list(stack)


class _Span:
    __slots__ = ("name", "tags", "t0", "_mirror")

    def __init__(self, name: str, tags: Dict):
        self.name = name
        self.tags = tags
        self.t0 = 0.0
        self._mirror = None

    def __enter__(self) -> "_Span":
        st = _stack()
        if st:
            self.tags.setdefault("parent", st[-1].name)
        self.tags.setdefault("depth", len(st))
        st.append(self)
        self._mirror = _mirror_cls()(self.name)
        self._mirror.__enter__()
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc) -> None:
        dur = _now_us() - self.t0
        self._mirror.__exit__(*exc)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _record({
            "kind": "span", "name": self.name, "ph": "X",
            "ts": self.t0, "dur": dur,
            "host": _host_index(), "tid": threading.get_ident() % 100000,
            "tags": self.tags,
        })


def span(_name: str, **tags):
    """A nested span context manager; the shared null CM when tracing is
    off (no per-call allocation beyond the kwargs dict).  The span-name
    parameter is underscored so tags may themselves be called ``name``."""
    if not _TRACE:
        return _NULL
    return _Span(_name, tags)


def event(_name: str, **fields) -> None:
    """One structured instant event (collective timeout, checkpoint,
    guard firing): an ``i``-phase Chrome event plus a JSONL line,
    recorded whenever TRACING is on.  Counters for these events live in
    the registry regardless of mode — this is the narrative record, not
    the count."""
    if not _TRACE:
        return
    _record({
        "kind": "event", "name": _name, "ph": "i",
        "ts": _now_us(), "dur": 0.0,
        "host": _host_index(), "tid": threading.get_ident() % 100000,
        "tags": fields,
    })


@contextlib.contextmanager
def timed(name: str, metric: str = "lgbm_timed_seconds"):
    """Wall-clock a block into the registry (histogram `metric`, label
    ``name=``) and, under trace mode, a span.  The raw per-repeat walls
    read back via ``REGISTRY.histogram_samples``."""
    if not _METRICS:
        yield
        return
    sp = span(name)
    t0 = time.perf_counter()
    try:
        with sp:
            yield
    finally:
        # record in finally, like timer.PHASE: a raising block must not
        # leave the span recorded but the registry sample missing
        REGISTRY.observe(metric, time.perf_counter() - t0, name=name)


# ---------------------------------------------------------------------------
# recording / export
# ---------------------------------------------------------------------------
def _record(ev: Dict) -> None:
    global _dropped
    # mirror into the always-on flight recorder FIRST: the blackbox
    # ring is independently bounded, so a full trace buffer (the
    # _EVENT_CAP drop path below) must not silence it
    from . import flightrecorder

    flightrecorder.note(ev["kind"], ev["name"], **(ev["tags"] or {}))
    with _events_lock:
        if len(_events) >= _EVENT_CAP:
            _dropped += 1
            REGISTRY.inc("lgbm_trace_events_dropped_total")
            return
        _events.append(ev)
    if _trace_dir:
        _stream_write(ev)


def _stream_write(ev: Dict) -> None:
    global _stream, _stream_path
    line = json.dumps({
        "kind": ev["kind"], "name": ev["name"], "ts_us": round(ev["ts"], 3),
        "dur_us": round(ev["dur"], 3), "host": ev["host"],
        "tid": ev["tid"], "tags": ev["tags"],
    })
    with _stream_lock:
        path = os.path.join(_trace_dir,
                            f"events-host{_host_index()}.jsonl")
        try:
            if _stream is None or _stream_path != path:
                if _stream is not None:
                    _stream.close()
                os.makedirs(_trace_dir, exist_ok=True)
                _stream = open(path, "a")
                _stream_path = path
            _stream.write(line + "\n")
            _stream.flush()
        except OSError:  # pragma: no cover - disk full / perms
            pass


def events() -> List[Dict]:
    with _events_lock:
        return list(_events)


def reset_events() -> None:
    """Drop the buffered spans (tests / fresh profiling windows); the
    JSONL stream on disk is untouched."""
    global _dropped
    with _events_lock:
        _events.clear()
        _dropped = 0


def chrome_trace() -> Dict:
    """The buffered spans as a Chrome trace-event JSON object (Perfetto
    opens it directly; chrome://tracing too)."""
    host = _host_index()
    out = [{
        "name": "process_name", "ph": "M", "pid": host, "tid": 0,
        "args": {"name": f"lightgbm_tpu host {host}"},
    }]
    with _events_lock:
        evs = list(_events)
    for ev in evs:
        rec = {"name": ev["name"], "ph": ev["ph"],
               "ts": round(ev["ts"], 3), "pid": ev["host"],
               "tid": ev["tid"], "args": dict(ev["tags"])}
        if ev["ph"] == "X":
            rec["dur"] = round(ev["dur"], 3)
        else:
            rec["s"] = "t"  # instant-event scope
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: Optional[str] = None) -> Optional[str]:
    """Dump the buffered spans as ``trace-host<k>.json`` under
    ``tpu_trace_dir`` (or an explicit path).  Returns the written path,
    or None when there is nowhere to write."""
    if path is None:
        if not _trace_dir:
            return None
        os.makedirs(_trace_dir, exist_ok=True)
        path = os.path.join(_trace_dir,
                            f"trace-host{_host_index()}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(chrome_trace(), f)
    os.replace(tmp, path)
    return path


def flush() -> None:
    """Flush/close the JSONL stream (end of train, interpreter exit)."""
    global _stream
    with _stream_lock:
        if _stream is not None:
            try:
                _stream.flush()
                _stream.close()
            except OSError:  # pragma: no cover
                pass
            _stream = None


_env_init()
