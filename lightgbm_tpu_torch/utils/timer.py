"""Phase timers — the TIMETAG subsystem analog, backed by the registry.

The port of `lightgbm_tpu/utils/timer.py`.  The reference accumulates
per-phase wall time behind a compile-time flag (reference
src/treelearner/serial_tree_learner.cpp:21-48).  Here every `PHASE`
block feeds the telemetry layer (`lightgbm_tpu_torch.obs`):

* phase walls accumulate into the process-global registry as
  ``lgbm_phase_seconds_total{phase=...}`` / ``lgbm_phase_runs_total``
  whenever telemetry (`tpu_telemetry=metrics|trace`) OR the
  LIGHTGBM_TPU_TIMETAG switch is on — `summary()` reads the registry, so
  a bench and the Prometheus export see the SAME numbers;
* under ``tpu_telemetry=trace`` each block is additionally a structured
  span (Chrome-trace/Perfetto export + torch.profiler mirror via
  obs.span);
* `print_summary()` (atexit when LIGHTGBM_TPU_TIMETAG=1) prints the
  table, like the reference's Log::Info TIMETAG dumps;
* `trace(dir)` runs a block under `torch.profiler.profile` (the CPU, and
  the card where there is one) and writes its Chrome trace under `dir`:
  the counterpart of the JAX package's `jax.profiler.trace`.  Under
  ``tpu_telemetry=trace`` the spans appear in it as user annotations
  around the kernels they launched.

When everything is off a PHASE block costs one flag check.  Walls are
host walls: a phase that only launches device work ends before that
work does.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import tempfile
import time
from typing import Dict, Iterator, Optional

from ..obs import REGISTRY, span
from ..obs import metrics_on as _obs_metrics_on
from ..obs import resources as _resources
from .log import Log

_enabled = os.environ.get("LIGHTGBM_TPU_TIMETAG", "") not in ("", "0")

_SECONDS = "lgbm_phase_seconds_total"
_RUNS = "lgbm_phase_runs_total"


def enabled() -> bool:
    return _enabled or _obs_metrics_on()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def _record(name: str, seconds: float) -> None:
    REGISTRY.inc(_SECONDS, seconds,
                 help="accumulated wall seconds per lifecycle phase",
                 phase=name)
    REGISTRY.inc(_RUNS, 1, phase=name)


# phases whose wall bracket doubles as a device-memory watermark
# bracket (obs/resources.py phase_peak): the binning phase IS the
# ingest memory phase — the binning chunks and the bin matrix live
# inside it
_MEM_PHASE = {"binning": "ingest"}


@contextlib.contextmanager
def PHASE(name: str) -> Iterator[None]:
    """Accumulate wall time under `name` (no-op unless enabled); a span
    under tpu_telemetry=trace; a device-memory watermark bracket for
    the phases in `_MEM_PHASE`."""
    if not (_enabled or _obs_metrics_on()):
        yield
        return
    sp = span(name)
    mem_phase = _MEM_PHASE.get(name)
    mem = (_resources.phase_peak(mem_phase) if mem_phase
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with mem, sp:
            yield
    finally:
        _record(name, time.perf_counter() - t0)


def add(name: str, seconds: float) -> None:
    if _enabled or _obs_metrics_on():
        _record(name, seconds)


def summary() -> Dict[str, float]:
    return {p: REGISTRY.value(_SECONDS, phase=p)
            for p in REGISTRY.label_values(_SECONDS, "phase")}


def counts() -> Dict[str, int]:
    return {p: int(REGISTRY.value(_RUNS, phase=p))
            for p in REGISTRY.label_values(_RUNS, "phase")}


def reset() -> None:
    """Zero the phase accumulation (a bench reuses the process).  The
    registry holds phases beside unrelated metric families, so only the
    phase families reset."""
    REGISTRY.clear_family(_SECONDS)
    REGISTRY.clear_family(_RUNS)


def print_summary() -> None:
    acc = summary()
    if not acc:
        return
    cnt = counts()
    width = max(len(k) for k in acc)
    Log.info("phase timings:")
    for name, secs in sorted(acc.items(), key=lambda kv: -kv[1]):
        Log.info(f"  {name:<{width}}  {secs:9.3f}s  x{cnt.get(name, 0)}")


if _enabled:
    atexit.register(print_summary)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler around a block, its Chrome trace written as
    ``torch-trace-host<k>.json`` under `log_dir` (default: the
    ``tpu_trace_dir``, else ``lightgbm_tpu_torch_trace`` in the system
    temp dir); open it in Perfetto.  Profiles the card's activity too
    where CUDA is available."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..obs import trace_dir
    from . import faultline

    if log_dir is None:
        log_dir = trace_dir() or os.path.join(tempfile.gettempdir(),
                                              "lightgbm_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        # written on a raising block too, as jax.profiler.stop_trace is
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"torch-trace-host{faultline.host_index()}.json"))
