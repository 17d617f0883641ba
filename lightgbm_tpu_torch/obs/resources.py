"""Resource observability: device memory accounting + process runtime
stats.

The port of `lightgbm_tpu/obs/resources.py`, reading the CUDA caching
allocator where the JAX package reads ``device.memory_stats()``:

* **device gauges** — `device_memory_stats(d)` maps
  ``torch.cuda.memory_stats(d)`` onto the JAX keys: the allocator's
  *allocated* bytes (``allocated_bytes.all.current`` / ``.peak``, what
  `utils/membudget.py` plans against) become ``bytes_in_use`` /
  ``peak_bytes_in_use``, the card's ``total_memory`` ``bytes_limit``;
  the reserved bytes ride beside them as ``bytes_reserved`` /
  ``peak_bytes_reserved``.  Every device of
  ``range(torch.cuda.device_count())`` reports (the sharded learners
  place shard i on ``cuda:(i % cards)``).  On the CPU, and while
  ``torch.cuda.is_initialized()`` is false, the answer is None: this
  module never creates a CUDA context.
* **phase watermarks** — `phase_peak(phase)` brackets one lifecycle
  phase (ingest / hist_build / score_update / predict) and records the
  peak device bytes the phase owned.  It emulates reset-and-read as the
  JAX module does: if the process-wide ``peak_bytes_in_use`` grew
  inside the bracket the phase owns the new peak; otherwise the phase
  is bounded by the live ``bytes_in_use`` it saw.  It never calls
  ``torch.cuda.reset_peak_memory_stats``: the process peak is
  `membudget`'s to read.  Gated on `obs.metrics_on()` — the off-mode
  train loop pays one flag check.
* **process runtime stats** — `process_runtime_stats()` (RSS, uptime,
  threads, open fds, GC collections): flat /proc + stdlib reads.
* **bench metrics** — `bench_resource_metrics()` packages the above
  plus the build ledger (`utils/compile_ledger.py`: the kernel
  library's builds and each kernel site's launch plans) into the
  ``train_peak_hbm_bytes`` / ``phase_peak_hbm_bytes`` /
  ``program_costs`` fields, explicitly None where there is nothing to
  report (the CPU).
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from .metrics import REGISTRY
from .trace import metrics_on

#: the phase vocabulary the watermark gauges use
PHASES = ("ingest", "hist_build", "score_update", "predict")

_PEAK_GAUGE = "lgbm_device_phase_peak_bytes"

# process-start anchor for uptime (obs imports at package import, so
# this is within milliseconds of interpreter start for any real run)
_T_START = time.time()

_lock = threading.Lock()
_phase_peaks: Dict[str, int] = {}


def _cuda():
    """torch.cuda once a CUDA context exists in this process, else None
    — resource accounting must never be what creates one."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is None or not torch_mod.cuda.is_initialized():
        return None
    return torch_mod.cuda


def _devices() -> List[int]:
    """The CUDA device indices to read, or [] (CPU / no context yet)."""
    cuda = _cuda()
    if cuda is None:
        return []
    return list(range(cuda.device_count()))


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """One card's allocator numbers under the JAX keys (`device`: its
    index, None the first card), or None on the CPU or before CUDA is
    initialized."""
    cuda = _cuda()
    if cuda is None:
        return None
    idx = 0 if device is None else int(device)
    if idx >= cuda.device_count():
        return None
    stats = cuda.memory_stats(idx)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
        "bytes_limit": int(cuda.get_device_properties(idx).total_memory),
    }


def all_device_memory_stats() -> List[Optional[Dict[str, int]]]:
    """Per-device memory stats ([] on the CPU)."""
    return [device_memory_stats(d) for d in _devices()]


def hbm_bytes_in_use() -> Optional[int]:
    """Max ``bytes_in_use`` across the cards; None on the CPU."""
    vals = [s["bytes_in_use"] for s in all_device_memory_stats()
            if s is not None]
    return max(vals) if vals else None


def peak_hbm_bytes() -> Optional[int]:
    """Max ``peak_bytes_in_use`` across the cards; None on the CPU (the
    value the ``train_peak_hbm_bytes`` bench metric records)."""
    vals = [s["peak_bytes_in_use"] for s in all_device_memory_stats()
            if s is not None]
    return max(vals) if vals else None


# ---------------------------------------------------------------------------
# phase-tagged peak watermarks
# ---------------------------------------------------------------------------
def _note_phase_peak(phase: str, peak: int) -> None:
    with _lock:
        prev = _phase_peaks.get(phase, 0)
        if peak <= prev:
            return
        _phase_peaks[phase] = int(peak)
        # gauge write INSIDE the lock: a racing smaller peak must not
        # overwrite a larger one on the exported surface
        REGISTRY.set_gauge(_PEAK_GAUGE, int(peak),
                           help="peak device bytes owned by one "
                                "lifecycle phase (reset-and-read "
                                "watermark)",
                           phase=phase)


#: shared no-op CM handed back when metrics are off — the per-iteration
#: hot path pays one flag check + one allocation-free return, the same
#: discipline obs.span uses
_NULL = contextlib.nullcontext()


def _fleet_watermark() -> Optional[tuple]:
    """(max peak, max bytes_in_use) across ALL cards, or None — the
    phase table aggregates the way `peak_hbm_bytes()` does, so a sharded
    phase peaking on another card explains the train peak beside it."""
    stats = [s for s in all_device_memory_stats() if s is not None]
    if not stats:
        return None
    return (max(s["peak_bytes_in_use"] for s in stats),
            max(s["bytes_in_use"] for s in stats))


class _PhasePeak:
    __slots__ = ("phase", "_p0", "_b0")

    def __init__(self, phase: str):
        self.phase = phase

    def __enter__(self) -> "_PhasePeak":
        before = _fleet_watermark()
        if before is None:      # CPU / no context: graceful None
            self._p0 = None
        else:
            self._p0, self._b0 = before
        return self

    def __exit__(self, *exc) -> None:
        if self._p0 is None:
            return
        after = _fleet_watermark()
        if after is None:  # pragma: no cover - context gone
            return
        p1, b1 = after
        # process-wide peak grew inside the bracket -> this phase owns
        # the new watermark; else bound by the live bytes seen
        _note_phase_peak(self.phase,
                         p1 if p1 > self._p0 else max(self._b0, b1))


def phase_peak(phase: str):
    """Bracket one lifecycle phase and record its peak device bytes.

    The shared null CM (no allocation) when telemetry metrics are off;
    on the CPU the bracket runs but records nothing."""
    if not metrics_on():
        return _NULL
    return _PhasePeak(phase)


def phase_peaks() -> Dict[str, int]:
    """Phase -> peak device bytes recorded so far ({} on the CPU)."""
    with _lock:
        return dict(_phase_peaks)


def reset_phase_peaks() -> None:
    with _lock:
        _phase_peaks.clear()
    REGISTRY.clear_family(_PEAK_GAUGE)


# ---------------------------------------------------------------------------
# process runtime stats
# ---------------------------------------------------------------------------
def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:  # pragma: no cover - non-procfs host
            import resource

            peak = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
            # linux reports KiB, darwin bytes; either way this is the
            # PEAK rss — the best a non-procfs host can offer
            return peak if sys.platform == "darwin" else peak * 1024
        except Exception:  # pragma: no cover
            return None


def _open_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:  # pragma: no cover - non-procfs host
        return None


def process_runtime_stats() -> Dict[str, Optional[float]]:
    """Flat process-runtime reads: RSS, uptime, threads, open fds, GC
    collections.  An unavailable source reports an explicit None —
    never a fictional 0 an fd-leak alert would read as a measurement."""
    rss = _rss_bytes()
    fds = _open_fds()
    return {
        "process_rss_bytes": int(rss) if rss is not None else None,
        "process_uptime_s": round(time.time() - _T_START, 3),
        "process_threads": threading.active_count(),
        "process_open_fds": int(fds) if fds is not None else None,
        "process_gc_collections": sum(
            s.get("collections", 0) for s in gc.get_stats()),
    }


def publish_process_gauges(registry=None) -> Dict[str, float]:
    """Refresh the process-runtime gauges in `registry` (default: the
    process-global one), so an export reads scrape-time values."""
    reg = REGISTRY if registry is None else registry
    stats = process_runtime_stats()
    names = {
        "process_rss_bytes": ("lgbm_process_resident_memory_bytes",
                              "resident set size"),
        "process_uptime_s": ("lgbm_process_uptime_seconds",
                             "seconds since process start"),
        "process_threads": ("lgbm_process_threads",
                            "live python threads"),
        "process_open_fds": ("lgbm_process_open_fds",
                             "open file descriptors"),
        "process_gc_collections": ("lgbm_process_gc_collections",
                                   "cumulative gc collections across "
                                   "generations"),
    }
    for key, (metric, help_text) in names.items():
        if stats[key] is None:
            continue   # unmeasurable here: no series beats a fiction
        reg.set_gauge(metric, float(stats[key]), help=help_text)
    return stats


# ---------------------------------------------------------------------------
# bench packaging
# ---------------------------------------------------------------------------
def bench_resource_metrics(ledger=None, memory: Optional[bool] = True,
                           train_peak: Optional[int] = None) -> Dict:
    """The resource fields a bench/smoke record carries:

    * ``train_peak_hbm_bytes`` — peak device bytes (None on the CPU).
      Pass ``train_peak`` snapshotted right after the train segments:
      ``peak_bytes_in_use`` is a process-lifetime high-water mark, so a
      call-time read after predict would attribute ITS peak to training.
    * ``phase_peak_hbm_bytes`` — phase -> watermark dict (None on the
      CPU),
    * ``program_costs`` — the build ledger's record: ``builds`` (the
      kernel library built or loaded, seconds, hash) and ``plans`` (one
      row a launch plan of a kernel site; with ``memory`` its scratch
      bytes), or None where it holds neither (the CPU, or the ledger
      off).
    """
    if ledger is None:
        from ..utils.compile_ledger import LEDGER as ledger
    peaks = phase_peaks()
    builds, plans = ledger.builds(), ledger.cost_table(memory=memory)
    return {
        "train_peak_hbm_bytes": (peak_hbm_bytes() if train_peak is None
                                 else train_peak),
        "phase_peak_hbm_bytes": peaks if peaks else None,
        "program_costs": ({"builds": builds, "plans": plans}
                          if builds or plans else None),
    }
