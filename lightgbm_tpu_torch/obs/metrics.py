"""Process-global metrics registry: labeled counters, gauges, and
fixed-bucket histograms.

The reference ships only ad-hoc wall-clock logging (``Log::Info`` TIMETAG
dumps, src/treelearner/serial_tree_learner.cpp:21-48); every phase of
this repo's own history that went unobserved cost a postmortem (the
degraded-CPU bench rounds, the r04→r05 container-variance "regression").
The registry is the one sink every layer writes:

* **counters** — monotonic totals (``lgbm_collective_timeouts_total``,
  ``lgbm_log_warnings_total``), labeled (``phase="sketch"``).
* **gauges** — last-write-wins levels (serving queue depth).
* **histograms** — fixed upper-bound buckets, Prometheus-style
  cumulative export plus a bounded ring of raw samples so callers that
  need per-repeat walls (bench segments) can read them back without a
  second stopwatch.  ``quantile()`` is the ONE percentile estimator —
  the serving ``/stats`` endpoint and the ``/metrics`` Prometheus
  export both derive from the same buckets, so they can never disagree.

Everything is thread-safe under per-family locks; creation is cached so
the steady-state cost of an update is one lock + one dict write.  The
registry itself is ALWAYS live (rare but vital events — watchdog
timeouts, guard firings, log warnings — record unconditionally); the
``tpu_telemetry`` gate lives in `obs.trace` and is consulted only by
the per-iteration hot-path instrumentation sites.

The port's own copy of `lightgbm_tpu/obs/metrics.py`: the same
families, labels and exports.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils import lockcheck

# default seconds buckets: wide enough for ingest phases (minutes) and
# fine enough for serving latencies (sub-ms)
DEFAULT_SECONDS_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

# raw samples kept per histogram child (newest-first readback for bench
# segment medians AND the serving admission controller's recent-window
# SLO projection, which reads the last ServingStats._RECENT = 256 —
# keep this ring at least that deep); bounded so long runs cannot grow
# memory.  Configurable via tpu_obs_ring_samples (set_sample_ring);
# readers that care whether the ring dropped samples ask
# histogram_samples(..., with_truncated=True).
DEFAULT_SAMPLE_RING = 256
_sample_ring = DEFAULT_SAMPLE_RING


def set_sample_ring(n: int) -> None:
    """Resize the per-histogram raw-sample ring (process-global; wired
    from ``tpu_obs_ring_samples``).  Existing rings shrink lazily on
    their next observe; floor 1 so readback always sees the newest
    sample."""
    global _sample_ring
    _sample_ring = max(int(n), 1)


def sample_ring() -> int:
    return _sample_ring


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...],
                extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(key) + ([extra] if extra else [])
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n")) for k, v in items)
    return "{" + body + "}"


class _Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0


class _Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0


class _Histogram:
    __slots__ = ("bounds", "counts", "sum", "count", "samples",
                 "samples_truncated")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self.bounds = bounds                     # finite upper bounds
        self.counts = [0] * (len(bounds) + 1)    # + the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.samples: List[float] = []           # bounded ring
        self.samples_truncated = False           # ring ever dropped one

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        self.samples.append(v)
        if len(self.samples) > _sample_ring:
            del self.samples[:len(self.samples) - _sample_ring]
            self.samples_truncated = True

    def quantile(self, q: float) -> float:
        """Prometheus histogram_quantile: linear interpolation inside
        the bucket holding rank q*count (first bucket interpolates from
        0; the +Inf bucket degrades to the last finite bound)."""
        if self.count <= 0:
            return 0.0
        rank = max(min(float(q), 1.0), 0.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c > 0 and cum + c >= rank:
                if i >= len(self.bounds):        # +Inf bucket
                    return self.bounds[-1] if self.bounds else 0.0
                lower = self.bounds[i - 1] if i > 0 else 0.0
                upper = self.bounds[i]
                return lower + (upper - lower) * (rank - cum) / c
            cum += c
        return self.bounds[-1] if self.bounds else 0.0


def histogram_quantile(bounds: Iterable[float], counts: Iterable[int],
                       q: float) -> float:
    """The registry's quantile estimator over externally-held buckets —
    exported so a Prometheus scrape (bucket counts parsed back out of
    the text format) can reproduce `/stats` percentiles EXACTLY."""
    h = _Histogram(tuple(bounds))
    h.counts = list(counts)
    h.count = sum(h.counts)
    return h.quantile(q)


class _Family:
    """All children (label combinations) of one metric name."""

    def __init__(self, name: str, kind: str, help_text: str = "",
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.kind = kind                        # counter | gauge | histogram
        self.help = help_text
        self.buckets = buckets
        self.lock = lockcheck.make_lock(f"obs.metrics.family:{name}")
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def child(self, labels: Dict[str, str]):
        key = _label_key(labels)
        with self.lock:
            c = self.children.get(key)
            if c is None:
                if self.kind == "counter":
                    c = _Counter()
                elif self.kind == "gauge":
                    c = _Gauge()
                else:
                    c = _Histogram(self.buckets or DEFAULT_SECONDS_BUCKETS)
                self.children[key] = c
            return c


class MetricsRegistry:
    """Thread-safe named-metric store with Prometheus text export.

    One process-global instance (`REGISTRY`) serves training/distributed/
    checkpoint telemetry; the serving stack holds a private instance per
    session so concurrent sessions (tests) never cross-count.
    """

    def __init__(self) -> None:
        self._lock = lockcheck.make_lock("obs.metrics.registry")
        self._families: Dict[str, _Family] = {}

    # -- family creation/lookup ----------------------------------------
    def _family(self, name: str, kind: str, help_text: str = "",
                buckets: Optional[Tuple[float, ...]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, kind, help_text, buckets)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"not {kind}")
        return fam

    # -- writes --------------------------------------------------------
    def inc(self, _name: str, n: float = 1, help: str = "",
            **labels: str) -> None:
        # metric-name params are underscored so label kwargs may be
        # called `name` (collective wait times label by collective name)
        fam = self._family(_name, "counter", help)
        c = fam.child(labels)
        with fam.lock:
            c.value += n

    def set_gauge(self, _name: str, v: float, help: str = "",
                  **labels: str) -> None:
        fam = self._family(_name, "gauge", help)
        c = fam.child(labels)
        with fam.lock:
            c.value = float(v)

    def observe(self, _name: str, v: float,
                buckets: Optional[Tuple[float, ...]] = None,
                help: str = "", **labels: str) -> None:
        fam = self._family(_name, "histogram", help, buckets)
        h = fam.child(labels)
        with fam.lock:
            h.observe(float(v))

    # -- reads ---------------------------------------------------------
    def value(self, _name: str, **labels: str) -> float:
        """Counter/gauge value (0.0 when the child does not exist)."""
        fam = self._families.get(_name)
        if fam is None:
            return 0.0
        c = fam.children.get(_label_key(labels))
        return 0.0 if c is None else float(c.value)

    def histogram_quantile(self, _name: str, q: float,
                           **labels: str) -> float:
        fam = self._families.get(_name)
        if fam is None:
            return 0.0
        h = fam.children.get(_label_key(labels))
        return 0.0 if h is None else h.quantile(q)

    def histogram_samples(self, _name: str, with_truncated: bool = False,
                          **labels: str):
        """The bounded raw-sample ring (newest last) — per-repeat walls
        for callers like bench that need medians, not just buckets.

        ``with_truncated=True`` returns ``(samples, truncated)`` where
        `truncated` reports whether the ring EVER dropped a sample for
        this child — so a repeat-readback loop can tell "all my repeats
        are here" from "the ring silently under-counts"."""
        fam = self._families.get(_name)
        if fam is None:
            return ([], False) if with_truncated else []
        h = fam.children.get(_label_key(labels))
        if h is None:
            return ([], False) if with_truncated else []
        with fam.lock:
            samples = list(h.samples)
            truncated = bool(h.samples_truncated)
        return (samples, truncated) if with_truncated else samples

    def histogram_stats(self, _name: str, **labels: str
                        ) -> Tuple[int, float]:
        """(count, sum) of one histogram child."""
        fam = self._families.get(_name)
        if fam is None:
            return 0, 0.0
        h = fam.children.get(_label_key(labels))
        return (0, 0.0) if h is None else (h.count, h.sum)

    def label_values(self, name: str, label: str) -> List[str]:
        """Distinct values one label takes across a family's children."""
        fam = self._families.get(name)
        if fam is None:
            return []
        out = []
        with fam.lock:
            for key in fam.children:
                for k, v in key:
                    if k == label and v not in out:
                        out.append(v)
        return sorted(out)

    def snapshot(self) -> Dict:
        """Plain-dict dump (tests, JSONL flushes)."""
        out: Dict = {}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            with fam.lock:
                for key, c in fam.children.items():
                    tag = fam.name + _fmt_labels(key)
                    if fam.kind == "histogram":
                        out[tag] = {"count": c.count, "sum": c.sum}
                    else:
                        out[tag] = c.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    def clear_family(self, _name: str) -> None:
        """Drop one metric family's children (the family itself and its
        type registration survive) — partial resets like the bench
        zeroing the phase accumulation between runs."""
        fam = self._families.get(_name)
        if fam is not None:
            with fam.lock:
                fam.children.clear()

    def remove(self, _name: str, **labels: str) -> None:
        """Drop ONE labeled child — per-entity gauges (a serving
        model's HBM bytes) must disappear with the entity, or a
        long-lived hot-swapping server grows one dead series per
        version ever loaded."""
        fam = self._families.get(_name)
        if fam is not None:
            with fam.lock:
                fam.children.pop(_label_key(labels), None)

    # -- Prometheus text exposition (version 0.0.4) --------------------
    def to_prometheus_text(self) -> str:
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            with fam.lock:
                children = list(fam.children.items())
            for key, c in sorted(children):
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{fam.name}{_fmt_labels(key)} {c.value:g}")
                    continue
                cum = 0
                for ub, cnt in zip(c.bounds, c.counts):
                    cum += cnt
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(key, ('le', repr(float(ub))))} {cum}")
                cum += c.counts[-1]
                lines.append(
                    f"{fam.name}_bucket"
                    f"{_fmt_labels(key, ('le', '+Inf'))} {cum}")
                lines.append(f"{fam.name}_sum{_fmt_labels(key)} {c.sum:g}")
                lines.append(f"{fam.name}_count{_fmt_labels(key)} {c.count}")
        return "\n".join(lines) + ("\n" if lines else "")


#: the process-global registry every non-serving layer writes to
REGISTRY = MetricsRegistry()
