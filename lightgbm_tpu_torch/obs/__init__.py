"""Telemetry of the port: the metrics registry, the flight recorder and
the training reference profiles.

One import surface, as `lightgbm_tpu/obs/__init__.py` gives it::

    from ..obs import REGISTRY, flightrecorder, span, event

* `REGISTRY` — the process-global `MetricsRegistry` (`obs/metrics.py`,
  a copy of the JAX package's): the checkpoint, guard and OOM counters
  of utils/checkpoint.py, models/gbdt.py and utils/membudget.py
  record there unconditionally.
* `flightrecorder` — the always-on ring dumped to
  ``blackbox-host<k>.json`` (under ``tpu_obs_blackbox_dir``) when a
  training run dies.
* `modelhealth` — the ``tpu_feature_profile:`` model trailer.
* `span`, `event`, `timed`, `metrics_on`, `tracing_on` — the forms that
  ``tpu_telemetry=off`` gives in the JAX package (its obs/trace.py:
  225-260): a shared null context manager, no-op events, untimed
  blocks.  The span tracer, its exporters and the resource gauges are
  not ported (ROADMAP A11), and `models/learner.py:check_slice`
  refuses ``tpu_telemetry``/``tpu_trace_dir`` by name.
"""

from __future__ import annotations

import contextlib

from . import flightrecorder, modelhealth  # noqa: F401
from .metrics import (DEFAULT_SECONDS_BUCKETS, MetricsRegistry,  # noqa: F401
                      REGISTRY, histogram_quantile)

_NULL = contextlib.nullcontext()


def span(_name: str, **tags):
    """The null span: tracing is off."""
    return _NULL


def event(_name: str, **fields) -> None:
    """No narrative record without a tracer; the registry still counts."""


def timed(name: str, metric: str = "lgbm_timed_seconds"):
    """An untimed block: metrics mode is off."""
    return _NULL


def metrics_on() -> bool:
    return False


def tracing_on() -> bool:
    return False


def configure_from_config(config) -> None:
    """Apply the ``tpu_obs_*`` parameters of a Config (the JAX package's
    obs/trace.py:124-140 without the tracer's two): the registry's
    sample ring and the flight recorder's depth and dump directory.  The
    defaults (0 / "") leave the process policy as it is."""
    from . import metrics

    ring = int(config.tpu_obs_ring_samples)
    if ring > 0:
        metrics.set_sample_ring(ring)
    bb_events = int(config.tpu_obs_blackbox_events)
    bb_dir = str(config.tpu_obs_blackbox_dir).strip()
    flightrecorder.configure(events=bb_events if bb_events > 0 else None,
                             dump_dir=bb_dir or None)
