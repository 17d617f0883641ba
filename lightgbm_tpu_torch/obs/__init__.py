"""Unified telemetry of the port: metrics registry + span tracer +
resource accounting + flight recorder.

One import surface for every instrumented layer, as
`lightgbm_tpu/obs/__init__.py` gives it::

    from ..obs import REGISTRY, span, timed, metrics_on, tracing_on
    from ..obs import flightrecorder, resources

* `REGISTRY` — process-global `MetricsRegistry` (counters, gauges,
  fixed-bucket histograms; Prometheus text export).
* `span(name, **tags)` — nested structured span (Chrome-trace/Perfetto
  export, JSONL stream, torch.profiler `record_function` mirror); null
  when ``tpu_telemetry`` != trace.
* `timed(name)` — registry-backed stopwatch.
* `configure` / `configure_from_config` — process-global policy from
  ``tpu_telemetry`` (off | metrics | trace), ``tpu_trace_dir`` and the
  ``tpu_obs_*`` params (histogram sample ring, flight-recorder depth
  and blackbox dump dir).
* `resources` — device memory gauges from the CUDA caching allocator,
  phase-tagged peak watermarks, process runtime stats.
* `flightrecorder` — the ALWAYS-ON bounded ring of recent spans/
  transitions dumped to ``blackbox-host<k>.json`` on a crash.
* `modelhealth` — the ``tpu_feature_profile:`` model trailer.

See `obs.metrics`, `obs.trace`, `obs.resources` and
`obs.flightrecorder` for the full contracts.
"""

from . import flightrecorder, modelhealth, resources  # noqa: F401
from .metrics import (DEFAULT_SECONDS_BUCKETS, MetricsRegistry,  # noqa: F401
                      REGISTRY, histogram_quantile)
from .trace import (adopt_span_stack, chrome_trace, configure,  # noqa: F401
                    configure_from_config, event, events, flush,
                    metrics_on, mode, reset_events, span, span_stack,
                    timed, trace_dir, tracing_on, write_chrome_trace)
