"""Observability, as in ``veles_tpu/observe``: stdlib-only and
import-light, so hot modules import it without dragging in anything.

Ported:

- :mod:`~veles_tpu_torch.observe.metrics`: counters, gauges and
  windowed histograms, which the serve tier's receipts read;
- :mod:`~veles_tpu_torch.observe.trace`: the span tracer (Chrome
  trace-event JSON with per-thread tracks, free while disabled);
- :mod:`~veles_tpu_torch.observe.flight`: the always-on black-box ring
  of recent events, dumped on an SLO violation, a canary rollback or an
  alert;
- :mod:`~veles_tpu_torch.observe.requests`: request-scoped serve
  tracing (trace ids, segment timelines, the tail-exemplar ring and the
  critical-path analyzer);
- :mod:`~veles_tpu_torch.observe.cluster` and
  :mod:`~veles_tpu_torch.observe.merge`: NTP-style clock offsets and
  the per-process trace merge;
- :mod:`~veles_tpu_torch.observe.timeseries`: fixed-interval bucket
  rings, their chunks and the fleet-side ``FleetTelemetry`` merge;
- :mod:`~veles_tpu_torch.observe.alerts`: burn-rate and EMA-spike alert
  rules, edge-triggered, with flight and exemplar dumps.

Waiting for ROADMAP.md Queue 1 item 11: ``profile.py`` (the profiler
hook and the JSONL ``Heartbeat``), ``baseline.py`` (the regression
sentinel), ``summary.py``, the ``python -m veles_tpu.observe`` command
line and the counterpart of ``xla_introspect.py``.
"""

from veles_tpu_torch.observe.alerts import (  # noqa: F401
    ALERTS_SCHEMA_VERSION, AlertManager, BurnRateRule, EmaSpikeRule,
    alerts, default_rules)
from veles_tpu_torch.observe.cluster import (  # noqa: F401
    TraceCollector, estimate_offset, probe_sample)
from veles_tpu_torch.observe.flight import (  # noqa: F401
    FLIGHT_SCHEMA_VERSION, FlightRecorder, flight, validate_flight)
from veles_tpu_torch.observe.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, health_snapshot,
    percentiles, registry)
from veles_tpu_torch.observe.requests import (  # noqa: F401
    ExemplarRing, analyze_files, exemplars, mint_trace_id,
    normalize_trace_id, render_requests)
from veles_tpu_torch.observe.timeseries import (  # noqa: F401
    SERIES_SCHEMA_VERSION, FleetTelemetry, SeriesRing,
    digest_percentiles, digest_values, fleet_summary, merge_digests,
    series)
from veles_tpu_torch.observe.trace import (  # noqa: F401
    CHUNK_SCHEMA_VERSION, SpanTracer, instant, span, traced, tracer,
    validate_trace)

__all__ = [
    "SpanTracer", "tracer", "span", "instant", "traced", "validate_trace",
    "CHUNK_SCHEMA_VERSION",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "percentiles", "health_snapshot",
    "FlightRecorder", "flight", "validate_flight",
    "FLIGHT_SCHEMA_VERSION",
    "TraceCollector", "estimate_offset", "probe_sample",
    "ExemplarRing", "exemplars", "mint_trace_id",
    "normalize_trace_id", "analyze_files", "render_requests",
    "SeriesRing", "FleetTelemetry", "series", "fleet_summary",
    "digest_values", "merge_digests", "digest_percentiles",
    "SERIES_SCHEMA_VERSION",
    "AlertManager", "BurnRateRule", "EmaSpikeRule", "alerts",
    "default_rules", "ALERTS_SCHEMA_VERSION",
]
