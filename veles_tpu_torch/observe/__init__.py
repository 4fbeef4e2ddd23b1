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
  rules, edge-triggered, with flight and exemplar dumps;
- :mod:`~veles_tpu_torch.observe.introspect`: the counterpart of
  ``xla_introspect``: compiles (kernel-library builds and CUDA-graph
  captures), device-memory gauges and the live ``mfu_pct`` from the
  analytic FLOPs of a step and its CUDA-event time;
- :mod:`~veles_tpu_torch.observe.profile`: ``torch.profiler`` around a
  window of train steps (``VELES_PROFILE`` / ``VELES_PROFILE_WINDOW``)
  and the JSONL ``Heartbeat`` (``--metrics-interval``);
- :mod:`~veles_tpu_torch.observe.summary`: textual digests of traces,
  flight dumps and heartbeat files;
- :mod:`~veles_tpu_torch.observe.baseline`: the perf-regression
  sentinel, against the port's own ``PERF_BASELINE_TORCH.json``.

``python -m veles_tpu_torch.observe`` runs ``merge``, ``summary``,
``requests``, ``fleet`` and ``regress``.
"""

from veles_tpu_torch.observe.alerts import (  # noqa: F401
    ALERTS_SCHEMA_VERSION, AlertManager, BurnRateRule, EmaSpikeRule,
    alerts, default_rules)
from veles_tpu_torch.observe.baseline import (  # noqa: F401
    gate, load_baseline, steady_state_rates)
from veles_tpu_torch.observe.cluster import (  # noqa: F401
    TraceCollector, estimate_offset, probe_sample)
from veles_tpu_torch.observe.flight import (  # noqa: F401
    FLIGHT_SCHEMA_VERSION, FlightRecorder, flight, validate_flight)
from veles_tpu_torch.observe.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, health_snapshot,
    percentiles, registry)
from veles_tpu_torch.observe.profile import (  # noqa: F401
    HEARTBEAT_SCHEMA_VERSION, Heartbeat, ProfilerHook, install_profiler,
    profiler_step, uninstall_profiler, validate_heartbeat)
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
    "ProfilerHook", "install_profiler", "uninstall_profiler",
    "profiler_step", "Heartbeat", "validate_heartbeat",
    "HEARTBEAT_SCHEMA_VERSION",
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
    "gate", "load_baseline", "steady_state_rates",
]
