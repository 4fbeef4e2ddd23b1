"""Metrics registry: counters, gauges, and windowed histograms.

Counterpart of ``veles_tpu/observe/metrics.py`` (the serve tier's
receipts read it: ``serve_snapshot``, the QoS class counters, the SLO
watch, the router's per-replica gauges).  Observing a value is a lock
and a few attribute writes, so instrumented hot paths stay hot.

Device-scalar rule: values that live on the card (skip counters, grad
norms) enter the registry only as plain Python numbers that a path
already brought to the host; the registry never calls ``int()`` or
``float()`` on a tensor, so it never adds a host sync to a step.
"""

import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "percentiles", "health_snapshot",
           "snapshot_keys"]


def percentiles(samples, ps=(50, 95, 99)):
    """Nearest-rank percentiles of a sequence as ``{"p50": ...}``.

    Plain-Python so import-light callers (bench.py's slope spreads, the
    histogram snapshots) share ONE definition; on tiny sample sets the
    nearest-rank convention degrades gracefully (p95/p99 of 5 samples
    are both the max) instead of inventing interpolated values.
    """
    if not samples:
        return {}
    data = sorted(samples)
    n = len(data)
    return {"p%d" % p:
            data[max(0, min(n, int(math.ceil(p / 100.0 * n))) - 1)]
            for p in ps}


class Counter(object):
    """Monotonic counter (events, samples, protocol messages)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge(object):
    """Last-value metric (queue depth, budget remaining, epoch)."""

    __slots__ = ("name", "_value")

    def __init__(self, name):
        self.name = name
        self._value = None

    def set(self, value):
        self._value = value

    @property
    def value(self):
        return self._value


class Histogram(object):
    """Windowed distribution: lifetime count/sum plus a ring buffer of
    the most recent ``window`` observations for percentile queries."""

    __slots__ = ("name", "_lock", "_window", "_buf", "_pos",
                 "count", "total", "min", "max")

    def __init__(self, name, window=1024):
        self.name = name
        self._lock = threading.Lock()
        self._window = max(1, int(window))
        self.reset()

    def reset(self):
        with self._lock:
            self._buf = []
            self._pos = 0
            self.count = 0
            self.total = 0.0
            self.min = None
            self.max = None

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value
            if len(self._buf) < self._window:
                self._buf.append(value)
            else:
                self._buf[self._pos] = value
                self._pos = (self._pos + 1) % self._window

    def window_values(self):
        with self._lock:
            return list(self._buf)

    def recent(self, n):
        """The last ``min(n, window)`` observations in CHRONOLOGICAL
        order — the timeseries bucketizer (observe/timeseries.py)
        digests exactly the values that arrived since its previous
        tick, which the count delta names and the ring still holds as
        long as the tick interval outpaces ``window`` observations."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._buf) < self._window:
                buf = list(self._buf)
            else:
                buf = self._buf[self._pos:] + self._buf[:self._pos]
        return buf[-n:]

    def snapshot(self):
        """{"count","mean","min","max","p50","p95","p99"} — count/mean
        over the lifetime, percentiles over the recent window."""
        with self._lock:
            buf = list(self._buf)
            count, total = self.count, self.total
            lo, hi = self.min, self.max
        out = {"count": count,
               "mean": (total / count) if count else None,
               "min": lo, "max": hi}
        out.update(percentiles(buf))
        return out


class MetricsRegistry(object):
    """Named get-or-create store for the three metric kinds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, name, factory, kind):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = factory()
            elif not isinstance(metric, kind):
                raise TypeError(
                    "metric %r already registered as %s" %
                    (name, type(metric).__name__))
            return metric

    def counter(self, name):
        return self._get(name, lambda: Counter(name), Counter)

    def gauge(self, name):
        return self._get(name, lambda: Gauge(name), Gauge)

    def histogram(self, name, window=1024):
        return self._get(
            name, lambda: Histogram(name, window=window), Histogram)

    def peek(self, name):
        """The metric if it was ever registered, else None — readers
        (health_snapshot, dashboards) must not create empty metrics."""
        return self._metrics.get(name)

    def items(self):
        """Stable (name, metric) pairs of the LIVE objects — the
        timeseries bucketizer needs them (histogram count deltas +
        ``recent``), not the plain-data snapshot."""
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self):
        """Plain-data view: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count, mean, p50, ...}}}."""
        with self._lock:
            metrics = dict(self._metrics)
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, metric in sorted(metrics.items()):
            if isinstance(metric, Counter):
                out["counters"][name] = metric.value
            elif isinstance(metric, Gauge):
                if metric.value is not None:
                    out["gauges"][name] = metric.value
            else:
                out["histograms"][name] = metric.snapshot()
        return out

    def reset(self):
        """Drop every metric (tests / bench A-B legs start clean)."""
        with self._lock:
            self._metrics.clear()


#: The process-wide registry every subsystem publishes into.
registry = MetricsRegistry()

#: Health keys surfaced to dashboards: registry name -> short name.
_HEALTH_KEYS = (
    ("health.skip_count", "skip_count"),
    ("health.consecutive_skips", "consecutive_skips"),
    ("health.rollbacks_remaining", "rollbacks_remaining"),
    ("health.rollbacks", "rollbacks"),
    ("server.blacklist_size", "blacklist_size"),
    ("server.quarantined", "quarantined"),
    # elastic-fleet state (the parallel layer): membership epoch and
    # live fleet size ride heartbeats so a post-mortem can line up
    # divergence/skip events against membership changes; the full
    # fleet block (speculation + exactly-once accounting) is
    # elastic.fleet_snapshot() on the dashboard
    ("elastic.membership_epoch", "membership_epoch"),
    ("elastic.fleet_live", "fleet_live"),
    ("elastic.speculative_inflight", "speculative_inflight"),
    # multi-replica serving (serve/router.py): replica count,
    # aggregate queue depth and hot-reload count ride heartbeats so a
    # post-mortem can line up latency cliffs against reloads/cascades;
    # the full per-replica block is serve_snapshot() on the dashboard
    ("serve.replicas", "serve_replicas"),
    ("serve.queue_depth", "serve_queue_depth"),
    ("serve.reloads", "serve_reloads"),
    # train-to-serve freshness loop (serve/freshness.py):
    # publish/candidate/promotion/rollback/poison accounting rides
    # heartbeats so a post-mortem can line up a latency cliff or a
    # quality regression against the cutover that shipped it
    ("serve.freshness.published", "freshness_published"),
    ("serve.freshness.candidates", "freshness_candidates"),
    ("serve.freshness.promotions", "freshness_promotions"),
    ("serve.freshness.rollbacks", "freshness_rollbacks"),
    ("serve.freshness.poisoned_rejected", "freshness_poisoned"),
    # multi-host serve tier (serve/fleet.py): host
    # membership and the hedging/exactly-once accounting ride
    # heartbeats so a post-mortem can line up a p99 cliff against the
    # host loss (or the hedge storm) that caused it; the full
    # per-host block is FleetRouter.snapshot() on the dashboard
    ("serve.fleet.hosts_live", "fleet_hosts_live"),
    ("serve.fleet.membership_epoch", "fleet_membership_epoch"),
    ("serve.fleet.requeues", "fleet_requeues"),
    ("serve.hedge.fired", "hedges_fired"),
    ("serve.hedge.wins", "hedge_wins"),
    ("serve.hedge.duplicates_dropped", "hedge_duplicates_dropped"),
    # multi-tenant QoS (serve/qos.py): per-class served/shed
    # accounting and the hedge-budget exhaustion count ride heartbeats
    # so a post-mortem can see WHO an overload was shed onto — the
    # contract is all sheds land on best_effort/batch before a single
    # interactive request is touched; the full per-class block (with
    # latency percentiles) is serve_snapshot()["tenants"]
    ("serve.hedge.budget_exhausted", "hedge_budget_exhausted"),
    ("serve.tenant.interactive.requests", "tenant_interactive_requests"),
    ("serve.tenant.interactive.shed", "tenant_interactive_shed"),
    ("serve.tenant.batch.requests", "tenant_batch_requests"),
    ("serve.tenant.batch.shed", "tenant_batch_shed"),
    ("serve.tenant.best_effort.requests", "tenant_best_effort_requests"),
    ("serve.tenant.best_effort.shed", "tenant_best_effort_shed"),
    # request-scoped tracing (observe/requests.py): span-sampled and
    # tail-exemplar volume ride heartbeats so a p99 cliff can be lined
    # up against the request timelines captured for it; the full
    # per-segment latency block is serve_snapshot()["segments"]
    ("serve.reqtrace.sampled", "reqtrace_sampled"),
    ("serve.reqtrace.exemplars", "reqtrace_exemplars"),
    # fleet canary (FleetCanaryController):
    # host-sliced mirror volume and promote/rollback outcomes
    ("serve.fleet.canary.mirrors", "fleet_canary_mirrors"),
    ("serve.fleet.canary.promotions", "fleet_canary_promotions"),
    ("serve.fleet.canary.rollbacks", "fleet_canary_rollbacks"),
    # XLA introspection (observe/xla_introspect.py): live achieved-MFU
    # and compile accounting ride the same health surface
    ("xla.mfu_pct", "mfu_pct"),
    # backward attribution (docs/kernels.md): the fwd/bwd split next
    # to the whole-step MFU, refreshed by the same mfu_snapshot tick
    ("bwd.mfu_pct", "bwd_mfu_pct"),
    ("bwd.step_ms", "bwd_step_ms"),
    ("compile.count", "compiles"),
    ("compile.recompiles", "recompiles"),
    # schedule autotuner (tune/): cache traffic + candidate
    # evaluations ride heartbeats so a tuning run (or a cold cache on
    # a fresh pod) is visible in the same post-mortem surface; the
    # per-generation detail is the tune.generation trace spans
    ("tune.cache_hits", "tune_cache_hits"),
    ("tune.cache_misses", "tune_cache_misses"),
    ("tune.evals", "tune_evals"),
    # fleet schedule bank receipts: publishes (trainer), merges picked
    # up (serve/CLI), entries adopted across all merges
    ("tune.bank_published", "tune_bank_published"),
    ("tune.bank_merged", "tune_bank_merged"),
    ("tune.bank_entries", "tune_bank_entries"),
    # int8 quantized serving (quant/, docs/serving.md
    # "Quantized ladder"): whether this process serves a quantized
    # engine, and the calibration clip fraction — a clip fraction
    # drifting up between calibrations means the activation
    # distribution moved and the published scales are stale
    ("serve.quantized", "serve_quantized"),
    ("serve.quant.clip_fraction", "quant_clip_fraction"),
    # elastic device mesh (parallel.mesh.MeshManager, docs/
    # distributed.md "Elastic mesh contract"): current mesh size and
    # epoch, lifetime reshard count, and cumulative bytes of train
    # state moved — bytes_moved growing faster than reshards * the
    # changed-owner fraction means ownership is churning more than the
    # membership changes justify
    ("mesh.size", "mesh_size"),
    ("mesh.epoch", "mesh_epoch"),
    ("mesh.reshards", "mesh_reshards"),
    ("mesh.bytes_moved", "mesh_bytes_moved"),
    # fleet telemetry plane (observe/timeseries.py + alerts.py):
    # alert volume rides heartbeats so a post-mortem can line a
    # latency cliff up against the burn-rate firing that announced
    # it; the full alert-history ring is alerts.snapshot() on
    # /healthz and the dashboard
    ("alerts.fired", "alerts_fired"),
    ("alerts.active", "alerts_active"),
    ("telemetry.buckets", "telemetry_buckets"),
    ("telemetry.chunks_shipped", "telemetry_chunks_shipped"),
)


def snapshot_keys(keys, reg=None):
    """Flatten (registry name -> short name) pairs into a plain dict
    of published values.  Metrics never registered (peek keeps readers
    from creating empties) or still None are omitted — the shared
    backbone of health_snapshot and elastic.fleet_snapshot."""
    reg = reg if reg is not None else registry
    out = {}
    for name, short in keys:
        metric = reg.peek(name)
        if metric is not None and metric.value is not None:
            out[short] = metric.value
    return out


def health_snapshot(reg=None):
    """The numerics-health counters as a flat dict for the
    web-status posts and the heartbeat line: skip counts published by
    the decision unit at its class-end sync, rollback budget remaining
    by the snapshotter, blacklist/quarantine sizes by the server.
    Only counters that were actually published appear."""
    return snapshot_keys(_HEALTH_KEYS, reg)
