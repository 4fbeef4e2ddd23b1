"""Burn-rate SLO alerting over telemetry rollups.

Counterpart of ``veles_tpu/observe/alerts.py``, whole and stdlib-only.

The decisions half of the fleet telemetry plane: declarative alert rules
evaluated against the bucket series :mod:`observe.timeseries`
produces (a local SeriesRing's buckets or a FleetTelemetry rollup —
same shape, same rules).

Two rule kinds:

- :class:`BurnRateRule` — the multi-window burn-rate discipline for
  the per-class SLO budgets QoS defines (serve/qos.py).  The error
  budget is the fraction of requests ALLOWED over the class latency
  budget (``1 - objective``); the burn rate of a window is
  ``observed-over-budget-fraction / allowed-fraction``.  The rule
  fires only when the FAST window (reacts in seconds) AND the SLOW
  window (proves it is not a blip) both burn past ``factor`` — the
  fast window alone pages on noise, the slow window alone pages an
  hour late.
- :class:`EmaSpikeRule` — anomaly detection on a counter rate or
  gauge series, reusing ``health.EmaSpikeWatch`` verbatim (one spike
  definition across the watchdog, the canary judge, and alerting).

:class:`AlertManager` evaluates a rule set EDGE-TRIGGERED: the
transition into breach emits one firing — an ``alert.fired`` trace
instant, a flight-recorder dump carrying the alert record and the
tail-exemplar ring, a counter bump — and lands in a bounded
alert-history ring exposed via ``/healthz``.  While the breach holds,
nothing re-fires; the transition out appends a "resolved" record.
A broken rule can never take down a serve loop: rule evaluation
errors are swallowed per-rule.
"""

import threading
import time

from veles_tpu_torch.observe.timeseries import (digest_percentiles,
                                          merge_digests)

__all__ = ["ALERTS_SCHEMA_VERSION", "AlertRule", "BurnRateRule",
           "EmaSpikeRule", "AlertManager", "default_rules",
           "rule_from_spec", "alerts"]

ALERTS_SCHEMA_VERSION = 1


class AlertRule(object):
    """One named condition over a bucket series.  Subclasses
    implement ``evaluate(buckets) -> reason-string-or-None``;
    returning a reason means "in breach NOW" — the manager owns the
    edge detection."""

    kind = "rule"

    def __init__(self, name):
        self.name = str(name)

    def evaluate(self, buckets):
        raise NotImplementedError

    def spec(self):
        """The declarative form (the docs' rule format; soak receipts
        embed it so a firing names its exact condition)."""
        return {"name": self.name, "kind": self.kind}


class BurnRateRule(AlertRule):
    """Multi-window burn-rate pair over a latency histogram series.

    ``hist`` names the digest series (e.g.
    ``serve.tenant.interactive.latency_s``), ``budget_s`` the class
    latency budget, ``objective`` the fraction of requests that must
    land within it.  A window's burn rate is the observed
    over-budget fraction divided by the allowed fraction
    (``1 - objective``); the rule is in breach while BOTH the fast
    window (newest ``fast_buckets`` buckets) and the slow window
    (newest ``slow_buckets``) burn at >= ``factor``.  Windows with
    fewer than ``min_count`` observations abstain — an idle series
    must neither fire nor resolve-by-silence a firing based on one
    straggler."""

    kind = "burn_rate"

    def __init__(self, name, hist, budget_s, objective=0.99,
                 fast_buckets=3, slow_buckets=12, factor=2.0,
                 min_count=20):
        super(BurnRateRule, self).__init__(name)
        self.hist = str(hist)
        self.budget_s = float(budget_s)
        self.objective = float(objective)
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        self.fast_buckets = max(1, int(fast_buckets))
        self.slow_buckets = max(self.fast_buckets, int(slow_buckets))
        self.factor = float(factor)
        self.min_count = max(1, int(min_count))

    def window_burn(self, buckets):
        """Burn rate of one window, or None when the window lacks
        ``min_count`` observations."""
        merged = merge_digests(
            (bucket.get("hists") or {}).get(self.hist)
            for bucket in buckets)
        bins = merged["bins"]
        total = sum(bins.values())
        if total < self.min_count:
            return None
        from veles_tpu_torch.observe import timeseries as _ts
        # a bin is over budget when its UPPER edge exceeds the
        # budget: pessimistic by at most one bin width (~19%), which
        # errs toward paging — the same side the digest percentiles
        # take
        over = sum(n for key, n in bins.items()
                   if _ts._bin_edge(key) > self.budget_s)
        allowed = 1.0 - self.objective
        return (over / float(total)) / allowed

    def evaluate(self, buckets):
        buckets = list(buckets)
        fast = self.window_burn(buckets[-self.fast_buckets:])
        slow = self.window_burn(buckets[-self.slow_buckets:])
        if fast is None or slow is None:
            return None
        if fast >= self.factor and slow >= self.factor:
            p99 = digest_percentiles(merge_digests(
                (b.get("hists") or {}).get(self.hist)
                for b in buckets[-self.fast_buckets:]),
                ps=(99,)).get("p99")
            return ("%s burning %.1fx fast / %.1fx slow "
                    "(budget %.3fs @ %.2f%%, fast p99 %s)"
                    % (self.hist, fast, slow, self.budget_s,
                       100.0 * self.objective,
                       "%.3fs" % p99 if p99 is not None else "n/a"))
        return None

    def spec(self):
        return {"name": self.name, "kind": self.kind,
                "hist": self.hist, "budget_s": self.budget_s,
                "objective": self.objective,
                "fast_buckets": self.fast_buckets,
                "slow_buckets": self.slow_buckets,
                "factor": self.factor, "min_count": self.min_count}


class EmaSpikeRule(AlertRule):
    """EMA anomaly rule over a counter-rate or gauge series —
    ``health.EmaSpikeWatch`` pointed at telemetry buckets.  Buckets
    are consumed once each (tracked by ts), spiking values are NOT
    folded into the EMA, and the rule is in breach exactly while the
    NEWEST consumed bucket spiked."""

    kind = "ema_spike"

    def __init__(self, name, metric, metric_kind="counter",
                 field="rate", spike_factor=10.0, spike_floor=1.0,
                 beta=0.5):
        from veles_tpu_torch.health import EmaSpikeWatch
        super(EmaSpikeRule, self).__init__(name)
        self.metric = str(metric)
        self.metric_kind = metric_kind
        self.field = field
        self._watch = EmaSpikeWatch(spike_factor=spike_factor,
                                    spike_floor=spike_floor,
                                    beta=beta, label=self.metric)
        self._seen_ts = None
        self._breach = None

    def _value(self, bucket):
        if self.metric_kind == "gauge":
            value = (bucket.get("gauges") or {}).get(self.metric)
        else:
            entry = (bucket.get("counters") or {}).get(self.metric)
            value = (entry or {}).get(self.field)
            if value is None and entry is None:
                # an absent counter in a ticked bucket means zero
                # events, not missing data — feed the 0 so a burst
                # after silence still spikes against a real baseline
                value = 0.0
        if isinstance(value, bool) or not isinstance(value,
                                                     (int, float)):
            return None
        return float(value)

    def evaluate(self, buckets):
        for bucket in buckets:
            ts = bucket.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            if self._seen_ts is not None and ts <= self._seen_ts:
                continue
            self._seen_ts = ts
            value = self._value(bucket)
            if value is None:
                continue
            self._breach = self._watch.update(value)
        return self._breach

    def spec(self):
        return {"name": self.name, "kind": self.kind,
                "metric": self.metric,
                "metric_kind": self.metric_kind, "field": self.field,
                "spike_factor": self._watch.spike_factor,
                "spike_floor": self._watch.spike_floor,
                "beta": self._watch.beta}


def rule_from_spec(spec):
    """Build a rule from its declarative dict (the docs' format; what
    soak configs and saved rule sets round-trip through)."""
    kind = spec.get("kind")
    if kind == "burn_rate":
        return BurnRateRule(
            spec["name"], spec["hist"], spec["budget_s"],
            objective=spec.get("objective", 0.99),
            fast_buckets=spec.get("fast_buckets", 3),
            slow_buckets=spec.get("slow_buckets", 12),
            factor=spec.get("factor", 2.0),
            min_count=spec.get("min_count", 20))
    if kind == "ema_spike":
        return EmaSpikeRule(
            spec["name"], spec["metric"],
            metric_kind=spec.get("metric_kind", "counter"),
            field=spec.get("field", "rate"),
            spike_factor=spec.get("spike_factor", 10.0),
            spike_floor=spec.get("spike_floor", 1.0),
            beta=spec.get("beta", 0.5))
    raise ValueError("unknown alert rule kind %r" % (kind,))


def default_rules(budgets=None, objective=0.99, fast_buckets=3,
                  slow_buckets=12, factor=2.0, min_count=20,
                  scope="tenant"):
    """The stock serve rule set: one burn-rate pair per QoS class
    (budgets from serve/qos.py — override with a
    ``{class: budget_s}`` map) plus EMA anomaly rules on queue depth
    and fleet failures.  ``scope="fleet"`` points the burn rules at
    the fleet front's end-to-end class histograms instead of the
    host serving-edge ones (see ``qos.burn_rule_specs``)."""
    from veles_tpu_torch.serve import qos
    rules = [rule_from_spec(spec) for spec in qos.burn_rule_specs(
        budgets=budgets, objective=objective,
        fast_buckets=fast_buckets, slow_buckets=slow_buckets,
        factor=factor, min_count=min_count, scope=scope)]
    rules.append(EmaSpikeRule(
        "queue_depth_spike", "serve.queue_depth",
        metric_kind="gauge", spike_factor=8.0, spike_floor=64.0))
    rules.append(EmaSpikeRule(
        "fleet_failures_spike", "serve.fleet.failed",
        metric_kind="counter", spike_factor=8.0, spike_floor=1.0))
    return rules


class AlertManager(object):
    """Edge-triggered evaluation of a rule set over bucket series,
    with a bounded alert-history ring.

    One manager instance per decision point (the process-global
    ``alerts`` for single-process serving, a FleetRouter's own for
    fleet rollups) — history and active state are per-manager, the
    ``alerts.fired``/``alerts.active`` metrics are shared."""

    def __init__(self, rules=(), history=64, registry=None):
        from veles_tpu_torch.observe import metrics as _metrics
        import collections
        self.rules = list(rules)
        self._registry = registry if registry is not None \
            else _metrics.registry
        self._lock = threading.Lock()
        self._active = {}
        self._history = collections.deque(maxlen=max(1, int(history)))
        self._fired_total = 0

    def add_rule(self, rule):
        with self._lock:
            self.rules.append(rule)
        return rule

    def configure(self, specs):
        """Replace the rule set from declarative specs."""
        rules = [rule_from_spec(s) for s in specs]
        with self._lock:
            self.rules = rules
            self._active.clear()
        return rules

    def evaluate(self, buckets, wall=None, dump=True, context=None):
        """Sweep every rule against ``buckets``; returns the list of
        NEWLY-fired alert records (empty while steady or while a
        breach merely persists)."""
        buckets = list(buckets)
        wall = time.time() if wall is None else wall
        fired = []
        resolved = []
        with self._lock:
            rules = list(self.rules)
        for rule in rules:
            try:
                reason = rule.evaluate(buckets)
            except Exception:
                # a broken rule must never take down the loop that
                # evaluates it; it simply abstains
                reason = None
            with self._lock:
                active = self._active.get(rule.name)
                if reason and active is None:
                    record = {"alert": rule.name, "state": "firing",
                              "ts": wall, "reason": str(reason),
                              "rule": rule.spec()}
                    if context:
                        record["context"] = context
                    self._active[rule.name] = record
                    self._history.append(dict(record))
                    self._fired_total += 1
                    fired.append(record)
                elif reason and active is not None:
                    active["reason"] = str(reason)  # still burning
                elif not reason and active is not None:
                    self._active.pop(rule.name, None)
                    record = {"alert": rule.name, "state": "resolved",
                              "ts": wall, "fired_ts": active["ts"]}
                    self._history.append(record)
                    resolved.append(record)
        try:
            reg = self._registry
            if fired:
                reg.counter("alerts.fired").inc(len(fired))
            reg.gauge("alerts.active").set(len(self._active))
        except Exception:
            pass
        for record in fired:
            self._announce(record, dump=dump)
        for record in resolved:
            self._announce_resolved(record)
        return fired

    def _announce(self, record, dump=True):
        """One firing's evidence trail: trace instant + flight dump
        carrying the alert record and the tail-exemplar ring.  Never
        raises."""
        try:
            from veles_tpu_torch.observe.trace import tracer
            if tracer.active:
                tracer.instant("alert.fired", cat="alerts",
                               alert=record["alert"],
                               reason=record["reason"])
        except Exception:
            pass
        if not dump:
            return
        try:
            from veles_tpu_torch.observe import requests as reqtrace
            from veles_tpu_torch.observe.flight import flight
            path = flight.dump("alert.%s" % record["alert"],
                               extra={"alert": record,
                                      "exemplars":
                                          reqtrace.exemplars.snapshot()})
            if path:
                # the active record (shared with the evaluate() return
                # value and the /healthz "firing" block) names its own
                # evidence file
                record["flight_dump"] = path
        except Exception:
            pass

    def _announce_resolved(self, record):
        try:
            from veles_tpu_torch.observe.trace import tracer
            if tracer.active:
                tracer.instant("alert.resolved", cat="alerts",
                               alert=record["alert"])
        except Exception:
            pass

    def active(self):
        with self._lock:
            return [dict(r) for r in self._active.values()]

    def history(self, last=None):
        with self._lock:
            out = list(self._history)
        if last is not None and last > 0:
            out = out[-int(last):]
        return out

    def snapshot(self, history=16):
        """The /healthz + heartbeat ``alerts`` block."""
        with self._lock:
            active = [dict(r) for r in self._active.values()]
            tail = list(self._history)[-max(0, int(history)):]
            fired = self._fired_total
        return {"schema": ALERTS_SCHEMA_VERSION,
                "active": sorted(r["alert"] for r in active),
                "firing": active,
                "fired_total": fired,
                "history": tail}

    def clear(self):
        """Reset state AND rules (test isolation)."""
        with self._lock:
            self.rules = []
            self._active.clear()
            self._history.clear()
            self._fired_total = 0
        try:
            self._registry.gauge("alerts.active").set(0)
        except Exception:
            pass


#: The process-wide manager: empty (zero-cost) until a rule set is
#: installed — the serve service/launcher install ``default_rules``,
#: a FleetRouter keeps its OWN manager for fleet rollups.
alerts = AlertManager()
