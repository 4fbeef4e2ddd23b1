"""The port's fleet telemetry plane (veles_tpu_torch/observe/timeseries.py
and alerts.py) against the JAX package's, on the CPU.

- The cases of tests/test_telemetry.py on the port: digests (shape, NaN
  safety, percentile bounds, bin-wise merge), the series ring (bucket
  semantics, counter resets, the interval), ``take_chunk`` and the
  fleet's seq dedup, offset-corrected rollups, the min-delay probe
  offset, the burn-rate truth table, spec round trips, the EMA spike
  rule, the stock rule sets and the alert manager's edge-triggered
  lifecycle with its flight and exemplar dump.
- The same inputs through both packages give equal digests,
  percentiles, buckets, chunks, rollups, summaries, offsets and rule
  verdicts; a chunk of either package's ``take_chunk`` merges in the
  other's ``FleetTelemetry``; JAX's ``validate_flight`` accepts the
  port's alert dump.
"""

import importlib
import json

import pytest

from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu.observe import metrics as jax_metrics
from veles_tpu.observe import timeseries as jax_ts
from veles_tpu_torch.observe import metrics as port_metrics
from veles_tpu_torch.observe.alerts import (AlertManager, BurnRateRule,
                                            EmaSpikeRule, default_rules,
                                            rule_from_spec)
from veles_tpu_torch.observe.metrics import MetricsRegistry
from veles_tpu_torch.observe import timeseries as port_ts
from veles_tpu_torch.observe.timeseries import (
    DIGEST_BASE, FleetTelemetry, SERIES_SCHEMA_VERSION, SeriesRing,
    digest_percentiles, digest_values, fleet_summary, merge_digests)

pytestmark = [pytest.mark.observe, pytest.mark.telemetry]

# the package's ``alerts`` name is the manager singleton, not the module
jax_alerts = importlib.import_module("veles_tpu.observe.alerts")

#: (timeseries module, metrics module) of each package
PACKAGES = {"port": (port_ts, port_metrics), "jax": (jax_ts, jax_metrics)}

VALUE_SETS = [
    [0.010, 0.020, 0.040, float("nan"), float("inf"), 0.0, -1.0],
    [0.001 * (i + 1) for i in range(1000)],
    [0.123],
    [0.010] * 90 + [0.020] * 10 + [0.200] * 90 + [0.400] * 10,
    [1e-9, 1e-3, 1.0, 1e3, 5e6],
]


# -- digests ----------------------------------------------------------------


def test_digest_values_shape_and_nan_safety():
    d = digest_values([0.010, 0.020, 0.040, float("nan"),
                       float("inf"), 0.0, -1.0])
    assert d["count"] == 5
    assert d["min"] == -1.0 and d["max"] == 0.040
    assert d["bins"].get("z") == 2
    assert sum(d["bins"].values()) == d["count"]
    assert d["sum"] == pytest.approx(0.010 + 0.020 + 0.040 - 1.0)


def test_digest_percentiles_bounded_by_bin_width():
    values = [0.001 * (i + 1) for i in range(1000)]
    pcts = digest_percentiles(digest_values(values))
    for p, exact in (("p50", 0.500), ("p95", 0.950), ("p99", 0.990)):
        assert exact <= pcts[p] <= exact * DIGEST_BASE * 1.0001
    assert digest_percentiles(digest_values([0.123]))["p99"] == 0.123
    assert digest_percentiles({"bins": {}}) == {}


def test_merge_digests_is_a_mixture():
    fast = digest_values([0.010] * 90 + [0.020] * 10)
    slow = digest_values([0.200] * 90 + [0.400] * 10)
    merged = merge_digests([fast, None, "junk", slow])
    assert merged["count"] == fast["count"] + slow["count"]
    assert merged["min"] == fast["min"]
    assert merged["max"] == slow["max"]
    m, f, s = (digest_percentiles(d) for d in (merged, fast, slow))
    for p in ("p50", "p99"):
        assert min(f[p], s[p]) <= m[p] <= max(f[p], s[p])


@pytest.mark.parametrize("index", range(len(VALUE_SETS)))
def test_digests_and_percentiles_equal_jax(index):
    values = VALUE_SETS[index]
    got = digest_values(values)
    want = jax_ts.digest_values(values)
    assert got == want
    assert digest_percentiles(got) == jax_ts.digest_percentiles(want)
    halves = [digest_values(values[::2]), digest_values(values[1::2])]
    assert merge_digests(halves) == jax_ts.merge_digests(
        [jax_ts.digest_values(values[::2]),
         jax_ts.digest_values(values[1::2])])
    assert DIGEST_BASE == jax_ts.DIGEST_BASE


# -- series ring ------------------------------------------------------------


def _ring_script(package):
    """One scripted registry history through a package's ring: every
    bucket it published and its chunk."""
    ts, metrics = PACKAGES[package]
    reg = metrics.MetricsRegistry()
    ring = ts.SeriesRing(interval_s=1.0, registry=reg)
    out = []
    reg.counter("req").inc(100)
    reg.gauge("depth").set(3)
    reg.histogram("lat").observe(0.010)
    out.append(ring.tick(now=10.0, wall=1000.0))
    reg.counter("req").inc(8)
    reg.gauge("depth").set(7)
    reg.histogram("lat").observe(0.020)
    reg.histogram("lat").observe(0.040)
    out.append(ring.tick(now=14.0, wall=1004.0))
    out.append(ring.tick(now=15.0, wall=1005.0))
    reg.reset()
    reg.counter("req").inc(3)
    out.append(ring.tick(now=17.0, wall=1007.0))
    out.append(ring.maybe_tick(now=17.5))
    out.append(ring.take_chunk(label="h0"))
    out.append(ring.take_chunk())
    return out


def test_series_ring_bucket_semantics():
    reg = MetricsRegistry()
    ring = SeriesRing(interval_s=1.0, registry=reg)
    reg.counter("req").inc(100)
    reg.gauge("depth").set(3)
    reg.histogram("lat").observe(0.010)
    assert ring.tick(now=10.0, wall=1000.0) is None
    reg.counter("req").inc(8)
    reg.gauge("depth").set(7)
    reg.histogram("lat").observe(0.020)
    reg.histogram("lat").observe(0.040)
    bucket = ring.tick(now=14.0, wall=1004.0)
    assert bucket["seq"] == 0 and bucket["ts"] == 1004.0
    assert bucket["counters"]["req"] == {"delta": 8, "rate": 2.0}
    assert bucket["gauges"]["depth"] == 7
    hist = bucket["hists"]["lat"]
    assert hist["count"] == 2
    assert hist["min"] == 0.020 and hist["max"] == 0.040
    bucket = ring.tick(now=15.0, wall=1005.0)
    assert bucket["counters"]["req"] == {"delta": 0, "rate": 0.0}
    assert "lat" not in bucket["hists"]


def test_series_ring_counter_reset_and_maybe_tick_cadence():
    reg = MetricsRegistry()
    ring = SeriesRing(interval_s=1.0, registry=reg)
    reg.counter("req").inc(50)
    ring.tick(now=0.0, wall=100.0)
    reg.reset()
    reg.counter("req").inc(3)
    bucket = ring.tick(now=2.0, wall=102.0)
    assert bucket["counters"]["req"]["delta"] == 3
    assert ring.maybe_tick(now=2.5) is None
    assert ring.maybe_tick(now=3.1) is not None


def test_series_ring_buckets_and_chunks_equal_jax():
    assert _ring_script("port") == _ring_script("jax")


def test_take_chunk_cursor_and_fleet_dedup():
    reg = MetricsRegistry()
    ring = SeriesRing(interval_s=1.0, registry=reg)
    reg.counter("req").inc(1)
    ring.tick(now=0.0, wall=100.0)
    for i in range(3):
        reg.counter("req").inc(1)
        ring.tick(now=1.0 + i, wall=101.0 + i)
    chunk = ring.take_chunk(label="h0")
    assert chunk["schema"] == SERIES_SCHEMA_VERSION
    assert [b["seq"] for b in chunk["buckets"]] == [0, 1, 2]
    assert ring.take_chunk() is None
    fleet = FleetTelemetry(interval_s=1.0)
    assert fleet.add_chunk("h0", chunk)
    assert not fleet.add_chunk("h0", ring.snapshot(label="h0"))
    assert len(fleet.host_buckets("h0")) == 3
    assert fleet.dropped == 0
    assert not fleet.add_chunk("h0", {"schema": 99, "buckets": []})
    assert not fleet.add_chunk("h0", "garbage")
    assert fleet.dropped == 2


def _host_chunk(package, host, wall0, latencies, reqs=10):
    ts, metrics = PACKAGES[package]
    reg = metrics.MetricsRegistry()
    ring = ts.SeriesRing(interval_s=1.0, registry=reg)
    ring.tick(now=0.0, wall=wall0)
    reg.counter("req").inc(reqs)
    reg.gauge("depth").set(reqs)
    for value in latencies:
        reg.histogram("lat").observe(value)
    ring.tick(now=1.0, wall=wall0 + 1.0)
    return ring.take_chunk(label=host)


def test_fleet_rollup_offset_corrected_merge():
    fleet = FleetTelemetry(interval_s=1.0)
    fleet.add_chunk("h0", _host_chunk("port", "h0", 1000.0,
                                      [0.010] * 20, reqs=10))
    fleet.add_chunk("h1", _host_chunk("port", "h1", 1500.0,
                                      [0.200] * 20, reqs=30))
    fleet.set_offset("h1", -500.0)
    cells = fleet.rollup()
    assert len(cells) == 1
    cell = cells[0]
    assert cell["hosts"] == ["h0", "h1"]
    assert cell["counters"]["req"]["delta"] == 40
    assert cell["gauges"]["depth"] == 30
    assert cell["hists"]["lat"]["count"] == 40
    table = fleet_summary(cells)
    assert table["hists"]["lat"]["count"] == 40
    assert 0.010 <= table["hists"]["lat"]["p50"] <= 0.200 * DIGEST_BASE
    fleet.set_offset("h1", 0.0)
    assert len(fleet.rollup()) == 2


@pytest.mark.parametrize("sources", [("port", "jax"), ("jax", "port"),
                                     ("jax", "jax")])
def test_chunks_merge_across_packages_and_rollups_equal_jax(sources):
    """Either package's chunks (h0 from one, h1 from the other) merge in
    either package's FleetTelemetry; the port's rollup and summary equal
    JAX's on the same chunks."""
    chunks = {"h0": _host_chunk(sources[0], "h0", 1000.0,
                                [0.010] * 20 + [0.030] * 5, reqs=10),
              "h1": _host_chunk(sources[1], "h1", 1500.0,
                                [0.200] * 20, reqs=30)}
    results = []
    for telemetry in (FleetTelemetry(interval_s=1.0),
                      jax_ts.FleetTelemetry(interval_s=1.0)):
        for host, chunk in chunks.items():
            assert telemetry.add_chunk(host, chunk)
        telemetry.add_probe("h1", (100.0, -399.8, -399.7, 100.2))
        cells = telemetry.rollup()
        results.append((cells, telemetry.offset("h1"),
                        fleet_summary(cells),
                        jax_ts.fleet_summary(cells)))
    assert results[0] == results[1]
    assert len(results[0][0]) == 1
    assert results[0][1] == pytest.approx(-499.85)


def test_add_probe_min_delay_offset_estimate():
    fleet = FleetTelemetry()
    fleet.add_probe("h0", (100.0, 105.2, 105.3, 100.6))
    noisy = fleet.offset("h0")
    fleet.add_probe("h0", (200.0, 205.05, 205.06, 200.11))
    assert fleet.offset("h0") == pytest.approx(5.0, abs=1e-9)
    assert abs(fleet.offset("h0") - 5.0) <= abs(noisy - 5.0)
    fleet.add_probe("h0", ("junk",))
    fleet.add_probe("h0", (1.0, float("nan"), 2.0, 3.0))
    assert fleet.offset("h0") == pytest.approx(5.0, abs=1e-9)


def test_probe_offsets_equal_jax():
    probes = [(100.0, 105.2, 105.3, 100.6), (200.0, 205.05, 205.06, 200.11),
              (300.0, 304.9, 305.0, 300.3), ("junk",),
              (1.0, float("nan"), 2.0, 3.0)] + [
        (400.0 + i, 405.0 + i + 0.001 * i, 405.01 + i + 0.001 * i,
         400.05 + i) for i in range(12)]
    port, jax = FleetTelemetry(), jax_ts.FleetTelemetry()
    for sample in probes:
        port.add_probe("h0", sample)
        jax.add_probe("h0", sample)
        assert port.offset("h0") == jax.offset("h0")


# -- alert rules ------------------------------------------------------------


def _lat_bucket(ts, values, digest=digest_values):
    return {"ts": ts, "dur_s": 1.0, "counters": {}, "gauges": {},
            "hists": {"lat": digest(values)}}


def test_burn_rate_truth_table():
    rule = BurnRateRule("burn", "lat", 0.100, objective=0.9,
                        fast_buckets=1, slow_buckets=4, factor=3.0,
                        min_count=5)
    over = [0.500] * 10
    under = [0.010] * 10
    assert rule.evaluate([_lat_bucket(t, over) for t in range(4)])
    assert rule.evaluate(
        [_lat_bucket(t, under) for t in range(4)]) is None
    hist = [_lat_bucket(t, over) for t in range(3)] + \
        [_lat_bucket(3, under)]
    assert rule.evaluate(hist) is None
    fresh = [_lat_bucket(t, under) for t in range(3)] + \
        [_lat_bucket(3, over)]
    assert rule.evaluate(fresh) is None
    assert rule.evaluate([_lat_bucket(0, [0.500])]) is None
    assert rule.window_burn([_lat_bucket(0, [0.500] * 4)]) is None


_HISTORIES = [
    [[0.500] * 10] * 4,
    [[0.010] * 10] * 4,
    [[0.500] * 10] * 3 + [[0.010] * 10],
    [[0.010] * 10] * 3 + [[0.500] * 10],
    [[0.500]],
    [[0.150] * 6 + [0.010] * 4, [0.120] * 3 + [0.010] * 7,
     [0.500] * 2 + [0.050] * 8, [0.300] * 9 + [0.010]],
]


@pytest.mark.parametrize("index", range(len(_HISTORIES)))
def test_burn_rate_verdicts_equal_jax(index):
    spec = dict(objective=0.9, fast_buckets=1, slow_buckets=4,
                factor=3.0, min_count=5)
    port = BurnRateRule("burn", "lat", 0.100, **spec)
    jax = jax_alerts.BurnRateRule("burn", "lat", 0.100, **spec)
    history = _HISTORIES[index]
    got = port.evaluate([_lat_bucket(t, v)
                         for t, v in enumerate(history)])
    want = jax.evaluate([_lat_bucket(t, v, jax_ts.digest_values)
                         for t, v in enumerate(history)])
    assert got == want
    assert port.spec() == jax.spec()


def test_burn_rate_spec_round_trip():
    rule = BurnRateRule("burn", "lat", 0.100, objective=0.95,
                        fast_buckets=2, slow_buckets=8, factor=4.0,
                        min_count=7)
    clone = rule_from_spec(rule.spec())
    assert clone.spec() == rule.spec()
    assert jax_alerts.rule_from_spec(rule.spec()).spec() == rule.spec()
    with pytest.raises(ValueError):
        rule_from_spec({"kind": "astrology"})


def _spike_buckets():
    def bucket(ts, rate):
        return {"ts": ts, "counters": {"err": {"delta": rate,
                                               "rate": rate}},
                "gauges": {}, "hists": {}}
    steady = [bucket(float(t), 2.0) for t in range(6)]
    return steady, bucket


def test_ema_spike_rule_consumes_buckets_once():
    rule = EmaSpikeRule("errs", "err", spike_factor=10.0,
                        spike_floor=1.0, beta=0.5)
    steady, bucket = _spike_buckets()
    assert rule.evaluate(steady) is None
    assert rule.evaluate(steady + [bucket(6.0, 200.0)])
    assert rule.evaluate(steady + [bucket(6.0, 200.0)])
    assert rule.evaluate(steady + [bucket(6.0, 200.0),
                                   bucket(7.0, 2.0)]) is None


def test_ema_spike_verdicts_equal_jax():
    steady, bucket = _spike_buckets()
    rules = [EmaSpikeRule("errs", "err", spike_factor=10.0,
                          spike_floor=1.0, beta=0.5),
             jax_alerts.EmaSpikeRule("errs", "err", spike_factor=10.0,
                                     spike_floor=1.0, beta=0.5)]
    for history in (steady, steady + [bucket(6.0, 200.0)],
                    steady + [bucket(6.0, 200.0)],
                    steady + [bucket(6.0, 200.0), bucket(7.0, 2.0)],
                    steady + [bucket(6.0, 200.0), bucket(7.0, 2.0),
                              bucket(8.0, 30.0)]):
        got, want = (rule.evaluate(history) for rule in rules)
        assert got == want


def test_default_rules_tenant_vs_fleet_scope_equal_jax():
    tenant = {r.name: r for r in default_rules()}
    assert "slo_burn.interactive" in tenant
    assert tenant["slo_burn.interactive"].hist == \
        "serve.tenant.interactive.latency_s"
    assert "queue_depth_spike" in tenant
    assert "fleet_failures_spike" in tenant
    fleet = {r.name: r for r in default_rules(scope="fleet")}
    assert fleet["slo_burn.fleet.interactive"].hist == \
        "serve.fleet.interactive.latency_s"
    for scope in ("tenant", "fleet"):
        got = [r.spec() for r in default_rules(scope=scope)]
        want = [r.spec() for r in jax_alerts.default_rules(scope=scope)]
        assert got == want


# -- alert manager ----------------------------------------------------------


def test_alert_manager_edge_triggered_lifecycle(tmp_path):
    from veles_tpu.observe.flight import validate_flight as jax_validate
    from veles_tpu_torch.observe.flight import flight
    prev_enabled = flight.enabled
    flight.enabled = True
    try:
        manager = AlertManager([BurnRateRule(
            "burn", "lat", 0.100, objective=0.9, fast_buckets=1,
            slow_buckets=2, factor=2.0, min_count=5)])
        burning = [_lat_bucket(t, [0.500] * 10) for t in range(2)]
        fired = manager.evaluate(burning, wall=100.0,
                                 context={"scope": "test"})
        assert [r["alert"] for r in fired] == ["burn"]
        assert fired[0]["context"] == {"scope": "test"}
        assert manager.evaluate(burning, wall=101.0) == []
        assert manager.snapshot()["active"] == ["burn"]
        dump = fired[0].get("flight_dump")
        assert dump and dump.startswith(str(tmp_path))
        with open(dump) as fh:
            doc = json.load(fh)
        jax_validate(doc)
        assert doc["alert"]["alert"] == "burn"
        assert "exemplars" in doc
        calm = [_lat_bucket(t, [0.010] * 10) for t in range(2)]
        assert manager.evaluate(calm, wall=102.0) == []
        states = [(r["alert"], r["state"]) for r in manager.history()]
        assert states == [("burn", "firing"), ("burn", "resolved")]
        snap = manager.snapshot()
        assert snap["fired_total"] == 1 and snap["active"] == []
        assert len(manager.evaluate(burning, wall=103.0)) == 1
    finally:
        flight.enabled = prev_enabled


def test_alert_manager_broken_rule_abstains():
    class Broken(BurnRateRule):
        def evaluate(self, buckets):
            raise RuntimeError("boom")

    manager = AlertManager([
        Broken("broken", "lat", 0.1),
        BurnRateRule("burn", "lat", 0.100, objective=0.9,
                     fast_buckets=1, slow_buckets=2, factor=2.0,
                     min_count=5)])
    burning = [_lat_bucket(t, [0.500] * 10) for t in range(2)]
    fired = manager.evaluate(burning, dump=False)
    assert [r["alert"] for r in fired] == ["burn"]


def test_alert_records_equal_jax_on_the_same_sweeps():
    """Both managers over the same rule and bucket sweeps fire and
    resolve at the same sweeps with the same records (the flight dump
    path aside)."""
    spec = dict(objective=0.9, fast_buckets=1, slow_buckets=2,
                factor=2.0, min_count=5)
    port = AlertManager([BurnRateRule("burn", "lat", 0.1, **spec)])
    jax = jax_alerts.AlertManager([jax_alerts.BurnRateRule(
        "burn", "lat", 0.1, **spec)])
    sweeps = [[0.500] * 10, [0.500] * 10, [0.010] * 10, [0.010] * 10,
              [0.500] * 10, [0.500] * 10]
    for i in range(1, len(sweeps)):
        window = sweeps[max(0, i - 1):i + 1]
        got = port.evaluate([_lat_bucket(t, v)
                             for t, v in enumerate(window)],
                            wall=100.0 + i, dump=False)
        want = jax.evaluate([_lat_bucket(t, v, jax_ts.digest_values)
                             for t, v in enumerate(window)],
                            wall=100.0 + i, dump=False)
        assert got == want
    assert port.history() == jax.history()
    snap, jsnap = port.snapshot(), jax.snapshot()
    assert snap == jsnap
