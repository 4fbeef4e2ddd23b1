"""The training side's telemetry hooks in the port (models/fused.py,
models/decision.py, snapshotter.py, pipeline_input.py, units.py,
workflow.py, launcher.py) on the CPU, against the JAX package's:

- a small fused run through the launcher with ``--trace`` and the
  heartbeat (tests/test_observe.py's smoke run, rebuilt on the port)
  emits the JAX run's span names and categories, its heartbeat keys and
  its registry's metric names.  Differences, each with its reason:
  JAX's run also counts XLA compiles (``compile.*``, the ``xla.compile``
  instants), which a CPU run of the port has none of (a capture happens
  only on the card); the port's ``compile`` heartbeat block also splits
  its count into ``captures`` and ``kernel_builds``;
- with the tracer off, a fused run records no event and a disabled
  tracer stays cheap (80,000 calls, as for PR 20's serve spans);
- the decision never publishes a non-finite metric gauge, and publishes
  the health counters and the epoch;
- a sustained-NaN run (tests/test_torch_health.py's) gives JAX's
  rollback counters, gauges, ``snapshot.rollback`` instants and flight
  dumps; an export counts ``snapshot.exports`` / ``snapshot.write_s``
  with a ``snapshot.export`` span; the publishes mark their instants;
- the ``StepClock`` resolves CUDA-event step times off the step path
  (a fake event stands in on the CPU): intervals within one class,
  none across a class switch or over a capture, completed events only,
  a bounded ring;
- a fused trainer on the card's bookkeeping (tests/test_torch_graphs.
  FakeGraphs) watches its owner's "step" and "eval" captures, and
  publishes its step FLOPs once.
"""

import json
import time

import pytest

from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch.observe.metrics import registry
from veles_tpu_torch.observe.trace import SpanTracer, tracer

LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 16,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "softmax", "output_sample_shape": 4,
     "learning_rate": 0.05, "gradient_moment": 0.9},
]


def _port_smoke_run(tmp_path, pipeline=True):
    """tests/test_observe._trace_smoke_run on the port: a 2-epoch fused
    run through the launcher with ``--trace`` and the heartbeat."""
    from tests.test_torch_pipeline_input import Blobs
    from veles_tpu_torch import prng

    class BlobsLoader(Blobs):
        """The JAX run's loader, by name too: a unit span is named so."""

    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    trace_path = str(tmp_path / "port_trace.json")
    hb_path = str(tmp_path / "port_hb.jsonl")
    prng.get().seed(321)
    launcher = Launcher(trace=trace_path, metrics_interval=0.05,
                        metrics_path=hb_path)
    StandardWorkflow(
        launcher, layers=[dict(spec) for spec in LAYERS],
        loader_factory=lambda w: BlobsLoader(
            w, minibatch_size=32, on_device=False,
            prng=prng.RandomGenerator("observe", seed=11)),
        decision_config=dict(max_epochs=2)).fuse(pipeline=pipeline)
    launcher.initialize(device=Device(backend="cpu"))
    launcher.run()
    with open(trace_path) as fin:
        doc = json.load(fin)
    with open(hb_path) as fin:
        lines = [json.loads(line) for line in fin if line.strip()]
    return doc, lines, launcher.workflow


def _spans(doc):
    return {(e["name"], e["cat"]) for e in doc["traceEvents"]
            if e["ph"] == "X"}


def _tids(doc, name):
    return {e["tid"] for e in doc["traceEvents"]
            if e["ph"] == "X" and e["name"] == name}


#: heartbeat and registry names only the JAX run has: XLA's compile
#: accounting and its health short names (a CPU run of the port
#: captures and builds nothing)
JAX_ONLY = {"compile.count", "compile.seconds", "compile.cache_hits",
            "compile.cache_misses", "compile.recompiles", "compiles",
            "recompiles"}

#: spans only the port records: the train step's children and the
#: decision's run and class end (the loader's device gather too, which
#: a run through the input pipeline does not take)
PORT_ONLY_SPANS = {("fused.replay", "step"), ("fused.adopt", "step"),
                   ("decision.run", "decision"),
                   ("decision.class_end", "decision"),
                   ("loader.gather", "loader")}

#: the backward split: each run publishes it only while its own median
#: train step outlasts its median evaluation step, which is timing
TIMED = {"gauges": {"bwd.step_ms", "bwd.mfu_pct"},
         "health": {"bwd_step_ms", "bwd_mfu_pct"}}


def test_fused_run_emits_jax_spans_and_metric_names(tmp_path, monkeypatch):
    from tests.test_observe import _trace_smoke_run
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.observe.metrics import registry as jax_registry
    from veles_tpu.observe.profile import \
        validate_heartbeat as jax_validate
    from veles_tpu.observe.timeseries import series as jax_series
    from veles_tpu_torch.observe.profile import validate_heartbeat
    from veles_tpu_torch.observe.timeseries import series
    from veles_tpu_torch.observe.trace import validate_trace
    # each package's process-wide series ring closes a bucket, and sets
    # the ``telemetry.buckets`` gauge, at the first heartbeat one
    # interval (5 s) after its last tick, which an earlier test of this
    # process may have made: both runs start from a cleared ring whose
    # interval no run reaches, so neither closes a bucket whatever the
    # clock reads
    for ring in (jax_series, series):
        ring.clear()
        monkeypatch.setattr(ring, "interval_s", 1e9)
    jax_registry.reset()
    jax_doc, jax_lines = _trace_smoke_run(JaxDevice(backend="cpu"),
                                          tmp_path, pipeline=True)
    registry.reset()
    doc, lines, workflow = _port_smoke_run(tmp_path)
    validate_trace(doc)
    assert _spans(doc) - PORT_ONLY_SPANS == _spans(jax_doc)
    assert PORT_ONLY_SPANS - {("loader.gather", "loader")} <= _spans(doc)
    assert {"fused.train_step", "pipeline.fill", "pipeline.h2d",
            "pipeline.wait", "FusedTrainer"} <= {n for n, _ in _spans(doc)}
    # the worker's stages on a track of their own
    steps, fills = _tids(doc, "fused.train_step"), _tids(doc,
                                                         "pipeline.fill")
    assert steps and fills and not steps & fills
    counters = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    jax_counters = {e["name"] for e in jax_doc["traceEvents"]
                    if e["ph"] == "C"}
    assert counters == jax_counters == {"pipeline.inflight"}
    for record in lines:
        validate_heartbeat(record)
        jax_validate(record)
    for record in jax_lines:
        validate_heartbeat(record)
    final, jax_final = lines[-1], jax_lines[-1]
    assert set(final) == set(jax_final)
    for record in (final, jax_final):
        assert record["series"]["buckets_held"] == 0
        assert "telemetry.buckets" not in record["gauges"]
    for block in ("counters", "gauges", "histograms", "health"):
        timed = TIMED.get(block, set())
        assert set(final[block]) - timed == \
            set(jax_final[block]) - JAX_ONLY - timed, block
    for record in (final, jax_final):
        split = "bwd.step_ms" in record["gauges"]
        assert split == ("bwd_step_ms" in record["health"])
        if split:
            assert record["gauges"]["bwd.step_ms"] > 0
    assert final["counters"]["train.steps"] == \
        jax_final["counters"]["train.steps"] == 16
    assert final["counters"]["train.samples"] == \
        jax_final["counters"]["train.samples"]
    assert final["epoch"] == jax_final["epoch"] == 2
    for key in ("skip_count", "consecutive_skips"):
        assert final["health"][key] == jax_final["health"][key] == 0
    assert final["health"]["mfu_pct"] > 0 and final["mfu_pct"] > 0
    assert final["gauges"]["train.epoch"] == 2
    assert final["gauges"]["metric.train"] == \
        workflow.decision.epoch_metrics[2]
    # the step FLOPs: the analytic count within 3 % of XLA's
    assert final["gauges"]["xla.step_flops"] == pytest.approx(
        jax_final["gauges"]["xla.step_flops"], rel=0.03)
    assert final["gauges"]["xla.fwd_flops"] == pytest.approx(
        jax_final["gauges"]["xla.fwd_flops"], rel=0.03)
    assert set(final["compile"]) - {"captures", "kernel_builds"} == \
        set(jax_final["compile"])
    assert final["compile"]["captures"] == 0


def test_disabled_tracer_emits_nothing_and_stays_cheap():
    local = SpanTracer()
    local._flight = type("Off", (), {"enabled": False})()
    start = time.perf_counter()
    for _ in range(20000):
        with local.span("x"):
            pass
        local.instant("y")
        local.complete("z", 0.0, 1.0)
        local.counter("c", 1)
    elapsed = time.perf_counter() - start
    assert local.events == [] and local.dropped == 0
    assert elapsed < 2.0


def test_fused_run_with_the_tracer_off_records_nothing():
    from tests.test_torch_pipeline_input import _build
    registry.reset()
    assert not tracer.enabled
    before = len(tracer.events)
    sw = _build(False, max_epochs=2)
    sw.run()
    assert len(tracer.events) == before
    # the metrics are collected all the same (host floats, no sync)
    assert registry.counter("train.steps").value > 0
    snap = registry.histogram("step.train_s").snapshot()
    assert snap["count"] > 0 and snap["p50"] > 0.0
    assert registry.histogram("step.eval_s").snapshot()["count"] > 0


def test_decision_never_publishes_nonfinite_metric_gauge():
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.models.decision import DecisionGD
    registry.reset()
    decision = DecisionGD(DummyWorkflow(), watchdog=False)
    decision.class_lengths = [0, 0, 10]
    decision.epoch_n_err = [0, 0, float("nan")]
    decision._record_class_metric(2)
    assert decision.epoch_metrics[2] != decision.epoch_metrics[2]
    assert registry.peek("metric.train") is None
    decision.epoch_n_err = [0, 0, 2]
    decision._record_class_metric(2)
    assert registry.peek("metric.train").value == 20.0


def test_rollback_telemetry_equals_jax(tmp_path, monkeypatch):
    """The sustained-NaN run of both packages: the same rollback and
    skip telemetry, a flight dump at each divergence and each rollback,
    and the ``snapshot.rollback`` instants."""
    from tests.test_torch_health import SUSTAINED, _resume_run
    from veles_tpu.observe.flight import flight as jax_flight
    from veles_tpu.observe.metrics import registry as jax_registry
    from veles_tpu.observe.trace import tracer as jax_tracer
    from veles_tpu_torch.observe.flight import flight
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_flight, "base_path",
                        str(tmp_path / "jax_flight" / "veles_flight"))
    monkeypatch.setattr(flight, "base_path",
                        str(tmp_path / "port_flight" / "veles_flight"))
    runs = {}
    for name, reg, trc in (("jax", jax_registry, jax_tracer),
                           ("torch", registry, tracer)):
        reg.reset()
        trc.start()
        try:
            sw, error = _resume_run(name, tmp_path / name, SUSTAINED)
        finally:
            trc.stop()
        assert error is None, (name, error)
        instants = [e["name"] for e in trc.events if e["ph"] == "i"
                    and e["name"].startswith("snapshot.")]
        runs[name] = (reg, instants, sw)
    (reg, instants, sw), (jreg, jinstants, _) = runs["torch"], runs["jax"]
    for metric in ("health.rollbacks", "health.rollbacks_remaining",
                   "health.skip_count", "health.consecutive_skips",
                   "train.epoch", "snapshot.exports"):
        assert reg.peek(metric).value == jreg.peek(metric).value, metric
    assert reg.peek("health.rollbacks").value == 2
    assert reg.histogram("snapshot.write_s").snapshot()["count"] == \
        reg.peek("snapshot.exports").value
    assert instants == jinstants == ["snapshot.rollback"] * 2
    dumps = sorted(p.name.split(".")[1] for p in
                   (tmp_path / "port_flight").iterdir())
    jax_dumps = sorted(p.name.split(".")[1] for p in
                       (tmp_path / "jax_flight").iterdir())
    assert dumps == jax_dumps == ["divergence"] * 2 + ["rollback"] * 2
    assert sw.snapshotter.rollbacks == 2


def test_export_counts_and_traces_each_snapshot(tmp_path):
    from tests.test_torch_snapshot import _build
    from veles_tpu_torch.observe.trace import validate_trace
    from veles_tpu_torch.snapshotter import (Snapshotter,
                                             publish_schedule_bank,
                                             publish_snapshot)
    from veles_tpu_torch.tune.cache import ScheduleCache
    registry.reset()
    sw = _build(max_epochs=1, run=True)
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="t",
                       interval=1, time_interval=0, compression="gz")
    snap.initialize()
    assert registry.peek("health.rollbacks_remaining").value == \
        snap.rollback_budget
    tracer.start()
    try:
        snap.run()
        snap.run()
        publish_snapshot(snap.destination, str(tmp_path / "publish"))
        cache = ScheduleCache(str(tmp_path / "cache" / "schedules.json"))
        cache.put("probe-digest", {"op": "matmul"}, {"bk": 32},
                  fitness=-1e-3, evals=1)
        publish_schedule_bank(str(tmp_path / "publish"), cache=cache)
    finally:
        tracer.stop()
    assert registry.peek("snapshot.exports").value == 2
    assert registry.histogram("snapshot.write_s").snapshot()["count"] == 2
    events = tracer.events
    validate_trace({"traceEvents": events})
    exports = [e for e in events if e["name"] == "snapshot.export"]
    assert len(exports) == 2 and exports[0]["cat"] == "snapshot"
    assert exports[-1]["args"]["bytes"] == snap.last_export["bytes"]
    instants = {e["name"]: e for e in events if e["ph"] == "i"}
    assert instants["freshness.publish"]["args"]["ordinal"] == 1
    assert instants["tune.bank_publish"]["args"]["entries"] == 1
    assert registry.peek("tune.bank_published").value == 1


# -- step timing on the card ------------------------------------------------


class FakeEvent(object):
    """A CUDA event stand-in: completes when the test says so."""

    def __init__(self, clock):
        self.at = clock[0]
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


class _Recorder(object):
    def __init__(self):
        self.clock = [0.0]
        self.events = []

    def __call__(self):
        event = FakeEvent(self.clock)
        self.events.append(event)
        return event

    def advance(self, seconds):
        self.clock[0] += seconds

    def complete(self, upto=None):
        for event in self.events[:upto]:
            event.done = True


def test_step_clock_times_consecutive_steps_of_one_class():
    from veles_tpu_torch.models.fused import StepClock
    from veles_tpu_torch.observe.metrics import MetricsRegistry
    reg = MetricsRegistry()
    train, evals = reg.histogram("train"), reg.histogram("eval")
    rec = _Recorder()
    clock = StepClock(None, capacity=64, record=rec)
    for seconds in (0.5, 0.010, 0.012, 0.011):   # the first is its own
        rec.advance(seconds)
        clock.mark(True, train)
    assert train.snapshot()["count"] == 0         # nothing completed
    rec.complete(upto=3)
    clock.poll()
    assert train.window_values() == pytest.approx([0.010, 0.012])
    rec.advance(0.3)                              # the class-end sync
    clock.mark(False, evals)                      # a class switch
    rec.advance(0.004)
    clock.mark(False, evals)
    rec.advance(0.2)
    clock.mark(True, train, counted=False)        # this one captured
    rec.advance(0.013)
    clock.mark(True, train)
    rec.complete()
    clock.poll()
    assert train.window_values() == pytest.approx(
        [0.010, 0.012, 0.011, 0.013])
    assert evals.window_values() == pytest.approx([0.004])
    assert clock.dropped == 0


def test_step_clock_ring_is_bounded():
    from veles_tpu_torch.models.fused import StepClock
    from veles_tpu_torch.observe.metrics import MetricsRegistry
    hist = MetricsRegistry().histogram("train")
    rec = _Recorder()
    clock = StepClock(None, capacity=4, record=rec)
    for _ in range(11):
        rec.advance(0.01)
        clock.mark(True, hist)
    assert clock.dropped == 6 and len(clock._pending) == 4
    rec.complete()
    assert clock.poll() == 4


def test_trainer_on_graph_bookkeeping_watches_and_counts(monkeypatch):
    """A fused run with tests/test_torch_graphs.FakeGraphs as its graph
    owner: the watcher sees its train and evaluation captures, the
    capture counters move, the step FLOPs are published once, and the
    step histograms take the StepClock's intervals (a fake event source
    10 ms a step)."""
    from tests.test_torch_graphs import FakeGraphs
    from tests.test_torch_pipeline_input import _build
    from veles_tpu_torch.graphs import GraphOwner
    from veles_tpu_torch.models.fused import StepClock
    from veles_tpu_torch.observe import introspect
    registry.reset()
    sw = _build(False, max_epochs=2, minibatch_size=32)
    trainer = sw.fused_trainer
    trainer._graphs_ = GraphOwner("fused trainer", "cpu", FakeGraphs())
    trainer._compile()
    rec = _Recorder()

    def record():
        rec.advance(0.01)
        return rec()
    trainer._clock_ = StepClock(None, record=record)
    published = []
    real = trainer._publish_step_flops
    monkeypatch.setattr(trainer, "_publish_step_flops",
                        lambda x: (published.append(x.shape), real(x)))
    sw.run()
    assert registry.histogram("step.train_s").snapshot()["count"] == 0
    rec.complete()
    trainer.poll_step_times()
    receipt = trainer.compile_receipt
    assert receipt["captures"] == 2  # one train, one eval signature
    assert introspect.poll_recompiles() == {"fused.step": 1,
                                            "fused.eval": 1}
    assert introspect.compile_snapshot()["captures"] == 2
    assert published == [(32, 16)]
    assert registry.peek("xla.step_flops").value > \
        registry.peek("xla.fwd_flops").value > 0
    train = registry.histogram("step.train_s").window_values()
    evals = registry.histogram("step.eval_s").window_values()
    assert all(v == pytest.approx(0.01) for v in train + evals)
    # 8 train steps an epoch and 2 evaluation steps before each epoch
    # and after the last: the first of each class block is no interval
    # (a capture step is always a first here)
    assert (len(train), len(evals)) == (14, 3)
    assert registry.counter("train.steps").value == 16
