"""The readers of the program's spans and set-up counters on made-up
data: a profile of known device intervals, the tracer's spans of two
threads with known idle gaps, and a registry; each reader returns the
hand-computed value, and None where the program recorded nothing."""

import types

import pytest

from portbench.bench import Bench
from portbench.tests.conftest import ROOT
from portbench.tests.test_portbench_trace import Event, Profile
from portbench.trace import Trace

WORKER, MAIN, REQUEST = 7, 3, (1 << 30) + 1

SPAN_METRICS = ("host_idle_pct.serve", "collect_ms.serve",
                "h2d_ms.serve", "host_idle_pct.train")


def _trace():
    # device busy over [0, 150], [400, 450] and [1000, 1010] us; the
    # host's events span [0, 2000]
    return Trace(Profile([
        Event("fprop", 0, 100, True),
        Event("fprop", 50, 100, True),
        Event("wgrad", 400, 50, True),
        Event("Memcpy HtoD", 1000, 10, True),
        Event("window", 0, 2000, False),
    ]))


def _span(name, start, end, tid, span_id=None, parent=None):
    from veles_tpu_torch.observe.trace import ProfiledSpan
    return ProfiledSpan(name, "test", float(start), float(end), tid,
                        "t%d" % tid, span_id, parent, None, None)


SPANS = [
    # the worker: an idle wait reaching back before the window
    _span("serve.idle", -500, 300, WORKER),
    _span("serve.collect", 300, 350, WORKER),
    _span("serve.batch", 350, 900, WORKER, 1),
    _span("serve.assemble", 350, 380, WORKER, None, 1),
    _span("serve.h2d", 380, 420, WORKER, None, 1),
    _span("serve.collect", 920, 950, WORKER),
    _span("serve.batch", 950, 1200, WORKER, 2),
    _span("serve.h2d", 960, 1020, WORKER, None, 2),
    # a request track: not the worker's thread
    _span("serve.request", 0, 1900, REQUEST),
    # the training loop
    _span("loader.gather", 0, 20, MAIN),
    _span("fused.train_step", 20, 420, MAIN, 3),
    _span("fused.replay", 20, 40, MAIN, None, 3),
    _span("fused.adopt", 40, 60, MAIN, None, 3),
    _span("decision.run", 420, 1005, MAIN, 4),
    _span("decision.class_end", 430, 1000, MAIN, None, 4),
]

#: by hand: the worker's batches are idle over [350, 400] + [450, 900]
#: and [950, 1000] + [1010, 1200] = 740 us of the 2 ms window; the
#: collects last 50 and 30 us; the copies in 40 and 60 us; the training
#: loop's spans cover [0, 1005], idle over [150, 400] + [450, 1000]
EXPECTED = {"host_idle_pct.serve": 37.0, "collect_ms.serve": 0.04,
            "h2d_ms.serve": 0.05, "host_idle_pct.train": 40.0}


@pytest.fixture
def bench():
    return Bench(ROOT)


def _ctx(kind, trace=True):
    return types.SimpleNamespace(kind=kind, trace=_trace() if trace
                                 else None, window_s=0.002)


def _tracer(monkeypatch, spans):
    from veles_tpu_torch.observe import trace
    fake = types.SimpleNamespace(profiled_spans=lambda: list(spans))
    monkeypatch.setattr(trace, "tracer", fake)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers_read_the_hand_computed_values(metric, bench,
                                                    monkeypatch):
    _tracer(monkeypatch, SPANS)
    kind = metric.rsplit(".", 1)[1]
    assert bench.reader(metric)(_ctx(kind)) == pytest.approx(
        EXPECTED[metric])
    other = "train" if kind == "serve" else "serve"
    assert bench.reader(metric)(_ctx(other)) is None
    # at most the device's idle share, of which it is a part
    idle = bench.reader("idle_pct." + kind)(_ctx(kind))
    if metric.startswith("host_idle_pct"):
        assert bench.reader(metric)(_ctx(kind)) <= idle


@pytest.mark.parametrize("metric", SPAN_METRICS)
@pytest.mark.parametrize("case", ["no spans", "no reader", "no trace",
                                  "outside the window"])
def test_span_readers_read_nothing_without_spans(metric, case, bench,
                                                 monkeypatch):
    from veles_tpu_torch.observe import trace
    kind = metric.rsplit(".", 1)[1]
    if case == "no reader":
        # a program without profiler-linked recording
        monkeypatch.setattr(trace, "tracer", types.SimpleNamespace())
    else:
        _tracer(monkeypatch, [] if case == "no spans" else
                [s._replace(start_us=s.start_us + 5000,
                            end_us=s.end_us + 5000) for s in SPANS])
    assert bench.reader(metric)(_ctx(kind, case != "no trace")) is None


@pytest.mark.parametrize("metric, counter", [
    ("capture_s.setup", "compile.capture_seconds"),
    ("ptq_s.setup", "quant.ptq_seconds")])
def test_setup_readers_read_their_counter(metric, counter, bench,
                                          monkeypatch):
    from veles_tpu_torch.observe import metrics
    registry = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "registry", registry)
    ctx = _ctx("serve")
    assert bench.reader(metric)(ctx) is None
    registry.counter(counter).inc(1.25)
    registry.counter(counter).inc(0.5)
    assert bench.reader(metric)(ctx) == pytest.approx(1.75)
