"""The port's spans under a running ``torch.profiler``
(veles_tpu_torch/observe/trace.py's profiler-linked recording and the
sites in serve/, models/, loader/, quant/ and graphs.py), on the CPU.

- A span recorded on a thread the profiler does not record is kept,
  and lands on the profiler's clock: within 100 us of a main-thread
  ``record_function`` around the same work.
- A ``ContinuousBatcher`` over a CPU ``AOTEngine``: each worker pass is
  ``serve.idle`` / ``serve.collect`` then a ``serve.batch`` parent over
  its five children in order, the spans cover at least 95 % of each
  pass, and a sampled request's spans carry its batch's ``seq``.
- A fused training minibatch (loader, trainer, decision): the gather,
  the step's replay and hand-over inside ``fused.train_step``, the
  decision's class-end read inside ``decision.run``.
- ``ProfilerHook`` writes the window's spans into its Chrome trace.
- The set-up counters: a PTQ pass and one capture move theirs.
"""

import json
import threading
import time

import numpy
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch.observe.flight import FlightRecorder
from veles_tpu_torch.observe.metrics import registry
from veles_tpu_torch.observe.trace import SpanTracer, tracer

pytestmark = pytest.mark.observe

#: a worker pass's spans under their serve.batch parent, in order
BATCH_CHILDREN = ["serve.assemble", "serve.h2d", "serve.launch",
                  "serve.d2h", "serve.answer"]


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _host_events(prof, name):
    """(start_us, end_us) of the profiler's events named ``name``."""
    out = []
    for evt in prof.profiler.kineto_results.events():
        if evt.name() == name:
            start = evt.start_ns() / 1e3
            out.append((start, start + evt.duration_ns() / 1e3))
    return out


def test_span_off_the_profiler_thread_lands_on_its_clock():
    """The main thread, which the profiler records, runs a
    ``record_function`` around some work and reads the clock just
    outside it and just inside it; the worker, which the profiler does
    not record, records that work as its span from the inner readings.
    The profiler's stamps of the range lie between the mapped outer and
    inner readings, to within 100 us, at each end.  Three rounds 0.6 s
    apart take the tracer through a fresh anchor pair."""
    tr = SpanTracer(flight=FlightRecorder(enabled=False))
    rounds = 3
    handed = [None] * rounds
    ready = [threading.Event() for _ in range(rounds)]
    recorded = [threading.Event() for _ in range(rounds)]

    def worker():
        for i in range(rounds):
            ready[i].wait(10)
            _, start, end, _ = handed[i]
            tr.open("work", start=start, cat="test", seq=i).close(end)
            with tr.span("worker.own", cat="test"):
                time.sleep(0.001)
            recorded[i].set()

    thread = threading.Thread(target=worker, name="unprofiled-worker")
    thread.start()
    assert not tr.live
    with _profiled() as prof:
        assert tr.live
        for i in range(rounds):
            before = time.perf_counter()
            with record_function("main.work"):
                start = time.perf_counter()
                time.sleep(0.005)
                end = time.perf_counter()
            handed[i] = (before, start, end, time.perf_counter())
            ready[i].set()
            assert recorded[i].wait(10)
            time.sleep(0.6)
    thread.join(10)
    assert not tr.live and tr.events == []
    spans = tr.profiled_spans()
    work = sorted((s for s in spans if s.name == "work"),
                  key=lambda s: s.seq)
    own = [s for s in spans if s.name == "worker.own"]
    assert [s.seq for s in work] == list(range(rounds)) and len(own) == 3
    assert {s.thread for s in spans} == {"unprofiled-worker"}
    assert {s.tid for s in spans} == {thread.native_id}
    marks = sorted(_host_events(prof, "main.work"))
    assert len(marks) == rounds
    for span, (rf_start, rf_end), readings in zip(work, marks, handed):
        before, _, _, after = (tr.profiler_ns(t) / 1e3 for t in readings)
        assert before - 100.0 <= rf_start <= span.start_us + 100.0
        assert span.end_us - 100.0 <= rf_end <= after + 100.0
    assert len(tr._anchors) >= 2


def _cpu_engine(hidden=256, ladder=(1, 8)):
    from tests.test_torch_serve_tier import _mlp_spec
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.serve import AOTEngine
    plans, params = _mlp_spec(seed=3, fan_in=64, hidden=hidden)
    engine = AOTEngine(plans, params, (64,), ladder=ladder,
                       device=Device(backend="cpu"))
    engine.compile()
    return engine


def _worker_passes(spans):
    """[(pass's top-level spans, batch span, its children)] of the
    batcher worker's spans, a pass ending at each ``serve.batch``."""
    ordered = sorted(spans, key=lambda s: (s.start_us, -s.end_us))
    children = {}
    for span in ordered:
        if span.parent is not None:
            children.setdefault(span.parent, []).append(span)
    passes, pending = [], []
    for span in ordered:
        if span.parent is not None:
            continue
        if span.name == "serve.batch":
            passes.append((pending, span, children.get(span.id, [])))
            pending = []
        else:
            pending = [s for s in pending if s.name == "serve.idle"] \
                if span.name == "serve.collect" else []
            pending.append(span)
    return passes


def _union_us(intervals):
    total, cursor = 0.0, None
    for start, end in sorted(intervals):
        if cursor is None or start > cursor:
            total += end - start
            cursor = end
        elif end > cursor:
            total += end - cursor
            cursor = end
    return total


def test_batcher_passes_are_covered_by_the_worker_spans():
    from veles_tpu_torch.serve import ContinuousBatcher
    engine = _cpu_engine()
    batcher = ContinuousBatcher(engine, max_delay_s=0.002).start()
    rng = numpy.random.RandomState(0)
    try:
        with _profiled():
            for i in range(12):
                req = batcher.submit(rng.rand(64).astype(numpy.float32),
                                     trace="req-%d" % i)
                assert req.done.wait(10) and req.error is None
                time.sleep(0.01)
            time.sleep(0.05)
    finally:
        batcher.stop()
    spans = tracer.profiled_spans()
    worker = [s for s in spans if s.thread == "serve-batcher"]
    # the pass the profiler's start fell into has no idle or collect
    passes = [p for p in _worker_passes(worker) if p[0]]
    assert len(passes) >= 11
    for top, batch, kids in passes:
        assert [s.name for s in top][-1] == "serve.collect"
        assert {s.name for s in top} <= {"serve.idle", "serve.collect"}
        assert [s.name for s in kids] == BATCH_CHILDREN
        assert all(s.parent == batch.id and s.seq == batch.seq
                   for s in kids)
        assert top[-1].seq == batch.seq and batch.args["n"] == 1
        # the whole pass, and the pass from its collect on (the
        # batching delay, then the dispatch), which no wait pads out
        for first in (top[0], top[-1]):
            wall = batch.end_us - first.start_us
            covered = _union_us([(s.start_us, s.end_us) for s in top
                                 if s.start_us >= first.start_us] +
                                [(s.start_us, s.end_us) for s in kids])
            assert covered >= 0.95 * wall, (covered, wall)
        assert batch.start_us >= top[-1].end_us - 1.0
    seqs = [batch.seq for _, batch, _ in passes]
    assert seqs == sorted(set(seqs))
    requests = {s.args["trace"]: s.args.get("seq") for s in spans
                if s.name == "serve.request"}
    assert set(seqs) <= set(requests.values())


def _blobs_loader(workflow, batch):
    """A tiny dataset, all of the train class, on the device path."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader

    class Blobs(FullBatchLoader):
        def load_data(self):
            rng = numpy.random.RandomState(1)
            self.original_data = rng.rand(48, 12).astype(numpy.float32)
            self.original_labels = rng.randint(0, 4, 48).astype(
                numpy.int32)
            self.class_lengths[0] = 0
            self.class_lengths[1] = 0
            self.class_lengths[2] = 48

    return Blobs(workflow, minibatch_size=batch,
                 prng=prng.RandomGenerator("spans", seed=2))


def _fused_workflow(batch=16):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    hyper = {"learning_rate": 0.1, "gradient_moment": 0.9}
    sw = StandardWorkflow(
        DummyLauncher(),
        layers=[dict(type="all2all_tanh", output_sample_shape=8, **hyper),
                dict(type="softmax", output_sample_shape=4, **hyper)],
        loader_factory=lambda w: _blobs_loader(w, batch),
        decision_config=dict(max_epochs=None, fail_iterations=1000))
    sw.fuse(pipeline=False)
    sw.initialize(device=Device(backend="cpu"))
    return sw


def _minibatches(sw, count):
    for _ in range(count):
        sw.loader.run()
        sw.fused_trainer.run()
        sw.decision.run()


def test_training_minibatch_spans_and_their_parents():
    sw = _fused_workflow()
    _minibatches(sw, 1)  # the step's build, outside the window
    with _profiled():
        _minibatches(sw, 3)  # 48 rows in 16s: the third ends the class
    sw.stop()
    spans = [s for s in tracer.profiled_spans()
             if s.thread == threading.current_thread().name]
    names = [s.name for s in spans]
    assert names.count("loader.gather") == 3
    steps = [s for s in spans if s.name == "fused.train_step"]
    assert [s.seq for s in steps] == [2, 3, 4]
    assert [s.args["iteration"] for s in steps] == [2, 3, 4]
    for step in steps:
        kids = [s.name for s in spans if s.parent == step.id]
        assert kids == ["fused.replay", "fused.adopt"]
        assert all(s.seq == step.seq for s in spans
                   if s.parent == step.id)
    runs = [s for s in spans if s.name == "decision.run"]
    assert len(runs) == 3
    ends = [s for s in spans if s.name == "decision.class_end"]
    # the second minibatch of the window ends the epoch's class
    assert len(ends) == 1 and ends[0].parent == runs[1].id
    assert all(s.parent is None for s in spans
               if s.name in ("loader.gather", "fused.train_step",
                             "decision.run"))


def test_profiler_hook_writes_the_windows_spans(tmp_path):
    from veles_tpu_torch.observe import profile as observe_profile
    hook = observe_profile.install_profiler(observe_profile.ProfilerHook(
        str(tmp_path / "prof"), start_step=1, stop_step=3))
    done = threading.Event()

    def worker():
        with tracer.span("hook.worker", cat="test"):
            done.wait(10)

    try:
        x = torch.ones(32, 32)
        thread = None
        for i in range(5):
            torch.matmul(x, x)
            observe_profile.profiler_step()
            if i == 2:
                thread = threading.Thread(target=worker, name="hook-w")
                thread.start()
                time.sleep(0.01)
                done.set()
                thread.join(10)
    finally:
        observe_profile.uninstall_profiler()
    with open(hook.trace_path) as fin:
        doc = json.load(fin)
    events = doc["traceEvents"]
    ours = [e for e in events if e.get("name") == "hook.worker"]
    assert len(ours) == 1 and ours[0]["tid"] == thread.native_id
    assert ours[0]["dur"] >= 1e4 and "span_id" in ours[0]["args"]
    assert {"ph": "M", "name": "thread_name", "pid": ours[0]["pid"],
            "tid": thread.native_id, "args": {"name": "hook-w"}} in events
    mm = [e for e in events if "mm" in str(e.get("name")) and
          e.get("ph") == "X"]
    # on the profiler's own timeline: the worker's span lies between
    # the matmuls of the window's steps
    assert min(e["ts"] for e in mm) < ours[0]["ts"] < \
        max(e["ts"] for e in mm)


def _capture():
    from tests.test_torch_graphs import fake_owner
    owner = fake_owner("spans")
    owner.graph("sig", lambda x: (x * 2,), [torch.arange(4.0)])


def _ptq():
    from tests.test_torch_serve_tier import _mlp_spec
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.quant import quantize_model_spec
    plans, params = _mlp_spec(seed=4)
    samples = numpy.random.RandomState(5).rand(8, 16).astype(numpy.float32)
    quantize_model_spec(plans, params, samples,
                        device=Device(backend="cpu"))


@pytest.mark.parametrize("run, counters, span_names", [
    (_capture, ["compile.capture_seconds"], ["graphs.capture"]),
    (_ptq, ["quant.ptq_seconds", "quant.ptq_calibration_seconds",
            "quant.ptq_weight_seconds"],
     ["quant.ptq", "quant.calibrate", "quant.weights"]),
], ids=["capture", "ptq"])
def test_setup_counters_move_and_spans_follow_a_profiler(run, counters,
                                                        span_names):
    def values():
        return [registry.peek(name).value if registry.peek(name)
                else 0.0 for name in counters]

    before = values()
    run()
    middle = values()
    assert all(m > b for m, b in zip(middle, before)), (before, middle)
    total = middle[0] - before[0]
    assert total >= sum(m - b for m, b in zip(middle[1:], before[1:]))
    with _profiled():
        run()
    assert all(a > m for a, m in zip(values(), middle))
    spans = {s.name: s for s in tracer.profiled_spans()}
    assert set(span_names) <= set(spans)
    for name in span_names[1:]:
        assert spans[name].parent == spans[span_names[0]].id
