"""The port's span tracer, flight recorder, clock offsets and trace
merge (veles_tpu_torch/observe/trace.py, flight.py, cluster.py,
merge.py) against the JAX package's, on the CPU.

- The tracer cases of tests/test_observe.py: a disabled tracer records
  nothing and stays cheap, spans nest and the document validates, an
  overlap is refused, ``traced`` and per-thread tracks, bounded memory.
- The cases of tests/test_observe_cluster.py: the min-delay offset
  estimate, ``take_chunk`` (bounded, thread names, thread scoping), the
  two-process merge with offset-corrected timestamps, the collector's
  bounds, the flight ring and its dump schema, the disabled tracer
  feeding the flight ring, malformed dumps refused.
- Across the packages: JAX's ``validate_trace`` and ``validate_flight``
  accept the port's documents, the offsets equal JAX's on the same
  probes, and JAX's merge of a port document equals the port's merge.
"""

import json
import threading
import time

import pytest

from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu.observe import cluster as jax_cluster
from veles_tpu.observe import merge as jax_merge
from veles_tpu.observe.flight import validate_flight as jax_validate_flight
from veles_tpu.observe.trace import validate_trace as jax_validate_trace
from veles_tpu_torch.observe.cluster import TraceCollector, estimate_offset
from veles_tpu_torch.observe.flight import FlightRecorder, validate_flight
from veles_tpu_torch.observe.merge import (merge_parts, part_from_doc)
from veles_tpu_torch.observe.trace import SpanTracer, validate_trace

pytestmark = pytest.mark.observe


# -- span tracer --------------------------------------------------------------


def test_disabled_tracer_emits_nothing_and_stays_cheap():
    tracer = SpanTracer(flight=FlightRecorder(enabled=False))
    assert not tracer.active
    start = time.perf_counter()
    for _ in range(20000):
        with tracer.span("x"):
            pass
        tracer.instant("y")
        tracer.complete("z", 0.0, 1.0)
        tracer.counter("c", 1)
    elapsed = time.perf_counter() - start
    assert tracer.events == []
    assert tracer.dropped == 0
    # 80k disabled calls: a lock or a device sync on the disabled path
    # would blow through this bound
    assert elapsed < 2.0


def test_spans_nest_and_trace_parses_in_both_packages(tmp_path):
    tracer = SpanTracer().start()
    with tracer.span("outer", cat="test", level=1):
        with tracer.span("inner", cat="test"):
            time.sleep(0.001)
        tracer.instant("marker", note="hello")
        tracer.counter("depth", 3)
    tracer.stop()
    path = tracer.save(str(tmp_path / "trace.json"))
    with open(path) as fin:
        doc = json.load(fin)
    validate_trace(doc)
    jax_validate_trace(doc)
    events = doc["traceEvents"]
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= \
        outer["ts"] + outer["dur"] + 1.0
    assert outer["args"] == {"level": 1}
    assert any(e["ph"] == "M" and e["name"] == "thread_name"
               for e in events)
    assert any(e["ph"] == "i" and e["name"] == "marker" for e in events)
    assert any(e["ph"] == "C" and e["args"] == {"value": 3}
               for e in events)


def test_validate_trace_rejects_overlapping_spans():
    doc = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 100.0,
         "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 50.0, "dur": 100.0,
         "pid": 1, "tid": 1},
    ]}
    with pytest.raises(ValueError, match="does not nest"):
        validate_trace(doc)


def test_traced_decorator_and_threads_get_own_tracks():
    tracer = SpanTracer().start()

    @tracer.traced(cat="test")
    def work():
        time.sleep(0.001)

    work()
    thread = threading.Thread(target=work, name="observe-worker")
    thread.start()
    thread.join()
    tracer.stop()
    spans = [e for e in tracer.events if e["ph"] == "X"]
    assert len(spans) == 2
    assert all("work" in e["name"] for e in spans)
    assert len({e["tid"] for e in spans}) == 2
    names = [e["args"]["name"] for e in tracer.events
             if e["ph"] == "M" and e["name"] == "thread_name"]
    assert "observe-worker" in names


def test_tracer_bounded_memory():
    tracer = SpanTracer(max_events=3)
    tracer.start()
    for i in range(10):
        tracer.instant("e%d" % i)
    events = tracer.events
    assert len(events) == 3
    assert events[0]["name"] == "thread_name"
    assert tracer.dropped == 8


# -- clock offsets ------------------------------------------------------------


def test_estimate_offset_symmetric_rtt_recovers_exactly():
    true_offset, one_way = 2.5, 0.02
    samples = []
    for i in range(5):
        t0 = 100.0 + i
        t1 = t0 + one_way + true_offset
        samples.append((t0, t1, t1, t0 + 2 * one_way))
    offset, delay = estimate_offset(samples)
    assert abs(offset - true_offset) < 1e-9
    assert abs(delay - 2 * one_way) < 1e-9


def test_estimate_offset_asymmetric_prefers_min_delay_sample():
    true_offset = 1.0
    noisy = (0.0, 0.5 + true_offset, 0.5 + true_offset, 0.6)
    clean = (10.0, 10.010 + true_offset, 10.010 + true_offset, 10.021)
    offset, delay = estimate_offset([noisy, clean])
    assert abs(delay - 0.021) < 1e-9
    assert abs(offset - true_offset) <= 0.021 / 2 + 1e-9
    with pytest.raises(ValueError):
        estimate_offset([])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_offset_equals_jax(seed):
    import random
    rng = random.Random(seed)
    samples = []
    for _ in range(9):
        t0 = rng.uniform(0, 1000)
        out, back = rng.uniform(0, 0.3), rng.uniform(0, 0.3)
        t1 = t0 + out + 7.25
        t2 = t1 + rng.uniform(0, 0.01)
        samples.append((t0, t1, t2, t2 - 7.25 + back))
    assert estimate_offset(samples) == \
        jax_cluster.estimate_offset(samples)


# -- trace chunks and the merge -----------------------------------------------


def _recording_tracer(label):
    tracer = SpanTracer(flight=FlightRecorder(enabled=False))
    tracer.start()
    tracer.label = label
    return tracer


def test_take_chunk_pops_bounded_and_preserves_thread_names():
    tracer = _recording_tracer("worker")
    for i in range(10):
        tracer.instant("e%d" % i)
    chunk = tracer.take_chunk(max_events=4)
    assert chunk["schema"] == 1
    assert [e["name"] for e in chunk["events"]] == \
        ["e0", "e1", "e2", "e3"]
    assert chunk["label"] == "worker"
    assert chunk["wall_epoch"] > 0
    tid = chunk["events"][0]["tid"]
    assert chunk["threads"][str(tid)] != ""
    rest = tracer.take_chunk()
    assert [e["name"] for e in rest["events"]] == \
        ["e%d" % i for i in range(4, 10)]
    assert tracer.take_chunk() is None


def test_take_chunk_thread_scoping_separates_shared_tracer():
    tracer = _recording_tracer("shared")
    tracer.instant("main-event")
    seen = {}

    def worker():
        seen["ident"] = threading.get_ident()
        tracer.instant("worker-event")

    thread = threading.Thread(target=worker, name="chunk-worker")
    thread.start()
    thread.join()
    chunk = tracer.take_chunk(idents={seen["ident"]})
    assert [e["name"] for e in chunk["events"]] == ["worker-event"]
    remaining = {e["name"] for e in tracer.events if e["ph"] != "M"}
    assert remaining == {"main-event"}


def _two_process_docs(tmp_path):
    master = _recording_tracer("master")
    with master.span("m.outer", cat="test"):
        with master.span("m.inner", cat="test"):
            time.sleep(0.002)
        master.instant("proto.job_out", cat="proto", job="j1")
    master.stop()
    slave = _recording_tracer("slave:host:1")
    with slave.span("slave.job", cat="proto", job="j1"):
        time.sleep(0.002)
    slave.stop()
    # the slave's wall clock runs 5 s behind the master's
    slave._epoch_wall -= 5.0
    docs = []
    for tracer, name in ((master, "m.json"), (slave, "s.json")):
        with open(tracer.save(str(tmp_path / name))) as fin:
            docs.append(json.load(fin))
    return docs


def test_merge_two_process_traces_tracks_and_corrected_timestamps(
        tmp_path):
    mdoc, sdoc = _two_process_docs(tmp_path)
    merged = merge_parts(
        [part_from_doc(mdoc), part_from_doc(sdoc, offset_s=5.0)],
        trace_id="tid-1")
    validate_trace(merged)
    jax_validate_trace(merged)
    events = [e for e in merged["traceEvents"] if e["ph"] != "M"]
    stamps = [e["ts"] for e in events]
    assert stamps == sorted(stamps)
    assert all(ts >= 0 for ts in stamps)
    by_name = {e["name"]: e for e in events}
    assert by_name["m.outer"]["pid"] != by_name["slave.job"]["pid"]
    procs = {(e.get("args") or {}).get("name")
             for e in merged["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"master", "slave:host:1"}
    gap = abs(by_name["slave.job"]["ts"] - by_name["m.outer"]["ts"])
    assert gap < 2e6
    assert merged["otherData"]["trace_id"] == "tid-1"


def test_merge_of_port_documents_equals_jax(tmp_path):
    mdoc, sdoc = _two_process_docs(tmp_path)
    got = merge_parts([part_from_doc(mdoc),
                       part_from_doc(sdoc, offset_s=5.0)], trace_id="t")
    want = jax_merge.merge_parts(
        [jax_merge.part_from_doc(mdoc),
         jax_merge.part_from_doc(sdoc, offset_s=5.0)], trace_id="t")
    assert got["traceEvents"] == want["traceEvents"]
    assert {k: v for k, v in got["otherData"].items() if k != "tool"} \
        == {k: v for k, v in want["otherData"].items() if k != "tool"}


def test_trace_collector_bounds_and_labels():
    collector = TraceCollector(max_events=5)
    chunk = {"schema": 1, "pid": 1, "label": "slave:a",
             "wall_epoch": 1.0, "threads": {},
             "events": [{"ph": "i", "ts": 0.0, "name": "e",
                         "pid": 1, "tid": 1}] * 4}
    assert collector.add_chunk("a", chunk) == 4
    assert collector.add_chunk("a", chunk) == 1
    assert collector.dropped_events == 3
    collector.add_chunk("a", {"schema": 99, "events": []})
    collector.set_offset("a", 0.25, 0.01)
    parts = collector.parts()
    assert len(parts) == 1
    assert parts[0]["label"] == "slave:a"
    assert parts[0]["offset_s"] == 0.25
    assert sum(len(c["events"]) for c in parts[0]["chunks"]) == 5


# -- flight recorder ----------------------------------------------------------


def test_flight_ring_semantics_and_dump_schema(tmp_path):
    recorder = FlightRecorder(capacity=32, enabled=True,
                              base_path=str(tmp_path / "fl"))
    for i in range(100):
        recorder.record("instant", "e%d" % i)
    assert len(recorder) == 32
    events = recorder.snapshot()
    assert events[0]["name"] == "e68"
    assert events[-1]["name"] == "e99"
    path = recorder.dump(reason="unit test")
    with open(path) as fin:
        doc = json.load(fin)
    validate_flight(doc)
    jax_validate_flight(doc)
    assert doc["reason"] == "unit test"
    assert len(doc["events"]) == 32
    assert recorder.dump(reason="unit test") != path


def test_disabled_tracer_still_feeds_flight_ring():
    ring = FlightRecorder(capacity=64, enabled=True)
    tracer = SpanTracer(flight=ring)
    assert not tracer.enabled and tracer.active
    with tracer.span("step", cat="test"):
        pass
    tracer.instant("proto.evt")
    tracer.counter("depth", 2)
    assert tracer.events == []
    kinds = [(e["kind"], e["name"]) for e in ring.snapshot()]
    assert kinds == [("span", "step"), ("instant", "proto.evt"),
                     ("counter", "depth")]
    span = ring.snapshot()[0]
    assert span["dur_s"] >= 0 and span["ts"] > 0
    ring.enabled = False
    assert not tracer.active
    with tracer.span("ignored"):
        pass
    assert len(ring) == 3


@pytest.mark.parametrize("doc", [
    [], {"kind": "flight"}, {"kind": "trace", "schema": 1},
])
def test_validate_flight_rejects_malformed(doc):
    with pytest.raises(ValueError):
        validate_flight(doc)
    with pytest.raises(ValueError):
        jax_validate_flight(doc)


def test_serve_spans_of_a_port_batcher_validate_in_jax(tmp_path):
    """The port's serve tier through the global tracer: ``serve.batch``
    spans and the request tracks of a traced batcher make a document
    JAX's validator accepts, and no span touches the card."""
    import numpy

    from tests.test_torch_serve_tier import _mlp_spec
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.observe.trace import tracer
    from veles_tpu_torch.serve import AOTEngine, ContinuousBatcher
    plans, params = _mlp_spec(seed=2)
    engine = AOTEngine(plans, params, (16,), ladder=(8,),
                       device=Device(backend="cpu"))
    engine.compile()
    batcher = ContinuousBatcher(engine, max_delay_s=0.001).start()
    tracer.start()
    try:
        for i in range(4):
            req = batcher.submit(numpy.zeros(16, numpy.float32),
                                 trace="span-%d" % i)
            assert req.done.wait(10) and req.error is None
    finally:
        tracer.stop()
        batcher.stop()
    path = tracer.save(str(tmp_path / "serve.json"))
    with open(path) as fin:
        doc = json.load(fin)
    validate_trace(doc)
    jax_validate_trace(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    assert "serve.batch" in names and "serve.request" in names
