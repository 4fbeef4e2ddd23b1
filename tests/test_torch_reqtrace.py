"""The port's request-scoped serve tracing (veles_tpu_torch/observe/
requests.py and its call sites in the batcher, the HTTP front, the
binary transport and the fleet router) against the JAX package's, on
the CPU.

- The cases of tests/test_reqtrace.py on the port: minting and
  normalizing ids at the never-unpickle boundary, sampling
  deterministic in the id, the exemplar ring's bound and shadow
  exclusion, the HTTP route echoing a client's id or minting one, the
  binary front's hello default and per-frame override with the echoed
  segments, the SLO violation's flight dump carrying the offending
  timeline, the analyzer naming the device segment of a stalled
  request, the hedged request's two legs stitched under one id, and the
  latency of a requeued request anchored at its arrival.
- The same ids, notes and documents through both packages: equal
  normalizations and sampling decisions, equal exemplar snapshots, and
  equal analyzer reports on the port's saved trace and flight dump.

No port binds: the HTTP route is called through the service's app, the
transport and the fleet run over socketpairs.
"""

import json
import socket
import time

import numpy
import pytest

from tests.test_torch_fleet import _Hosts, _counter, _wait_for
from tests.test_torch_serve_tier import _mlp_spec
from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu.observe import requests as jax_reqtrace
from veles_tpu_torch import chaos
from veles_tpu_torch.backends import Device
from veles_tpu_torch.observe import requests as reqtrace
from veles_tpu_torch.observe.trace import tracer, validate_trace
from veles_tpu_torch.serve import (
    AOTEngine, BinaryTransportServer, ContinuousBatcher, FleetRouter,
    ServeService)
from veles_tpu_torch.serve.transport import BinaryTransportClient

pytestmark = [pytest.mark.serve, pytest.mark.reqtrace]


def _engine(seed=0):
    plans, params = _mlp_spec(seed=seed)
    eng = AOTEngine(plans, params, (16,), ladder=(8, 32),
                    device=Device(backend="cpu"))
    eng.compile()
    return eng


def _without_paths(report):
    """An analyzer report without its list of input paths."""
    return {k: v for k, v in report.items() if k != "paths"}


# -- the id contract ----------------------------------------------------------


_WIRE_IDS = [None, 17, b"bytes", "", "has space", "semi;colon", "x" * 65,
             "x" * 64, {"trace": "dict"}, ["list"], "  cli-1.2:x_y-Z  ",
             "ok-id", "a" * 1, True]


def test_mint_and_normalize_trace_ids():
    a, b = reqtrace.mint_trace_id(), reqtrace.mint_trace_id()
    assert a != b
    assert reqtrace.normalize_trace_id(a) == a
    assert jax_reqtrace.normalize_trace_id(a) == a
    assert reqtrace.normalize_trace_id("  cli-1.2:x_y-Z  ") == \
        "cli-1.2:x_y-Z"
    for bad in (None, 17, b"bytes", "", "has space", "semi;colon",
                "x" * 65, {"trace": "dict"}, ["list"]):
        assert reqtrace.normalize_trace_id(bad) is None
    for value in _WIRE_IDS:
        assert reqtrace.normalize_trace_id(value) == \
            jax_reqtrace.normalize_trace_id(value)


def test_sampling_is_deterministic_in_the_id_and_equals_jax():
    ids = ["req-%d" % i for i in range(400)]
    first = [reqtrace.sampled(t, rate=0.5) for t in ids]
    assert first == [reqtrace.sampled(t, rate=0.5) for t in ids]
    assert 0 < sum(first) < len(ids)
    assert all(reqtrace.sampled(t, rate=1.0) for t in ids)
    assert not any(reqtrace.sampled(t, rate=0.0) for t in ids)
    assert not reqtrace.sampled(None, rate=1.0)
    for rate in (0.01, 0.25, 0.5, 0.9):
        assert [reqtrace.sampled(t, rate=rate) for t in ids] == \
            [jax_reqtrace.sampled(t, rate=rate) for t in ids]
    assert reqtrace.SEGMENTS == jax_reqtrace.SEGMENTS


# -- the tail-exemplar ring ---------------------------------------------------


def _fill(module):
    ring = module.ExemplarRing(capacity=4, window=16, min_samples=4)
    marks = [("queue", 10.0, 0.001), ("device", 10.001, 0.040)]
    notes = [ring.note("shadow-1", 9.9, marks=marks, t0=10.0,
                       budget_s=0.1, shadow=True)]
    for i in range(10):
        notes.append(ring.note("slow-%d" % i, 0.5, marks=marks, t0=10.0,
                               slo_class="interactive", budget_s=0.1,
                               kind="host", extra={"hedges": 0}))
    notes.append(ring.note("fast", 0.001, marks=marks, t0=10.0,
                           budget_s=0.1))
    return ring, notes


def test_exemplar_ring_bound_and_shadow_exclusion():
    ring, notes = _fill(reqtrace)
    assert notes[0] is False and all(notes[1:11]) and not notes[11]
    snap = ring.snapshot()
    assert snap["capacity"] == 4
    assert len(snap["entries"]) == 4
    assert snap["kept"] == 10
    assert snap["seen"] == 11
    entry = snap["entries"][-1]
    assert entry["trace"] == "slow-9"
    assert entry["over"] == "budget"
    assert [m["seg"] for m in entry["timeline"]] == ["queue", "device"]
    assert entry["timeline"][1]["dur_s"] == pytest.approx(0.040)
    assert entry["hedges"] == 0
    ring.clear()
    assert ring.snapshot()["entries"] == []


def test_exemplar_rings_equal_jax():
    (port, port_notes), (jax, jax_notes) = _fill(reqtrace), \
        _fill(jax_reqtrace)
    assert port_notes == jax_notes

    def untimed(snap):
        # an entry's ``ts`` is the wall time it was noted
        return dict(snap, entries=[{k: v for k, v in e.items() if k != "ts"}
                                   for e in snap["entries"]])

    assert untimed(port.snapshot()) == untimed(jax.snapshot())


# -- the fronts ---------------------------------------------------------------


def test_http_front_propagates_and_echoes_trace_id():
    """The route's body field or ``X-Trace-Id`` header is echoed; an id
    that fails normalization is replaced by a minted one."""
    svc = ServeService(_engine(seed=11), max_delay_s=0.002)
    svc.batcher.start()
    try:
        row = numpy.zeros(16, numpy.float32).tolist()

        def post(body, headers=None):
            status, _, answer = svc._app(
                "POST", "/infer", dict(headers or {}),
                json.dumps(body).encode())
            assert status == 200, answer
            return answer

        assert post({"input": row, "trace": "cli-http-1"})["trace"] == \
            "cli-http-1"
        assert post({"input": row},
                    {"X-Trace-Id": "hdr-trace-2"})["trace"] == \
            "hdr-trace-2"
        answer = post({"input": row, "trace": "bad id!"})
        assert answer["trace"] != "bad id!"
        assert reqtrace.normalize_trace_id(answer["trace"])
        assert reqtrace.normalize_trace_id(post({"input": row})["trace"])
    finally:
        svc.stop()


@pytest.mark.transport
def test_binary_front_hello_default_and_per_frame_override():
    batcher = ContinuousBatcher(_engine(seed=12),
                                max_delay_s=0.002).start()
    server = BinaryTransportServer(batcher, port=None,
                                   host_meta={"host_id": "h0"})
    server.start_background()
    client = None
    try:
        ours, theirs = socket.socketpair()
        server.serve_socket(ours)
        client = BinaryTransportClient(sock=theirs, shm=False, trace=True)
        x = numpy.zeros(16, numpy.float32)
        assert client.infer(x).shape == (1, 4)
        assert reqtrace.normalize_trace_id(client.last_trace)
        client.infer(x, trace="cli-bin.7")
        assert client.last_trace == "cli-bin.7"
        segs = client.last_segments
        assert isinstance(segs, dict)
        for seg in ("queue", "assemble", "h2d", "device", "d2h"):
            assert seg in segs and segs[seg] >= 0.0
        assert set(segs) <= set(reqtrace.SEGMENTS)
        client.infer(x, trace="not ok!")
        assert client.last_trace != "not ok!"
        assert reqtrace.normalize_trace_id(client.last_trace)
    finally:
        if client is not None:
            client.close()
        server.stop()
        batcher.stop()


# -- the SLO violation and the analyzer ---------------------------------------


@pytest.mark.chaos
def test_slo_violation_dump_carries_exemplar_timeline(tmp_path):
    """A stalled request breaches the SLO watch: the entering edge's
    flight dump carries its timeline, JAX's validator accepts the dump,
    and both packages' analyzers fold it alike."""
    from veles_tpu.observe.flight import validate_flight
    batcher = ContinuousBatcher(_engine(seed=13), max_delay_s=0.002,
                                slo_p99_ms=1.0, slo_check_every=1).start()
    chaos.install(chaos.FaultPlan(seed=1).add(
        "serve.stall", "stall", nth=1, param=0.15))

    def dumped():
        return list(tmp_path.glob(
            "veles_flight.serve.slo_violation.*.json"))

    try:
        req = batcher.submit(numpy.zeros(16, numpy.float32),
                             slo_class="interactive", trace="slo-breach-1")
        assert req.done.wait(10) and req.error is None
        _wait_for(lambda: bool(dumped()), what="SLO-violation dump")
    finally:
        chaos.uninstall()
        batcher.stop()
    doc = json.loads(dumped()[0].read_text())
    validate_flight(doc)
    assert doc["reason"] == "serve.slo_violation"
    mine = [e for e in doc["exemplars"]["entries"]
            if e["trace"] == "slo-breach-1"]
    assert mine
    assert {"queue", "device"} <= {m["seg"] for m in mine[0]["timeline"]}
    assert mine[0]["class"] == "interactive"
    report = reqtrace.analyze_files([str(dumped()[0])])
    assert report["exemplars"] >= 1
    assert "device" in report["segments"]
    assert _without_paths(report) == _without_paths(
        jax_reqtrace.analyze_files([str(dumped()[0])]))


@pytest.mark.chaos
def test_analyzer_attributes_tail_to_device_stall(tmp_path):
    batcher = ContinuousBatcher(_engine(seed=14),
                                max_delay_s=0.002).start()
    tracer.start()
    try:
        x = numpy.zeros(16, numpy.float32)
        for i in range(12):
            req = batcher.submit(x, trace="fast-%d" % i)
            assert req.done.wait(10) and req.error is None
        chaos.install(chaos.FaultPlan(seed=2).add(
            "serve.device.stall", "stall", nth=1, param=0.25))
        try:
            req = batcher.submit(x, trace="tail-dev-1")
            assert req.done.wait(10) and req.error is None
        finally:
            chaos.uninstall()
    finally:
        tracer.stop()
        batcher.stop()
    path = tracer.save(str(tmp_path / "serve_trace.json"))
    validate_trace(json.loads(open(path).read()))
    report = reqtrace.analyze_files([path])
    assert report["requests"] == 13
    assert report["segments"]["device"]["max_ms"] >= 200.0
    worst = report["tail"]["worst"]
    assert worst["trace"] == "tail-dev-1"
    assert worst["dominant"] == "device"
    assert report["tail"]["dominant"].get("device", 0) >= 1
    assert _without_paths(report) == _without_paths(
        jax_reqtrace.analyze_files([path]))


# -- the fleet ----------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.fleet
def test_hedged_two_leg_stitch_under_one_id(tmp_path):
    """A stalled primary forces a hedge: the timeline holds the fleet
    parent, a leg span on each of two hosts and the winning host's
    request span, all under one id, and the analyzer folds the split
    front and host files into one request."""
    plans, params = _mlp_spec(seed=3)
    hosts = _Hosts(2, plans, params)
    router = FleetRouter(hedge_factor=1.5, hedge_floor_s=0.05,
                         hedge_tick_s=0.01).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
        x = numpy.random.RandomState(4).rand(3, 16).astype(numpy.float32)
        for i in range(router.hedge_warmup):
            router.infer(x[i % 2], timeout=15.0)
        sampled = _counter("serve.reqtrace.sampled")
        tracer.start()
        chaos.install(chaos.FaultPlan(seed=1).add(
            "serve.host.stall", "stall", nth=1, param=2.0))
        try:
            out = router.infer(x[2], timeout=15.0, trace="stitch-1")
            assert out.shape == (4,)
            _wait_for(lambda: _counter("serve.reqtrace.sampled")
                      >= sampled + 2, what="request-span emission")
        finally:
            chaos.uninstall()
            tracer.stop()
    finally:
        router.stop()
        hosts.stop()

    events = tracer.events
    validate_trace({"traceEvents": events})
    named = lambda e: (e.get("args") or {})  # noqa: E731
    fleet_req = [e for e in events
                 if e.get("name") == reqtrace.REQUEST_SPAN
                 and named(e).get("tier") == "fleet"]
    assert len(fleet_req) == 1
    assert named(fleet_req[0])["trace"] == "stitch-1"
    assert named(fleet_req[0])["hedges"] >= 1
    legs = [e for e in events if e.get("name") == reqtrace.LEG_SPAN]
    assert len(legs) >= 2
    assert len({named(e).get("host") for e in legs}) == 2
    host_req = [e for e in events
                if e.get("name") == reqtrace.REQUEST_SPAN
                and named(e).get("tier") == "host"]
    assert host_req
    assert all(named(e)["trace"] == "stitch-1" for e in host_req)
    assert all(named(e).get("host") in ("h0", "h1") for e in host_req)

    saved = json.loads(open(tracer.save(str(tmp_path / "all.json"))).read())
    other = saved["otherData"]
    front, host = [], []
    for e in events:
        if e.get("ph") == "i" or named(e).get("tier") == "fleet" or \
                e.get("name") == reqtrace.LEG_SPAN:
            front.append(e)
        elif e.get("cat") == "req":
            host.append(e)
    paths = []
    for label, evts in (("front", front), ("host0", host)):
        path = tmp_path / (label + ".json")
        path.write_text(json.dumps({"traceEvents": evts,
                                    "otherData": dict(other, label=label)}))
        paths.append(str(path))
    report = reqtrace.analyze_files(paths)
    assert report["files"] == ["front", "host0"]
    assert report["requests"] == 1
    assert report["legs"] >= 3
    assert report["hedge"]["fired"] >= 1
    assert report["hedge"]["hedged_requests"] == 1
    assert report["tail"]["worst"]["trace"] == "stitch-1"
    assert "device" in report["segments"]
    assert _without_paths(report) == _without_paths(
        jax_reqtrace.analyze_files(paths))


@pytest.mark.chaos
@pytest.mark.fleet
def test_requeue_latency_anchored_at_original_arrival():
    """Requests wedged on a host that dies are requeued to the
    survivor; their latency runs from the original arrival (the
    host-scoped ``serve.host.stall:h0`` wedges only h0)."""
    plans, params = _mlp_spec(seed=3)
    hosts = _Hosts(2, plans, params)
    router = FleetRouter(hedge=False).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
        x = numpy.random.RandomState(5).rand(6, 16).astype(numpy.float32)
        ref = hosts.entries[0][0].infer(x)
        requeues_before = _counter("serve.fleet.requeues")
        chaos.install(chaos.FaultPlan(seed=2).add(
            "serve.host.stall:h0", "stall", times=8, param=5.0))
        try:
            t0 = time.perf_counter()
            reqs = [router.submit(row, trace="rq-%d" % i)
                    for i, row in enumerate(x)]
            time.sleep(0.3)
            hosts.stop(0)
            for req in reqs:
                assert req.done.wait(20), "request dropped"
                assert req.error is None, req.error
            elapsed = time.perf_counter() - t0
        finally:
            chaos.uninstall()
        for req, want in zip(reqs, ref):
            assert (req.result == want).all()
        requeued = [r for r in reqs if r.requeues >= 1]
        assert requeued
        assert _counter("serve.fleet.requeues") > requeues_before
        for req in requeued:
            assert req.latency >= 0.28, req.latency
            assert req.latency <= elapsed + 0.05
    finally:
        router.stop()
        hosts.stop(1)
