"""The port's single-host serve tier (veles_tpu_torch/serve: batcher,
router, service) against the JAX package's, on the CPU.

- The batcher cases of tests/test_serve.py: batched answers equal
  sequential ones bit for bit (a padded tail included), padding never
  leaks, the SLO watch trips under ``serve.stall``, overload sheds with a
  ``retry_after`` (a full queue, ``serve.drop``), ``serve.oom`` caps the
  ladder and replays bit for bit, the HTTP front's round trip, /healthz,
  /metrics.json and its 503; plus shadow traffic kept out of the served
  counters and an engine hot swap between batches.
- The router cases of tests/test_serve_router.py: every replica equals
  the single engine bit for bit, the least-loaded pick avoids a stalled
  replica, overload cascades then sheds with the smallest retry_after,
  metrics aggregate, hot reloads under closed-loop load drop nothing, the
  single-engine service reloads, the service drives a pool.
- One snapshot served by both packages (written by either): the port's
  HTTP answers within 1e-5 of the JAX service's.
- ``format_result``'s bodies equal the JAX package's, byte for byte
  through the HTTP front's JSON encoding (tornado's).
- ``python -m veles_tpu_torch.serve --fleet-host`` and ``--fleet`` as
  child processes: the front's HTTP answers equal the host's own.
- On a card (``cuda``): two replicas share ``cuda:0`` and answer as the
  single engine (bit for bit at one rung, within 1e-5 across rungs),
  and a reload under load drops nothing.

The CPU forward has no captured graphs, so a receipt's ``captures`` and
``new_compiles`` are 0 there; the card's test holds the captures.
Every test that starts a thread or a server stops it in ``finally``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch import chaos
from veles_tpu_torch.backends import Device
from veles_tpu_torch.compiler import LayerPlan
from veles_tpu_torch.observe.metrics import registry
from veles_tpu_torch.serve import (
    AOTEngine, ContinuousBatcher, ReplicaPool, ServeOverload,
    ServeService, format_result, serve_snapshot)

pytestmark = pytest.mark.serve

CPU = Device(backend="cpu")
#: the JAX and port forwards differ by summation order only
CROSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_chaos_off():
    """A fault plan left installed by a failing test must not reach the
    next one."""
    yield
    chaos.uninstall()


def _mlp_spec(seed=0, fan_in=16, hidden=16, classes=4):
    """tests/test_serve.py's random MLP, on the port's classes."""
    from veles_tpu_torch.models.all2all import All2AllSoftmax, All2AllTanh
    rng = numpy.random.RandomState(seed)
    plans = [LayerPlan(All2AllTanh), LayerPlan(All2AllSoftmax)]
    params = [
        {"weights": rng.rand(fan_in, hidden).astype(numpy.float32),
         "bias": rng.rand(hidden).astype(numpy.float32)},
        {"weights": rng.rand(hidden, classes).astype(numpy.float32),
         "bias": rng.rand(classes).astype(numpy.float32)},
    ]
    return plans, params


@pytest.fixture(scope="module")
def engine():
    """The ladder starts at 8: on the CPU rung 1 may take another
    matrix-vector kernel and differ by an ulp (engine.py)."""
    plans, params = _mlp_spec()
    eng = AOTEngine(plans, params, (16,), ladder=(8, 32), device=CPU)
    eng.compile()
    return eng


def _co_batch(batcher, samples, timeout=30.0):
    requests = [batcher.submit(s) for s in samples]
    results, errors = [], []
    for i, req in enumerate(requests):
        if not req.done.wait(timeout):
            errors.append((i, TimeoutError("request %d timed out" % i)))
            results.append(None)
        elif req.error is not None:
            errors.append((i, req.error))
            results.append(None)
        else:
            results.append(req.result)
    return results, errors


def _post(url, body, timeout=10):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


# -- the batcher --------------------------------------------------------------


def test_batched_bit_identical_to_sequential(engine):
    rng = numpy.random.RandomState(1)
    samples = rng.rand(13, 16).astype(numpy.float32)
    sequential = numpy.stack(
        [engine.infer(samples[i])[0] for i in range(len(samples))])
    hist = registry.histogram("serve.batch_size")
    hist.reset()
    batcher = ContinuousBatcher(engine, max_delay_s=0.5).start()
    try:
        results, errors = _co_batch(batcher, list(samples))
    finally:
        batcher.stop()
    assert not errors, errors
    batched = numpy.stack(results)
    assert (batched == sequential).all(), \
        numpy.abs(batched - sequential).max()
    assert hist.count >= 1 and max(hist.window_values()) > 1


def test_padded_tail_never_leaks(engine):
    rng = numpy.random.RandomState(2)
    x = rng.rand(5, 16).astype(numpy.float32)
    zeros = numpy.zeros((8, 16), numpy.float32)
    zeros[:5] = x
    garbage = rng.rand(8, 16).astype(numpy.float32) * 1e3
    garbage[:5] = x
    out_zeros = engine.run(CPU.put(zeros), 8)[:5]
    out_garbage = engine.run(CPU.put(garbage), 8)[:5]
    assert torch.equal(out_zeros, out_garbage)


def test_engine_sequential_shapes(engine):
    rng = numpy.random.RandomState(3)
    assert engine.infer(rng.rand(16).astype(numpy.float32)).shape == (1, 4)
    big = rng.rand(70, 16).astype(numpy.float32)
    out = engine.infer(big)
    assert out.shape == (70, 4)
    ref = numpy.stack([engine.infer(big[i])[0] for i in range(70)])
    assert (out == ref).all()


@pytest.mark.chaos
def test_slo_violations_fire_under_stall(engine):
    before = registry.counter("serve.slo_violations").value
    chaos.install(chaos.FaultPlan(seed=1).add("serve.stall", "stall",
                                              param=0.06))
    batcher = ContinuousBatcher(engine, max_delay_s=0.001,
                                slo_p99_ms=10.0, slo_check_every=1)
    batcher.start()
    try:
        for _ in range(3):
            batcher.infer(numpy.zeros(16, numpy.float32))
    finally:
        batcher.stop()
        chaos.uninstall()
    assert registry.counter("serve.slo_violations").value > before
    snap = serve_snapshot()
    assert snap["slo_violations"] > 0
    assert snap["p99_ms"] > 10.0


@pytest.mark.chaos
def test_overload_sheds_with_retry_after(engine):
    chaos.install(chaos.FaultPlan(seed=1).add("serve.stall", "stall",
                                              param=0.2))
    batcher = ContinuousBatcher(engine, max_delay_s=0.0, max_queue=2)
    batcher.start()
    shed = []
    try:
        for _ in range(30):
            try:
                batcher.submit(numpy.zeros(16, numpy.float32))
            except ServeOverload as exc:
                shed.append(exc)
    finally:
        batcher.stop()
        chaos.uninstall()
    assert shed, "the queue grew without bound"
    assert all(exc.retry_after > 0 for exc in shed)
    chaos.install(chaos.FaultPlan(seed=1).add("serve.drop", "drop",
                                              nth=1))
    batcher = ContinuousBatcher(engine).start()
    try:
        with pytest.raises(ServeOverload):
            batcher.submit(numpy.zeros(16, numpy.float32))
        assert batcher.infer(
            numpy.zeros(16, numpy.float32)).shape == (4,)
    finally:
        batcher.stop()
        chaos.uninstall()


@pytest.mark.chaos
def test_oom_degrades_ladder_and_replays(engine):
    rng = numpy.random.RandomState(5)
    samples = rng.rand(13, 16).astype(numpy.float32)
    sequential = numpy.stack(
        [engine.infer(samples[i])[0] for i in range(len(samples))])
    chaos.install(chaos.FaultPlan(seed=1).add("serve.oom", "oom", nth=1))
    batcher = ContinuousBatcher(engine, max_delay_s=0.5).start()
    try:
        results, errors = _co_batch(batcher, list(samples))
        assert not errors, errors
        assert (numpy.stack(results) == sequential).all()
        assert batcher._rung_cap == 8
        assert registry.gauge("serve.rung_cap").value == 8
    finally:
        batcher.stop()
        chaos.uninstall()


def test_oom_error_of_the_card_is_oom_shaped():
    from veles_tpu_torch.serve.batcher import _oom_shaped
    assert _oom_shaped(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert _oom_shaped(MemoryError())
    assert not _oom_shaped(ValueError("shape"))


def test_shadow_requests_stay_out_of_served_counters(engine):
    served = registry.counter("serve.requests").value
    batcher = ContinuousBatcher(engine, max_delay_s=0.0).start()
    try:
        x = numpy.random.RandomState(9).rand(16).astype(numpy.float32)
        shadow = batcher.submit_shadow(x)
        assert shadow is not None and shadow.done.wait(10)
        assert shadow.error is None and shadow.latency is not None
        assert (shadow.result == engine.infer(x)[0]).all()
        assert registry.counter("serve.requests").value == served
        batcher.infer(x)
        assert registry.counter("serve.requests").value == served + 1
    finally:
        batcher.stop()
    # a stopped batcher drops shadows instead of raising
    assert batcher.submit_shadow(x) is None


def test_swap_engine_applies_between_batches(engine):
    plans, params = _mlp_spec(seed=3)
    other = AOTEngine(plans, params, (16,), ladder=(8, 32), device=CPU)
    with pytest.raises(RuntimeError):
        ContinuousBatcher(engine).swap_engine(other)  # not compiled
    other.compile()
    x = numpy.random.RandomState(10).rand(16).astype(numpy.float32)
    batcher = ContinuousBatcher(engine, max_delay_s=0.0).start()
    try:
        assert (batcher.infer(x) == engine.infer(x)[0]).all()
        batcher.swap_engine(other)
        deadline = time.time() + 5
        while batcher.engine is not other and time.time() < deadline:
            time.sleep(0.01)
        assert batcher.engine is other
        assert (batcher.infer(x) == other.infer(x)[0]).all()
    finally:
        batcher.stop()


def test_service_http_roundtrip_and_healthz(engine):
    svc = ServeService(engine, labels_mapping={0: "a", 1: "b", 2: "c",
                                               3: "d"},
                       max_delay_s=0.002)
    svc.start_background()
    try:
        base = "http://127.0.0.1:%d" % svc.port
        batch = numpy.random.RandomState(6).rand(3, 16).astype(
            numpy.float32)
        answer = _post(base + "/infer", {"input": batch.tolist()})
        assert len(answer["result"]) == 3
        assert set(answer["result"]) <= {"a", "b", "c", "d"}
        ref = engine.infer(batch)
        # float32 -> JSON -> float32 is lossless
        assert (numpy.asarray(answer["probabilities"],
                              numpy.float32) == ref).all()
        health = _get(base + "/healthz")
        assert health["compile"]["rungs"] == [8, 32]
        assert "queue_depth" in health["serve"]
        assert health["model_digest"] == engine.digest
        metrics = _get(base + "/metrics.json")
        assert "serve.latency_s" in metrics["histograms"]
        assert "http.request_s" in metrics["histograms"]
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(base + "/infer", {"no_input": 1})
        assert info.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(base + "/publish", {})
        assert info.value.code == 409
    finally:
        svc.stop()


@pytest.mark.chaos
def test_service_answers_503_on_shed(engine):
    chaos.install(chaos.FaultPlan(seed=1).add("serve.drop", "drop"))
    svc = ServeService(engine)
    svc.start_background()
    try:
        with pytest.raises(urllib.error.HTTPError) as info:
            _post("http://127.0.0.1:%d/infer" % svc.port,
                  {"input": [0.0] * 16})
        assert info.value.code == 503
        body = json.loads(info.value.read())
        assert body["retry_after"] > 0
        assert info.value.headers.get("Retry-After") is not None
    finally:
        svc.stop()
        chaos.uninstall()


def test_format_result_contract_and_bodies_equal_jax():
    """The port's format_result is the JAX package's, and the HTTP
    front's JSON text equals tornado's for the same answer."""
    from tornado.escape import json_encode
    from veles_tpu.serve import format_result as jax_format_result
    from veles_tpu_torch.http_util import json_body

    probs = numpy.array([[0.1, 0.9], [0.8, 0.2]], numpy.float32)
    out = format_result(probs, {0: "a", 1: "b"})
    assert out["result"] == ["b", "a"]
    assert out["probabilities"] == probs.tolist()
    unmapped = format_result(probs)
    assert unmapped["result"] == [1, 0]
    assert all(isinstance(label, int) for label in unmapped["result"])
    assert format_result(probs[0])["result"] == 1
    assert format_result(probs[:1], {0: "a", 1: "b"})["result"] == "b"
    assert format_result(probs.tolist())["result"] == [1, 0]
    rng = numpy.random.RandomState(12)
    for block in (probs, probs[0], probs[:1], rng.rand(5, 7).astype(
            numpy.float32)):
        for mapping in (None, {0: "a", 1: "</b>"}):
            mine = format_result(block, mapping)
            theirs = jax_format_result(block, mapping)
            assert mine == theirs
            assert json_body(mine) == json_encode(theirs).encode()


# -- the router ---------------------------------------------------------------


def _pool(replicas=3, ladder=(8, 32), seed=11, **kwargs):
    plans, params = _mlp_spec(seed=seed)
    pool = ReplicaPool(plans, params, (16,), replicas=replicas,
                       ladder=ladder, backend="cpu", **kwargs)
    pool.compile()
    return pool


def test_local_devices_cycle_and_refuse_without_a_card():
    from veles_tpu_torch.serve.router import local_devices
    devices = local_devices(3, backend="cpu")
    assert [d.backend for d in devices] == ["cpu"] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_devices(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReplicaPool(*_mlp_spec(), (16,), replicas=2)


def test_replicas_bit_identical_to_single_replica():
    pool = _pool(replicas=3)
    assert pool.compile_receipt["replicas"] == 3
    assert len({id(rep.engine) for rep in pool.replicas}) == 3
    pool.start()
    try:
        x = numpy.random.RandomState(1).rand(9, 16).astype(numpy.float32)
        ref = pool.engine.infer(x)
        for rep in pool.replicas:
            out = numpy.stack([rep.batcher.infer(x[i])
                               for i in range(len(x))])
            assert (out == ref).all(), "replica %d diverged" % rep.index
        routed = numpy.stack([pool.infer(x[i]) for i in range(len(x))])
        assert (routed == ref).all()
        block = pool.infer_block(numpy.ascontiguousarray(x[:8]))
        assert (block == ref[:8]).all()
    finally:
        pool.stop()


@pytest.mark.chaos
def test_least_loaded_pick_avoids_stalled_replica():
    pool = _pool(replicas=2, max_delay_s=0.0)
    chaos.install(chaos.FaultPlan(seed=1).add("serve.stall", "stall",
                                              param=0.4))
    pool.start()
    rep0 = pool.replicas[0]
    try:
        zeros = numpy.zeros(16, numpy.float32)
        stalled = [rep0.batcher.submit(zeros)]
        time.sleep(0.08)  # rep0's worker pops it and stalls 0.4 s
        stalled += [rep0.batcher.submit(zeros) for _ in range(2)]
        assert rep0.batcher._q.qsize() >= 2
        routed = pool.submit(numpy.ones(16, numpy.float32))
        assert routed not in list(rep0.batcher._q.queue)
        assert routed.done.wait(10)
        assert routed.error is None
        for req in stalled:
            assert req.done.wait(10)
    finally:
        pool.stop()
        chaos.uninstall()


@pytest.mark.chaos
def test_overload_cascades_then_503():
    pool = _pool(replicas=2)
    pool.start()
    zeros = numpy.zeros(16, numpy.float32)
    try:
        before = registry.counter("serve.router.cascades").value
        chaos.install(chaos.FaultPlan(seed=1).add("serve.drop", "drop",
                                                  nth=1))
        assert pool.infer(zeros).shape == (4,)
        assert registry.counter("serve.router.cascades").value \
            == before + 1
        chaos.uninstall()
        chaos.install(chaos.FaultPlan(seed=1).add("serve.drop", "drop"))
        with pytest.raises(ServeOverload) as info:
            pool.submit(zeros)
        assert info.value.retry_after > 0
    finally:
        pool.stop()
        chaos.uninstall()


def test_metrics_aggregate_across_replicas():
    requests_before = registry.counter("serve.requests").value
    pool = _pool(replicas=2)
    pool.start()
    try:
        rng = numpy.random.RandomState(3)
        for _ in range(12):
            pool.infer(rng.rand(16).astype(numpy.float32))
    finally:
        pool.stop()
    assert registry.counter("serve.requests").value \
        >= requests_before + 12
    assert registry.peek("serve.replica.0.queue_depth") is not None
    assert registry.peek("serve.replica.1.queue_depth") is not None
    snap = serve_snapshot()
    assert snap["replicas"] == 2
    assert len(snap["replica_queue_depths"]) == 2
    assert snap["queue_depth"] == sum(snap["replica_queue_depths"])


def _closed_loop(pool, errors, stop, clients=4, served=None):
    def worker(k):
        x = numpy.random.RandomState(k).rand(16).astype(numpy.float32)
        while not stop.is_set():
            try:
                pool.infer(x, timeout=10.0)
                if served is not None:
                    served.append(1)
            except Exception as exc:  # every failure counts
                errors.append(exc)
    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    return threads


def test_hot_reload_under_load_zero_drops():
    plans, params = _mlp_spec(seed=17)
    pool = ReplicaPool(plans, params, (16,), replicas=2, ladder=(8, 32),
                       backend="cpu", max_delay_s=0.001, max_queue=4096)
    pool.compile()
    pool.start()
    errors, stop, served = [], threading.Event(), []
    threads = _closed_loop(pool, errors, stop, served=served)
    try:
        time.sleep(0.2)
        _, params2 = _mlp_spec(seed=99)
        receipt = pool.reload(params2)
        assert receipt["mode"] == "params"
        assert receipt["new_compiles"] == 0 and receipt["captures"] == 0
        assert receipt["digest"] == receipt["previous_digest"]
        time.sleep(0.2)
        probe = numpy.random.RandomState(5).rand(16).astype(numpy.float32)
        ref2 = pool.engine.infer(probe)[0]
        for rep in pool.replicas:
            assert (rep.batcher.infer(probe) == ref2).all()
        plans3, params3 = _mlp_spec(seed=5, hidden=24)
        receipt3 = pool.reload(params3, plans=plans3)
        assert receipt3["mode"] == "engine"
        assert receipt3["digest"] != receipt3["previous_digest"]
        deadline = time.time() + 5.0
        while time.time() < deadline and any(
                rep.batcher.engine.digest != receipt3["digest"]
                for rep in pool.replicas):
            time.sleep(0.05)
        for rep in pool.replicas:
            assert rep.batcher.engine.digest == receipt3["digest"]
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15)
        pool.stop()
    assert not errors, errors[:3]
    assert served
    ref_engine = AOTEngine(plans3, params3, (16,), ladder=(8, 32),
                           device=CPU)
    ref_engine.compile()
    probe = numpy.random.RandomState(6).rand(3, 16).astype(numpy.float32)
    assert (pool.engine.infer(probe) == ref_engine.infer(probe)).all()
    assert registry.counter("serve.reloads").value >= 2


def test_service_reload_single_engine():
    plans, params = _mlp_spec(seed=23)
    engine = AOTEngine(plans, params, (16,), ladder=(8,), device=CPU)
    engine.compile()
    svc = ServeService(engine, max_delay_s=0.001)
    svc.start_background()
    try:
        _, params2 = _mlp_spec(seed=24)
        receipt = svc.reload(params2)
        assert receipt["mode"] == "params"
        assert receipt["new_compiles"] == 0, receipt
        probe = numpy.random.RandomState(7).rand(16).astype(numpy.float32)
        answer = svc.infer_payload(probe)
        expect = svc.engine.infer(probe)[0]
        assert (numpy.asarray(answer["probabilities"][0],
                              numpy.float32) == expect).all()
        plans3, params3 = _mlp_spec(seed=25, hidden=24)
        receipt3 = svc.reload(params3, plans=plans3)
        assert receipt3["mode"] == "engine"
        assert svc.engine.digest == receipt3["digest"]
        deadline = time.time() + 5.0
        while time.time() < deadline and \
                svc.batcher.engine.digest != receipt3["digest"]:
            time.sleep(0.05)
        assert svc.batcher.engine.digest == receipt3["digest"]
        assert svc.last_reload is receipt3
    finally:
        svc.stop()


def test_service_over_pool_healthz_and_infer():
    pool = _pool(replicas=2, seed=29)
    svc = ServeService(pool, labels_mapping={0: "a", 1: "b", 2: "c",
                                             3: "d"})
    svc.start_background()
    try:
        base = "http://127.0.0.1:%d" % svc.port
        batch = numpy.random.RandomState(8).rand(3, 16).astype(
            numpy.float32)
        answer = _post(base + "/infer", {"input": batch.tolist()})
        ref = pool.engine.infer(batch)
        assert (numpy.asarray(answer["probabilities"],
                              numpy.float32) == ref).all()
        health = _get(base + "/healthz")
        assert health["replicas"]["replicas"] == 2
        assert health["replicas"]["devices"] == ["cpu:0", "cpu:0"]
        assert health["model_digest"] == pool.digest
        assert health["compile"]["replicas"] == 2
    finally:
        svc.stop()


# -- one snapshot, both packages -------------------------------------------


def _jax_service(sw, sample_shape):
    from veles_tpu.serve import ReplicaPool as JaxPool
    from veles_tpu.serve import ServeService as JaxService
    pool = JaxPool.from_workflow(sw, replicas=1, ladder=(8,),
                                 sample_shape=sample_shape)
    pool.compile()
    return JaxService(pool)


def _port_service(sw, sample_shape):
    pool = ReplicaPool.from_workflow(sw, replicas=1, ladder=(8,),
                                     backend="cpu",
                                     sample_shape=sample_shape)
    pool.compile()
    return ServeService(pool)


def _answers(svc, x):
    svc.start_background()
    try:
        base = "http://127.0.0.1:%d" % svc.port
        return [_post(base + "/infer", {"input": row.tolist()})
                for row in (x, x[0])]
    finally:
        svc.stop()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_snapshot_served_by_both_packages(tmp_path, writer):
    """A snapshot of the CLI blobs workflow, written by either package,
    restored by each and served over HTTP: the port's probabilities
    within 1e-5 of the JAX service's, the labels equal."""
    import gzip

    from tests.test_torch_snapshot import (_PortToJax, _cli_blobs,
                                           _jax_cli_workflow,
                                           _jax_snapshotter,
                                           _torch_cli_workflow)
    from veles_tpu.dummy import DummyLauncher as JaxLauncher
    from veles_tpu.workflow import restore_workflow as jax_restore
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.snapshotter import Snapshotter
    from veles_tpu_torch.workflow import restore_workflow

    with _cli_blobs(tmp_path, "jax" if writer == "jax" else "torch") \
            as module:
        if writer == "jax":
            sw = _jax_cli_workflow(module, max_epochs=2)
            sw.run()
            snap = _jax_snapshotter().Snapshotter(
                sw, directory=str(tmp_path), prefix="jax", interval=1,
                time_interval=0)
        else:
            sw = _torch_cli_workflow(module, max_epochs=2)
            sw.run()
            snap = Snapshotter(sw, directory=str(tmp_path), prefix="port",
                               interval=1, time_interval=0,
                               compression="gz")
        snap.initialize()
        snap.export()
    x = numpy.random.RandomState(13).randn(5, 8).astype(numpy.float32)
    with _cli_blobs(tmp_path, "jax"):
        if writer == "jax":
            jsw = jax_restore(snap.destination, JaxLauncher())
        else:
            with gzip.open(snap.destination) as fin:
                jsw = _PortToJax(fin).load()
        want = _answers(_jax_service(jsw, (8,)), x)
    with _cli_blobs(tmp_path, "torch"):
        tsw = restore_workflow(snap.destination, DummyLauncher())
        got = _answers(_port_service(tsw, (8,)), x)
    for mine, theirs in zip(got, want):
        assert mine["result"] == theirs["result"]
        numpy.testing.assert_allclose(
            numpy.asarray(mine["probabilities"]),
            numpy.asarray(theirs["probabilities"]), rtol=0,
            atol=CROSS_TOL)


# -- the serve command ------------------------------------------------------


def _serve_command(args, env_extra=None):
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
               **(env_extra or {}))
    env.pop("VELES_BACKEND", None)
    return subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch.serve"] + list(args),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)


def test_serve_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _serve_command(["--demo", "--port", "0", "--duration", "1"])
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert proc.returncode != 0
    assert "no CUDA device" in err
    # the fleet host role runs on the card too, and refuses without one
    proc = _serve_command(["--demo", "--fleet-host", "--duration", "1"])
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert proc.returncode != 0
    assert "no CUDA device" in err


def test_fleet_host_and_front_commands_answer_alike():
    """``--demo --fleet-host -d cpu`` prints its READY line (captures
    and builds 0 on the CPU) and ``--fleet HOST:PORT`` fronts it: the
    front's HTTP answers equal the host's own over its transport, and
    ``/healthz`` carries the fleet block and the router's alerts.  A
    SIGTERM stops the host cleanly, with its launch line."""
    import signal

    from veles_tpu_torch.serve import BinaryTransportClient
    # the ladder starts at 8: on the CPU rung 1 may differ by an ulp
    host = _serve_command(["--demo", "--fleet-host", "--host-id", "c0",
                           "-d", "cpu", "--ladder", "8,32",
                           "--duration", "120"])
    front = None
    try:
        line = ""
        while not line.startswith("FLEET_HOST_READY"):
            line = host.stdout.readline()
            assert line, host.stderr.read()[-2000:]
        fields = dict(f.split("=", 1) for f in line.split()[1:])
        assert fields["host_id"] == "c0"
        assert fields["new_compiles"] == fields["kernel_builds"] == \
            fields["captures"] == "0"
        front = _serve_command(["--fleet", "127.0.0.1:" + fields["port"],
                                "--port", "0", "--duration", "120"])
        line = ""
        while not line.startswith("fleet front on"):
            line = front.stdout.readline()
            assert line, front.stderr.read()[-2000:]
        url = "http://127.0.0.1:%d" % int(line.split(":")[2].split("/")[0])
        x = numpy.random.RandomState(4).rand(5, 16).astype(numpy.float32)
        got = numpy.asarray(_post(url + "/infer", {"input": x.tolist()},
                                  timeout=30)["probabilities"],
                            numpy.float32)
        direct = BinaryTransportClient(port=int(fields["port"]), shm=False)
        try:
            want = direct.infer(x)
        finally:
            direct.close()
        assert numpy.array_equal(got, want)
        health = _get(url + "/healthz", timeout=30)
        assert health["fleet"]["hosts_live"] == 1
        assert health["fleet"]["digest"] == fields["digest"]
        assert "alerts" in health and health["model_digest"] == \
            fields["digest"]
    finally:
        for proc, sig in ((front, signal.SIGINT), (host, signal.SIGTERM)):
            if proc is not None and proc.poll() is None:
                proc.send_signal(sig)
        outs = []
        for proc in (front, host):
            if proc is None:
                continue
            try:
                outs.append(proc.communicate(timeout=60)[0])
            except Exception:
                proc.kill()
                outs.append(proc.communicate(timeout=30)[0])
    assert host.returncode == 0 and front.returncode == 0
    assert "FLEET_HOST_STOPPED host_id=c0 launches=" in outs[-1]


def test_serve_command_serves_a_sequence_snapshot(tmp_path):
    """``python -m veles_tpu_torch.serve --snapshot <an LSTM workflow
    snapshot> -d cpu --replicas 2`` answers HTTP requests equal to the
    in-process forward of the snapshot's weights."""
    import signal

    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.examples import sequence
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.snapshotter import Snapshotter
    saved = root.sequence.max_epochs
    root.sequence.max_epochs = 1
    try:
        launcher = Launcher()
        sw = sequence.build(launcher)
    finally:
        root.sequence.max_epochs = saved
    prng.get().seed(1234567890)
    launcher.initialize(device="cpu")
    launcher.run()
    snap = Snapshotter(sw, directory=str(tmp_path), prefix="sequence",
                       interval=1, time_interval=0, compression="gz")
    snap.initialize()
    snap.export()
    plans, params, shape = ReplicaPool._workflow_spec(sw)
    assert shape == (8, 8)
    engine = AOTEngine(plans, params, shape, ladder=(1, 8), device=CPU)
    engine.compile()
    x = numpy.random.RandomState(9).rand(9, 8, 8).astype(numpy.float32)
    proc = _serve_command(["--snapshot", snap.destination, "-d", "cpu",
                           "--port", "0", "--replicas", "2", "--ladder",
                           "1,8", "--duration", "120"])
    try:
        line = ""
        while not line.startswith("serving on"):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-2000:]
        port = int(line.split(":")[2].split("/")[0])
        url = "http://127.0.0.1:%d" % port
        got = [_post(url + "/infer", {"input": x[i].tolist()}, timeout=30)
               for i in range(4)]
        block = _post(url + "/infer", {"input": x[4:].tolist()},
                      timeout=30)
        health = _get(url + "/healthz", timeout=30)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            proc.communicate(timeout=60)
        except Exception:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0
    want = engine.infer(x)
    probs = numpy.asarray([g["probabilities"][0] for g in got] +
                          block["probabilities"], numpy.float32)
    numpy.testing.assert_allclose(probs, want, rtol=0, atol=1e-6)
    assert [g["result"] for g in got] == want[:4].argmax(1).tolist()
    assert health["replicas"]["replicas"] == 2
    assert health["compile"]["rungs"] == [1, 8]


# -- two replicas on the card -------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replicas' graphs have no CPU "
                    "mode")


@pytest.mark.cuda
def test_cuda_two_replicas_share_the_card_bit_equal():
    _card()
    plans, params = _mlp_spec(seed=31)
    pool = ReplicaPool(plans, params, (16,), replicas=2, ladder=(8, 32))
    assert [str(rep.device.torch_device) for rep in pool.replicas] == \
        ["cuda:0", "cuda:0"]
    receipt = pool.compile()
    assert receipt["captures"] == 4  # 2 rungs x 2 replicas
    pool.start()
    try:
        x = numpy.random.RandomState(1).rand(40, 16).astype(numpy.float32)
        ref = pool.engine.infer(x)
        outs = [None] * len(x)

        def client(k):
            for i in range(k, len(x), 4):
                outs[i] = pool.infer(x[i])
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        # co-batched at whatever rung: cuBLAS takes other f32 kernels at
        # other batch sizes
        numpy.testing.assert_allclose(numpy.stack(outs), ref, rtol=1e-5,
                                      atol=1e-7)
        # alone, a sample rides rung 1 on either replica: bit for bit
        one = pool.engine.infer(x[:1])[0]
        for rep in pool.replicas:
            assert (rep.batcher.infer(x[0]) == one).all()
    finally:
        pool.stop()


@pytest.mark.cuda
def test_cuda_reload_under_load_drops_nothing():
    _card()
    plans, params = _mlp_spec(seed=33)
    pool = ReplicaPool(plans, params, (16,), replicas=2, ladder=(8, 32),
                       max_delay_s=0.001, max_queue=4096)
    pool.compile()
    pool.start()
    errors, stop, served = [], threading.Event(), []
    threads = _closed_loop(pool, errors, stop, served=served)
    try:
        time.sleep(0.2)
        receipt = pool.reload(_mlp_spec(seed=34)[1])
        assert receipt["mode"] == "params" and receipt["captures"] == 0
        plans3, params3 = _mlp_spec(seed=35, hidden=24)
        receipt3 = pool.reload(params3, plans=plans3)
        assert receipt3["mode"] == "engine"
        assert receipt3["captures"] == 4
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15)
        pool.stop()
    assert not errors, errors[:3]
    assert served
    ref = AOTEngine(plans3, params3, (16,), ladder=(8, 32), device=CPU)
    ref.compile()
    probe = numpy.random.RandomState(6).rand(3, 16).astype(numpy.float32)
    numpy.testing.assert_allclose(pool.engine.infer(probe),
                                  ref.infer(probe), rtol=1e-5, atol=1e-7)
