"""The port's train-to-serve freshness loop (veles_tpu_torch/serve/
freshness.py, the canary mechanics of serve/router.py and the publish
side of snapshotter.py) against the JAX package's, on the CPU.

- The single-host cases of tests/test_freshness.py: the publish
  contract (ordinals, an atomic LATEST, bounded retention), refusal of
  an unverifiable snapshot, a real Snapshotter publishing, the watcher's
  skip-and-retry of a torn publish (the ``freshness.publish`` chaos
  point), its TTL rejection, push notification and its retry of a cycle
  that failed after the publish verified; the canary replica out of
  rotation and out of the cascade, mirrored answers bit-equal with
  shadows kept out of the served counters, promote and the reload
  guard, rollback with no new capture, the EMA spike watch and the
  comparator's verdicts, the controller end to end (a good publish
  promoted, a NaN one never served, a class-permuted one rolled back),
  the single-replica direct reload, ``POST /publish`` and /healthz, and
  the idle pool probing itself to a verdict.
- A model spec that the JAX snapshotter published is picked up by the
  port's watcher and served within 1e-5 of the JAX engine.
- The ``crash`` action of ``freshness.publish`` burns the ordinal and
  leaves LATEST where it was; a schedule bank without a manifest that
  verifies is noted once and left alone (the merge of a verified bank is
  held in tests/test_torch_tune.py).

The JAX package's chaos soak (scripts/freshness_soak.py) is not ported.
Every test that starts a thread or a server stops it in ``finally``.
"""

import json
import logging
import os
import threading
import time
import urllib.request

import numpy
import pytest

from tests.test_torch_serve_tier import _mlp_spec
from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch import chaos
from veles_tpu_torch.backends import Device
from veles_tpu_torch.health import EmaSpikeWatch
from veles_tpu_torch.observe.metrics import registry
from veles_tpu_torch.serve import (
    AOTEngine, CanaryComparator, FreshnessController, ReplicaPool,
    ServeOverload, ServeService, SnapshotWatcher, export_model_spec,
    value_digest)
from veles_tpu_torch.snapshotter import (
    LATEST_NAME, MANIFEST_SUFFIX, SnapshotError, publish_snapshot,
    read_latest)

pytestmark = pytest.mark.freshness

CPU = Device(backend="cpu")


@pytest.fixture(autouse=True)
def _port_chaos_off():
    yield
    chaos.uninstall()


def _spec_path(tmp_path, name, params, plans=None, shape=(16,)):
    if plans is None:
        plans, _ = _mlp_spec()
    path = str(tmp_path / name)
    export_model_spec(path, plans, params, shape)
    return path


def _pool(replicas=3, ladder=(8,), seed=11, **kwargs):
    plans, params = _mlp_spec(seed=seed)
    pool = ReplicaPool(plans, params, (16,), replicas=replicas,
                       ladder=ladder, backend="cpu", max_delay_s=0.001,
                       max_queue=4096, **kwargs)
    pool.compile()
    return pool


def _controller(pool, tmp_path, **kwargs):
    kwargs.setdefault("poll_s", 0.02)
    kwargs.setdefault("min_mirrors", 4)
    kwargs.setdefault("mirror_fraction", 1.0)
    kwargs.setdefault("breach_budget", 2)
    kwargs.setdefault("verdict_timeout_s", 15.0)
    return FreshnessController(pool, str(tmp_path / "publish"), **kwargs)


def _perturb(params, scale=0.05, seed=3):
    rng = numpy.random.RandomState(seed)
    return [{k: v + scale * rng.randn(*v.shape).astype(v.dtype)
             for k, v in entry.items()} for entry in params]


def _drive(pool, n=40, seed=5):
    rng = numpy.random.RandomState(seed)
    samples = [rng.rand(16).astype(numpy.float32) for _ in range(n)]
    return samples, [numpy.array(pool.infer(x, timeout=15.0))
                     for x in samples]


def _permuted(params):
    """The output classes rolled: a model that answers the wrong
    question, invisible to a finite gate."""
    bad = [dict(e) for e in params]
    bad[-1] = {"weights": numpy.roll(params[-1]["weights"], 1, axis=1),
               "bias": numpy.roll(params[-1]["bias"], 1)}
    return bad


# -- publish contract ---------------------------------------------------------


def test_publish_contract_ordinals_latest_retention(tmp_path):
    plans, params = _mlp_spec(seed=1)
    pub = str(tmp_path / "pub")
    published_before = registry.counter("serve.freshness.published").value
    receipts = []
    for i in range(5):
        path = _spec_path(tmp_path, "s%d.pickle" % i,
                          _perturb(params, seed=i), plans)
        receipts.append(publish_snapshot(path, pub, keep=3))
    assert [r["ordinal"] for r in receipts] == [1, 2, 3, 4, 5]
    assert registry.counter("serve.freshness.published").value == \
        published_before + 5
    latest = read_latest(pub)
    assert latest["ordinal"] == 5
    assert latest["snapshot"].startswith("000005_")
    assert latest["sha256"] == receipts[-1]["sha256"]
    published = sorted(f for f in os.listdir(pub)
                       if f[0].isdigit() and
                       not f.endswith(MANIFEST_SUFFIX))
    assert [f.split("_")[0] for f in published] == \
        ["000003", "000004", "000005"]
    for f in published:
        assert os.path.exists(os.path.join(pub, f + MANIFEST_SUFFIX))


def test_publish_refuses_unverifiable(tmp_path):
    import pickle
    plans, params = _mlp_spec(seed=2)
    path = _spec_path(tmp_path, "good.pickle", params, plans)
    with open(path, "r+b") as fout:
        fout.write(b"\x00\x00garbage")
    with pytest.raises(SnapshotError):
        publish_snapshot(path, str(tmp_path / "pub"))
    bare = str(tmp_path / "bare.pickle")
    with open(bare, "wb") as fout:
        pickle.dump({"plans": plans, "params": params,
                     "sample_shape": (16,)}, fout)
    with pytest.raises(SnapshotError):
        publish_snapshot(bare, str(tmp_path / "pub"))


@pytest.mark.chaos
def test_publish_crash_burns_the_ordinal(tmp_path):
    plans, params = _mlp_spec(seed=2)
    pub = str(tmp_path / "pub")
    publish_snapshot(_spec_path(tmp_path, "a.pickle", params, plans), pub)
    chaos.install(chaos.FaultPlan(seed=1).add("freshness.publish",
                                              "crash", nth=1))
    try:
        with pytest.raises(chaos.ChaosCrash):
            publish_snapshot(_spec_path(tmp_path, "b.pickle",
                                        _perturb(params), plans), pub)
    finally:
        chaos.uninstall()
    assert read_latest(pub)["ordinal"] == 1
    assert publish_snapshot(_spec_path(tmp_path, "c.pickle", params,
                                       plans), pub)["ordinal"] == 3


def test_snapshotter_unit_publishes_real_workflow(tmp_path):
    from tests.test_torch_snapshot import _build
    from veles_tpu_torch.snapshotter import Snapshotter
    sw = _build(max_epochs=1, run=True)
    pub = str(tmp_path / "pub")
    snap = Snapshotter(sw, directory=str(tmp_path / "train"),
                       prefix="fw", interval=1, time_interval=0,
                       compression="gz", keep=1, publish_dir=pub)
    snap.initialize()
    for i in range(3):
        snap.suffix = "e%d" % i
        snap.export()
        time.sleep(0.02)
    published = [f for f in os.listdir(pub) if f[0].isdigit() and
                 not f.endswith(MANIFEST_SUFFIX)]
    assert len(published) == 3
    assert read_latest(pub)["ordinal"] == 3
    watcher = SnapshotWatcher(pub, default_sample_shape=(16,))
    cand = watcher.poll_once()
    assert cand is not None and cand.ordinal == 3
    assert cand.sample_shape == (16,)
    assert len(cand.plans) == 2 and "weights" in cand.params[0]
    engine = AOTEngine(cand.plans, cand.params, cand.sample_shape,
                       ladder=(8,), device=CPU)
    engine.compile()
    out = engine.infer(numpy.zeros((2, 16), numpy.float32))
    assert out.shape == (2, 4) and numpy.isfinite(out).all()


def test_jax_published_spec_served_by_the_port(tmp_path):
    """The JAX package exports and publishes a model spec; the port's
    watcher verifies and loads it (the JAX classes mapped to the
    port's) and its engine answers within 1e-5 of the JAX engine."""
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.serve import AOTEngine as JaxEngine
    from veles_tpu.serve import export_model_spec as jax_export
    from veles_tpu.snapshotter import publish_snapshot as jax_publish
    from tests.test_serve import _mlp_spec as jax_mlp_spec
    jplans, jparams = jax_mlp_spec(seed=7)
    path = str(tmp_path / "jax_spec.pickle")
    jax_export(path, jplans, jparams, (16,))
    pub = str(tmp_path / "pub")
    jax_publish(path, pub)
    cand = SnapshotWatcher(pub).poll_once()
    assert cand is not None and cand.ordinal == 1
    assert [type(p).__module__ for p in cand.plans] == \
        ["veles_tpu_torch.compiler"] * 2
    assert cand.plans[0].forward_cls.__module__ == \
        "veles_tpu_torch.models.all2all"
    engine = AOTEngine(cand.plans, cand.params, cand.sample_shape,
                       ladder=(8, 32), device=CPU)
    engine.compile()
    jengine = JaxEngine(jplans, jparams, (16,), ladder=(8, 32),
                        device=JaxDevice(backend="cpu"))
    jengine.compile()
    x = numpy.random.RandomState(3).rand(13, 16).astype(numpy.float32)
    numpy.testing.assert_allclose(engine.infer(x), jengine.infer(x),
                                  rtol=0, atol=1e-5)
    # a pool over the port's watcher serves the same through the loop
    pool = _pool(replicas=1, seed=7)
    controller = FreshnessController(pool, pub, canary=False)
    try:
        assert controller.watcher.poll_once() is not None
        assert controller.history[-1]["verdict"] == "reloaded"
        pool.start()
        numpy.testing.assert_allclose(
            numpy.stack([pool.infer(row) for row in x]),
            jengine.infer(x), rtol=0, atol=1e-5)
    finally:
        controller.stop()
        pool.stop()


# -- watcher discipline ----------------------------------------------------


def test_watcher_skips_and_retries_torn_publish(tmp_path, caplog):
    plans, params = _mlp_spec(seed=3)
    pub = str(tmp_path / "pub")
    chaos.install(chaos.FaultPlan(seed=1).add(
        "freshness.publish", "truncate", nth=1))
    try:
        publish_snapshot(_spec_path(tmp_path, "a.pickle", params, plans),
                         pub)
    finally:
        chaos.uninstall()
    watcher = SnapshotWatcher(pub, poll_s=0.01, invalid_ttl_s=60.0)
    with caplog.at_level(logging.DEBUG):
        for _ in range(6):
            assert watcher.poll_once() is None
            time.sleep(0.012)
    warnings = [r for r in caplog.records
                if r.levelno >= logging.WARNING and
                r.name == "SnapshotWatcher"]
    assert not warnings, warnings
    pend = watcher._pending
    assert pend is not None and pend["ordinal"] == 1
    assert pend["backoff"] > watcher.poll_s
    publish_snapshot(_spec_path(tmp_path, "b.pickle", params, plans), pub)
    cand = watcher.poll_once()
    assert cand is not None and cand.ordinal == 2
    assert watcher._pending is None


def test_watcher_ttl_rejects_stuck_invalid(tmp_path):
    plans, params = _mlp_spec(seed=4)
    pub = str(tmp_path / "pub")
    chaos.install(chaos.FaultPlan(seed=1).add(
        "freshness.publish", "truncate", nth=1))
    try:
        publish_snapshot(_spec_path(tmp_path, "a.pickle", params, plans),
                         pub)
    finally:
        chaos.uninstall()
    before = registry.counter("serve.freshness.poisoned_rejected").value
    watcher = SnapshotWatcher(pub, poll_s=0.01, invalid_ttl_s=0.05,
                              max_backoff_s=0.02)
    deadline = time.monotonic() + 5.0
    while 1 not in watcher._rejected and time.monotonic() < deadline:
        watcher.poll_once()
        time.sleep(0.015)
    assert 1 in watcher._rejected
    assert registry.counter(
        "serve.freshness.poisoned_rejected").value == before + 1
    assert watcher.poll_once() is None


def test_watcher_push_notify_wakes_poll(tmp_path):
    plans, params = _mlp_spec(seed=5)
    pub = str(tmp_path / "pub")
    seen = []
    watcher = SnapshotWatcher(pub, callback=seen.append, poll_s=30.0)
    watcher.start()
    try:
        time.sleep(0.05)
        publish_snapshot(_spec_path(tmp_path, "a.pickle", params, plans),
                         pub)
        watcher.notify()
        deadline = time.monotonic() + 5.0
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        watcher.stop()
    assert seen and seen[0].ordinal == 1


def test_watcher_retries_when_cycle_fails_transiently(tmp_path):
    plans, params = _mlp_spec(seed=6)
    pub = str(tmp_path / "pub")
    publish_snapshot(_spec_path(tmp_path, "a.pickle", params, plans), pub)
    poisoned = registry.counter("serve.freshness.poisoned_rejected")
    before = poisoned.value
    calls = []

    def flaky(cand):
        calls.append(cand.ordinal)
        if len(calls) <= 2:
            raise RuntimeError("transient warm-up failure")

    watcher = SnapshotWatcher(pub, callback=flaky, poll_s=0.01,
                              invalid_ttl_s=0.02, max_backoff_s=0.02)
    assert watcher.poll_once() is None
    assert watcher.last_ordinal == 0
    time.sleep(0.05)
    assert watcher.poll_once() is None
    assert 1 not in watcher._rejected
    assert poisoned.value == before
    time.sleep(0.05)
    cand = watcher.poll_once()
    assert cand is not None and cand.ordinal == 1
    assert calls == [1, 1, 1]


def test_schedule_bank_is_logged_once_and_left_alone(tmp_path, caplog):
    plans, params = _mlp_spec(seed=6)
    pub = str(tmp_path / "pub")
    publish_snapshot(_spec_path(tmp_path, "a.pickle", params, plans), pub)
    bank = os.path.join(pub, "schedule_bank.json")
    with open(bank, "w") as fout:
        fout.write("{}")
    watcher = SnapshotWatcher(pub)
    with caplog.at_level(logging.DEBUG):
        assert watcher.poll_once() is not None
        assert watcher.poll_once() is None
    notes = [r for r in caplog.records if "schedule_bank.json" in
             r.getMessage()]
    # no manifest: never merged, noted once, retried at every poll
    assert len(notes) == 1 and "not (yet) valid" in notes[0].getMessage()
    from veles_tpu_torch.tune.cache import cache_for
    assert len(cache_for()) == 0
    with open(bank) as fin:
        assert fin.read() == "{}"


# -- canary mechanics ---------------------------------------------------------


def _compiled_candidate(pool, params, plans=None):
    cand_plans = plans if plans is not None else pool.engine.plans
    rep = pool._live()[-1]
    engine = AOTEngine(cand_plans, params, pool.engine.sample_shape,
                       device=rep.device, ladder=pool.engine.ladder)
    engine.compile()
    return engine


def test_canary_replica_leaves_rotation_and_cascade():
    pool = _pool(replicas=3)
    pool.start()
    try:
        candidate = _compiled_candidate(pool,
                                        _perturb(pool.engine.params))
        rep = pool.cutover.begin(candidate)
        assert rep is pool.replicas[-1]
        assert [r.index for r in pool._live()] == [0, 1]
        assert pool.digest == pool.replicas[0].engine.digest
        for _ in range(12):
            pool.infer(numpy.zeros(16, numpy.float32))
        assert rep.batcher._q.qsize() == 0
        chaos.install(chaos.FaultPlan(seed=1).add("serve.drop", "drop"))
        try:
            with pytest.raises(ServeOverload) as info:
                pool.submit(numpy.zeros(16, numpy.float32))
        finally:
            chaos.uninstall()
        assert "2 live replicas" in str(info.value)
        pool.cutover.rollback(reason="test teardown")
        assert not rep.canary
    finally:
        pool.stop()


def test_mirror_bit_equality_and_shadow_excluded_counters():
    pool = _pool(replicas=3)
    pool.start()
    try:
        samples, baseline = _drive(pool, n=20, seed=6)
        candidate = _compiled_candidate(pool,
                                        _perturb(pool.engine.params))
        pool.cutover.begin(candidate)
        shadows = []
        pool.mirror_hook = lambda sample, req: shadows.append(
            pool.cutover.shadow(numpy.array(sample, copy=True)))
        req_before = registry.counter("serve.requests").value
        lat_before = registry.histogram("serve.latency_s").count
        mirrored = [numpy.array(pool.infer(x, timeout=15.0))
                    for x in samples]
        for primary, ref in zip(mirrored, baseline):
            assert (primary == ref).all()
        shadows = [s for s in shadows if s is not None]
        assert len(shadows) == len(samples)
        for s in shadows:
            assert s.done.wait(10.0)
            assert s.error is None and s.latency is not None
        assert registry.counter("serve.requests").value == \
            req_before + len(samples)
        assert registry.histogram("serve.latency_s").count == \
            lat_before + len(samples)
        ref_engine = pool.cutover.canary_replica.engine
        for x, s in zip(samples, shadows):
            assert (s.result == ref_engine.infer(x)[0]).all()
        pool.mirror_hook = None
        pool.cutover.rollback(reason="test teardown")
    finally:
        pool.stop()


def test_promote_rolls_pool_and_reload_guard():
    pool = _pool(replicas=3)
    pool.start()
    try:
        new_params = _perturb(pool.engine.params, seed=8)
        candidate = _compiled_candidate(pool, new_params)
        pool.cutover.begin(candidate)
        with pytest.raises(RuntimeError):
            pool.reload(new_params)
        receipt = pool.cutover.promote()
        assert receipt["verdict"] == "promoted"
        assert receipt["new_compiles"] == 0
        want = value_digest(new_params)
        for rep in pool.replicas:
            assert value_digest(rep.engine.params) == want
            assert not rep.canary
        assert pool.cutover.state == "idle"
        x = numpy.random.RandomState(9).rand(16).astype(numpy.float32)
        ref = pool.engine.infer(x)[0]
        for rep in pool.replicas:
            assert (rep.batcher.infer(x) == ref).all()
    finally:
        pool.stop()


def test_rollback_restores_last_good_with_zero_compiles():
    pool = _pool(replicas=2)
    pool.start()
    try:
        before = value_digest(pool.engine.params)
        x = numpy.random.RandomState(10).rand(16).astype(numpy.float32)
        ref = pool.engine.infer(x)[0]
        plans3, params3 = _mlp_spec(seed=5, hidden=24)
        candidate = _compiled_candidate(pool, params3, plans=plans3)
        canary_rep = pool.cutover.begin(candidate)
        assert canary_rep.batcher.engine is candidate
        receipt = pool.cutover.rollback(reason="bad canary")
        assert receipt["verdict"] == "rolled_back"
        assert receipt["new_compiles"] == 0, receipt
        assert receipt["restored_digest"] == pool.digest
        for rep in pool.replicas:
            assert value_digest(rep.engine.params) == before
        deadline = time.monotonic() + 5.0
        while canary_rep.batcher.engine is candidate and \
                time.monotonic() < deadline:
            pool.infer(x)
        assert (canary_rep.batcher.infer(x) == ref).all()
    finally:
        pool.stop()


# -- comparator and spike watch -----------------------------------------------


def test_ema_spike_watch_matches_decision_discipline():
    watch = EmaSpikeWatch(spike_factor=3.0, spike_floor=0.1, beta=0.5)
    assert watch.update(1.0) is None
    assert watch.ema == 1.0
    assert watch.update(1.2) is None
    assert watch.ema == pytest.approx(1.1)
    reason = watch.update(100.0)
    assert reason is not None and "spiked" in reason
    assert watch.ema == pytest.approx(1.1)
    watch.reset()
    assert watch.ema is None
    floor = EmaSpikeWatch(spike_factor=3.0, spike_floor=1.0)
    floor.update(0.001)
    assert floor.update(0.5) is None


def test_comparator_verdicts_equal_jax():
    from veles_tpu.serve import CanaryComparator as JaxComparator
    good = numpy.full(4, 0.25)
    bad = numpy.array([0.5, numpy.nan, 0.2, 0.1])
    onehot = numpy.array([1.0, 0.0, 0.0, 0.0])
    cases = [
        (dict(min_mirrors=3, breach_budget=2),
         [(good, good + 1e-4, 0.01, 0.01), (good, good - 1e-4, 0.01, 0.01),
          (good, good, 0.01, 0.01)], "promote", ""),
        (dict(min_mirrors=3), [(good, bad, 0.01, 0.01)], "rolled_back",
         "non-finite"),
        (dict(min_mirrors=8, divergence_limit=0.5, breach_budget=2),
         [(good, onehot, 0.01, 0.01)] * 2, "rolled_back", "divergence"),
        (dict(min_mirrors=8, latency_spike_factor=3.0,
              latency_floor_s=0.01, breach_budget=2),
         [(good, good, 0.01, 0.012)] * 4 + [(good, good, 0.01, 5.0)] * 2,
         "rolled_back", "latency"),
    ]
    for kwargs, pairs, verdict, reason in cases:
        mine, theirs = CanaryComparator(**kwargs), JaxComparator(**kwargs)
        for pair in pairs:
            assert mine.add(*pair) == theirs.add(*pair)
        assert mine.verdict == theirs.verdict == verdict
        assert reason in mine.reason()
        assert mine.reason() == theirs.reason()
        assert mine.max_divergence == theirs.max_divergence


# -- the controller end to end ------------------------------------------------


def test_controller_cycle_promote_then_poison_then_rollback(tmp_path):
    pool = _pool(replicas=3)
    pool.start()
    controller = _controller(pool, tmp_path, invalid_ttl_s=1.0)
    controller.start()
    errors = []
    stop = threading.Event()

    def client(k):
        x = numpy.random.RandomState(40 + k).rand(16).astype(
            numpy.float32)
        while not stop.is_set():
            try:
                pool.infer(x, timeout=15.0)
            except Exception as exc:
                errors.append(exc)
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(3)]
    for t in threads:
        t.start()
    plans = pool.engine.plans
    try:
        def publish(name, params):
            return publish_snapshot(
                _spec_path(tmp_path, name, params, plans),
                str(tmp_path / "publish"))

        def wait_cycle(ordinal, timeout=30.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                for entry in controller.history:
                    if entry["ordinal"] == ordinal:
                        return entry
                time.sleep(0.02)
            raise TimeoutError("no verdict for #%d" % ordinal)

        good = _perturb(pool.engine.params, seed=21)
        entry = wait_cycle(publish("good.pickle", good)["ordinal"])
        assert entry["verdict"] == "promoted", entry
        assert entry["mirrors"] >= 4
        want = value_digest(good)
        for rep in pool.replicas:
            assert value_digest(rep.engine.params) == want
        nan_params = [{k: numpy.full_like(v, numpy.nan)
                       for k, v in e.items()} for e in good]
        entry = wait_cycle(publish("nan.pickle", nan_params)["ordinal"])
        assert entry["verdict"] == "poisoned"
        for rep in pool.replicas:
            assert value_digest(rep.engine.params) == want
        entry = wait_cycle(publish("bad.pickle",
                                   _permuted(good))["ordinal"])
        assert entry["verdict"] == "rolled_back", entry
        assert entry["new_compiles"] == 0, entry
        for rep in pool.replicas:
            assert value_digest(rep.engine.params) == want
        assert pool.cutover.state == "idle"
        snap = controller.snapshot()
        assert snap["promotions"] >= 1 and snap["rollbacks"] >= 1
        assert snap["poisoned_rejected"] >= 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15)
        controller.stop()
        pool.stop()
    assert not errors, errors[:3]


def test_single_replica_falls_back_to_direct_reload(tmp_path):
    pool = _pool(replicas=1)
    pool.start()
    controller = _controller(pool, tmp_path)
    try:
        good = _perturb(pool.engine.params, seed=31)
        publish_snapshot(_spec_path(tmp_path, "solo.pickle", good,
                                    pool.engine.plans),
                         str(tmp_path / "publish"))
        assert controller.watcher.poll_once() is not None
        assert controller.history[-1]["verdict"] == "reloaded"
        assert value_digest(pool.engine.params) == value_digest(good)
    finally:
        controller.stop()
        pool.stop()


def test_service_publish_endpoint_and_healthz(tmp_path):
    pool = _pool(replicas=2)
    controller = _controller(pool, tmp_path, poll_s=30.0)
    controller.start()
    svc = ServeService(pool, freshness=controller)
    svc.start_background()
    try:
        base = "http://127.0.0.1:%d" % svc.port
        good = _perturb(pool.engine.params, seed=41)
        receipt = publish_snapshot(
            _spec_path(tmp_path, "push.pickle", good, pool.engine.plans),
            str(tmp_path / "publish"))
        req = urllib.request.Request(
            base + "/publish",
            data=json.dumps({"snapshot": receipt["snapshot"]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "notified"
        deadline = time.monotonic() + 20.0
        while not controller.history and time.monotonic() < deadline:
            time.sleep(0.05)
        assert controller.history, "the push never woke the watcher"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["freshness"]["last_ordinal"] == 1
        assert health["freshness"]["cycles"] >= 1
    finally:
        svc.stop()
        controller.stop()
        pool.stop()


def test_idle_pool_self_probes_to_a_verdict(tmp_path):
    pool = _pool(replicas=2)
    pool.start()
    controller = _controller(pool, tmp_path, probe_idle_s=0.02)
    plans = pool.engine.plans
    try:
        req_before = registry.counter("serve.requests").value
        good = _perturb(pool.engine.params, seed=51)
        publish_snapshot(_spec_path(tmp_path, "g.pickle", good, plans),
                         str(tmp_path / "publish"))
        assert controller.watcher.poll_once() is not None
        entry = controller.history[-1]
        assert entry["verdict"] == "promoted", entry
        assert entry["mirrors"] >= 4
        publish_snapshot(_spec_path(tmp_path, "b.pickle", _permuted(good),
                                    plans), str(tmp_path / "publish"))
        assert controller.watcher.poll_once() is not None
        entry = controller.history[-1]
        assert entry["verdict"] == "rolled_back", entry
        assert entry["new_compiles"] == 0
        assert value_digest(pool.engine.params) == value_digest(good)
        assert registry.counter("serve.requests").value == req_before
    finally:
        controller.stop()
        pool.stop()


def test_latest_pointer_name_is_shared():
    from veles_tpu.snapshotter import LATEST_NAME as JAX_LATEST
    assert LATEST_NAME == JAX_LATEST


# -- the fleet canary's host handle and its poison gate -----------------------


@pytest.mark.fleet
@pytest.mark.parametrize("replicas", [None, 2])
def test_local_host_control_stage_and_revert_are_swaps(replicas):
    """``LocalHostControl`` stages a same-architecture candidate into
    every engine behind a host (a batcher's, or a pool's replicas) and
    reverts it bit for bit; its receipt, the delta of the engines' own
    receipts, reads 0 captures, 0 builds and 0 new compiles, and the
    JAX package's handle gives the same answers on the same params."""
    from tests.test_serve import _mlp_spec as jax_mlp_spec
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.serve import AOTEngine as JaxEngine
    from veles_tpu.serve import ContinuousBatcher as JaxBatcher
    from veles_tpu.serve.freshness import LocalHostControl as JaxControl
    from veles_tpu_torch.serve import (AOTEngine, ContinuousBatcher,
                                       LocalHostControl)
    plans, params = _mlp_spec(seed=3)
    candidate = _perturb(params)
    x = numpy.random.RandomState(2).rand(8, 16).astype(numpy.float32)
    if replicas is None:
        engine = AOTEngine(plans, params, (16,), ladder=(8,),
                           device=Device(backend="cpu"))
        engine.compile()
        host = ContinuousBatcher(engine, max_delay_s=0.001)
        engines = [engine]
    else:
        host = _pool(replicas=replicas, seed=3)
        engines = [rep.engine for rep in host.replicas]
    jplans, jparams = jax_mlp_spec(seed=3)
    jengine = JaxEngine(jplans, jparams, (16,), ladder=(8,),
                        device=JaxDevice(backend="cpu"))
    jengine.compile()
    jcontrol = JaxControl(JaxBatcher(jengine, max_delay_s=0.001))
    control = LocalHostControl(host)
    before = [e.infer(x) for e in engines]
    receipt = control.stage(candidate)
    assert receipt == {"captures": 0, "kernel_builds": 0,
                       "new_compiles": 0, "digest": engines[0].digest}
    staged = [e.infer(x) for e in engines]
    assert not numpy.array_equal(staged[0], before[0])
    jcontrol.stage(candidate)
    assert numpy.allclose(staged[0], jengine.infer(x), rtol=1e-5,
                          atol=1e-7)
    assert control.revert()["new_compiles"] == 0
    for engine, want in zip(engines, before):
        assert numpy.array_equal(engine.infer(x), want)
    assert control.revert() is None
    wider, wide_params = _mlp_spec(seed=3, hidden=8)
    with pytest.raises(ValueError, match="digest mismatch"):
        control.stage(wide_params)
    if replicas is not None:
        host.stop()


@pytest.mark.fleet
def test_fleet_canary_rejects_non_finite_params_with_a_flight_dump(
        tmp_path):
    """A non-finite candidate is never staged nor mirrored: the verdict
    is ``poisoned``, the rollback counter rises, a ``serve.canary``
    instant lands in the flight ring and the ring is dumped."""
    import json

    from veles_tpu_torch.observe.flight import flight, validate_flight
    from veles_tpu_torch.serve import FleetCanaryController

    class _Untouched(object):
        def stage(self, params):
            raise AssertionError("a poisoned candidate was staged")

        revert = stage

    class _NoRouter(object):
        def begin_canary_slice(self, *args, **kwargs):
            raise AssertionError("a poisoned candidate was sliced")

    plans, params = _mlp_spec(seed=3)
    bad = [dict(e) for e in params]
    bad[0] = dict(bad[0], bias=numpy.full_like(bad[0]["bias"], numpy.nan))
    rollbacks = registry.counter("serve.fleet.canary.rollbacks").value
    controller = FleetCanaryController(_NoRouter(), {"h0": _Untouched()})
    receipt = controller.run(bad, "h0")
    assert receipt["verdict"] == "poisoned"
    assert receipt["new_compiles"] == 0
    assert registry.counter("serve.fleet.canary.rollbacks").value == \
        rollbacks + 1
    dumps = sorted(tmp_path.glob("veles_flight.fleet-canary-poisoned.*"))
    assert dumps and flight.last_dump_path == str(dumps[-1])
    doc = validate_flight(json.loads(dumps[-1].read_text()))
    canary = [e for e in doc["events"] if e["name"] == "serve.canary"]
    assert canary and canary[-1]["args"]["phase"] == "poisoned"
