"""The port's multi-tenant QoS (veles_tpu_torch/serve/qos.py and its
use in the batcher and the binary transport) against the JAX package's,
on the CPU: the non-fleet cases of tests/test_qos.py (token-bucket
burst and refill edges, quota specs, class normalization, the seeded
jitter, class-ordered shedding with interactive starving last, the
``serve.tenant.flood`` chaos point, tenant metrics without shadows,
tenant quotas and class labels on the wire), plus the ``RetryJitter``,
``TokenBucket``, ``TenantQuota`` and ``HedgeBudget`` sequences of both
packages equal value for value.  The fleet cases of tests/test_qos.py
on socketpair hosts: an exhausted hedge budget routes normally and
never fails, the fleet front's class-aware in-flight bound evicts a
lower class, the fleet canary promotes a good candidate and rolls back
a class-permuted poison with no failed request and 0 new compiles
(with the JAX controller's verdicts on the same inputs), and mirrored
shadows are never served nor counted."""

import socket
import threading
import time

import numpy
import pytest
import torch

from tests.test_torch_serve_tier import _mlp_spec
from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch import chaos
from veles_tpu_torch.backends import Device
from veles_tpu_torch.observe.metrics import registry
from veles_tpu_torch.serve import (
    AOTEngine, BinaryTransportClient, BinaryTransportServer,
    ContinuousBatcher, HedgeBudget, RetryJitter, ServeOverload,
    TenantQuota, normalize_class, parse_quota_spec, serve_snapshot)
from veles_tpu_torch.serve import qos
from veles_tpu_torch.serve.qos import TokenBucket, class_rank

pytestmark = [pytest.mark.serve, pytest.mark.qos]

CPU = Device(backend="cpu")


@pytest.fixture(autouse=True)
def _port_chaos_off():
    yield
    chaos.uninstall()


def _counter(name):
    return registry.counter(name).value


class _Clock(object):
    """Injectable deterministic clock for the bucket math."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_token_bucket_burst_and_refill_edges():
    clock = _Clock()
    bucket = TokenBucket(rate=2.0, burst=4.0, clock=clock)
    assert bucket.tokens == 4.0
    for _ in range(4):
        assert bucket.try_take()
    assert not bucket.try_take()
    clock.now += 1.0
    assert bucket.tokens == pytest.approx(2.0)
    clock.now += 100.0
    assert bucket.tokens == pytest.approx(4.0)
    assert bucket.time_until(3.0) == 0.0
    assert bucket.try_take(4.0)
    assert bucket.time_until(3.0) == pytest.approx(1.5)
    assert bucket.time_until(100.0) == float("inf")


def test_token_bucket_zero_rate_never_refills():
    clock = _Clock()
    bucket = TokenBucket(rate=0.0, burst=2.0, clock=clock)
    assert bucket.try_take() and bucket.try_take()
    clock.now += 1e6
    assert not bucket.try_take()
    assert bucket.time_until() == float("inf")


def test_parse_quota_spec_and_tenant_quota():
    quotas = parse_quota_spec("acme=100:200,free_tier=5,*=50")
    assert quotas == {"acme": (100.0, 200.0), "free_tier": (5.0, None),
                      "*": (50.0, None)}
    with pytest.raises(ValueError):
        parse_quota_spec("missing_equals")
    quota = TenantQuota({"tiny": (0.0, 2.0)}, clock=_Clock())
    for _ in range(100):
        assert quota.admit("anyone") is None
        assert quota.admit(None) is None
    assert quota.admit("tiny") is None
    assert quota.admit("tiny") is None
    wait = quota.admit("tiny")
    assert wait is not None and wait > 0


def test_tenant_quota_default_and_anonymous_bucket():
    quota = TenantQuota({"*": (0.0, 1.0)}, clock=_Clock())
    assert quota.admit("a") is None
    assert quota.admit("b") is None
    assert quota.admit("a") is not None
    assert quota.admit(None) is None
    assert quota.admit(None) is not None


def test_normalize_class_and_rank():
    assert normalize_class(None) == "batch"
    assert normalize_class("INTERACTIVE") == "interactive"
    assert normalize_class("best-effort") == "best_effort"
    assert normalize_class("no_such_class") == "batch"
    assert class_rank("best_effort") < class_rank("batch") < \
        class_rank("interactive")


def test_retry_jitter_distinct_and_deterministic():
    jitter = RetryJitter(seed=7, spread=0.5)
    a = jitter.apply(1.0, "interactive")
    b = jitter.apply(1.0, "interactive")
    assert a != b
    for v in (a, b):
        assert 1.0 <= v <= 1.5
    assert jitter.apply(1.0, "batch") != a
    replay = RetryJitter(seed=7, spread=0.5)
    assert replay.apply(1.0, "interactive") == a
    assert replay.apply(1.0, "interactive") == b


# -- the same sequences as the JAX package --------------------------------


@pytest.mark.parametrize("seed,spread", [(0, 0.5), (7, 0.5), (3, 2.0)])
def test_retry_jitter_sequence_equals_jax(seed, spread):
    from veles_tpu.serve.qos import RetryJitter as JaxJitter
    mine, theirs = RetryJitter(seed, spread), JaxJitter(seed, spread)
    classes = ["interactive", "batch", None, "best-effort", "BATCH",
               "nope"] * 5
    bases = numpy.random.RandomState(seed).rand(len(classes)) * 3
    for base, cls in zip(bases, classes):
        assert mine.apply(base, cls) == theirs.apply(base, cls)


def test_token_bucket_and_quota_sequences_equal_jax():
    from veles_tpu.serve.qos import TenantQuota as JaxQuota
    from veles_tpu.serve.qos import TokenBucket as JaxBucket
    clocks = _Clock(), _Clock()
    buckets = (TokenBucket(3.0, 5.0, clock=clocks[0]),
               JaxBucket(3.0, 5.0, clock=clocks[1]))
    spec = "acme=2:3,slow=0.5,*=1:2"
    quotas = (TenantQuota.from_spec(spec, clock=clocks[0]),
              JaxQuota.from_spec(spec, clock=clocks[1]))
    rng = numpy.random.RandomState(5)
    for _ in range(200):
        step = float(rng.choice([0.0, 0.05, 0.3, 1.0]))
        for clock in clocks:
            clock.now += step
        cost = float(rng.choice([0.5, 1.0, 2.0, 7.0]))
        took = [b.try_take(cost) for b in buckets]
        assert took[0] == took[1]
        assert buckets[0].time_until(cost) == buckets[1].time_until(cost)
        assert buckets[0].tokens == buckets[1].tokens
        tenant = rng.choice(["acme", "slow", "other", ""])
        assert quotas[0].admit(tenant or None, cost) == \
            quotas[1].admit(tenant or None, cost)


def test_hedge_budget_and_burn_rules_equal_jax():
    from veles_tpu.serve import qos as jax_qos
    clocks = _Clock(), _Clock()
    budgets = {"interactive": (2.0, 3.0), "best_effort": (0.0, 0.0)}
    mine = HedgeBudget(budgets, clock=clocks[0])
    theirs = jax_qos.HedgeBudget(budgets, clock=clocks[1])
    exhausted = _counter("serve.hedge.budget_exhausted")
    seq = []
    for i in range(40):
        for clock in clocks:
            clock.now += 0.1 * (i % 3)
        cls = ("interactive", "batch", "best_effort")[i % 3]
        got = mine.try_take(cls)
        assert got == theirs.try_take(cls)
        seq.append(got)
    assert not all(seq) and any(seq)
    assert _counter("serve.hedge.budget_exhausted") - exhausted == \
        seq.count(False)
    assert qos.burn_rule_specs() == jax_qos.burn_rule_specs()
    assert qos.burn_rule_specs(scope="fleet", objective=0.9) == \
        jax_qos.burn_rule_specs(scope="fleet", objective=0.9)
    for cls in ("interactive", "batch", "best_effort", None, "x"):
        assert qos.slo_budget_s(cls) == jax_qos.slo_budget_s(cls)
    assert qos.SHED_ORDER == jax_qos.SHED_ORDER
    assert qos.SLO_CLASSES == jax_qos.SLO_CLASSES


# -- class-ordered shedding under a full queue --------------------------------


class _GateEngine(object):
    """Duck engine whose dispatch blocks on a gate: deterministic queue
    pressure."""

    dtype = numpy.dtype(numpy.float32)
    sample_shape = (4,)
    max_batch = 1
    ladder = (1,)
    digest = "gate"
    device = CPU

    def __init__(self):
        self.gate = threading.Event()

    def rung_for(self, n, cap=None):
        return 1

    def run_host(self, batch, rung):
        assert self.gate.wait(30.0), "test gate never opened"
        return torch.from_numpy(numpy.asarray(batch) * 2.0)


def _occupy_worker(batcher):
    """Park the worker inside the dispatch so the queue holds what we
    put."""
    head = batcher.submit(numpy.zeros(4, numpy.float32),
                          slo_class="best_effort")
    deadline = time.monotonic() + 10.0
    while batcher._q.qsize() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert batcher._q.qsize() == 0, "worker never picked up the head"
    return head


def test_class_ordered_shedding_interactive_starves_last():
    engine = _GateEngine()
    batcher = ContinuousBatcher(engine, max_delay_s=0.0, max_queue=4,
                                retry_jitter=RetryJitter(seed=3))
    batcher.start()
    shed_be = _counter("serve.tenant.best_effort.shed")
    shed_batch = _counter("serve.tenant.batch.shed")
    shed_int = _counter("serve.tenant.interactive.shed")
    try:
        head = _occupy_worker(batcher)
        x = numpy.arange(4, dtype=numpy.float32)
        b1 = batcher.submit(x, slo_class="best_effort")
        b2 = batcher.submit(x, slo_class="best_effort")
        n1 = batcher.submit(x, slo_class="batch")
        n2 = batcher.submit(x)  # unlabelled = batch
        i1 = batcher.submit(x, slo_class="interactive")
        assert b1.cancelled and isinstance(b1.error, ServeOverload)
        assert "eviction" in str(b1.error)
        i2 = batcher.submit(x, slo_class="interactive")
        assert b2.cancelled and isinstance(b2.error, ServeOverload)
        assert b1.error.retry_after != b2.error.retry_after
        assert not n1.cancelled and not n2.cancelled
        i3 = batcher.submit(x, slo_class="interactive")
        assert n1.cancelled
        with pytest.raises(ServeOverload):
            batcher.submit(x, slo_class="batch")
        assert not n2.cancelled
        with pytest.raises(ServeOverload):
            batcher.submit(x, slo_class="best_effort")
        n2.cancelled = True  # leave only interactive work pending
        with pytest.raises(ServeOverload):
            batcher.submit(x, slo_class="interactive")
        for req in (i1, i2, i3):
            assert not req.cancelled
        engine.gate.set()
        for req in (head, i1, i2, i3):
            assert req.done.wait(10.0)
            assert req.error is None
            assert (req.result == req.sample * 2.0).all()
    finally:
        engine.gate.set()
        batcher.stop()
    assert _counter("serve.tenant.best_effort.shed") - shed_be == 3
    assert _counter("serve.tenant.batch.shed") - shed_batch == 2
    assert _counter("serve.tenant.interactive.shed") - shed_int == 1


@pytest.mark.chaos
def test_tenant_flood_chaos_is_shed_as_best_effort():
    engine = _GateEngine()
    batcher = ContinuousBatcher(engine, max_delay_s=0.0, max_queue=4)
    batcher.start()
    shed_be = _counter("serve.tenant.best_effort.shed")
    shed_int = _counter("serve.tenant.interactive.shed")
    try:
        head = _occupy_worker(batcher)
        chaos.install(chaos.FaultPlan(seed=5).add(
            "serve.tenant.flood", "storm", nth=1, param=8))
        req = batcher.submit(numpy.ones(4, numpy.float32),
                             slo_class="interactive")
        assert not req.cancelled
        engine.gate.set()
        assert req.done.wait(10.0) and req.error is None
        assert head.done.wait(10.0)
    finally:
        chaos.uninstall()
        engine.gate.set()
        batcher.stop()
    assert _counter("serve.tenant.best_effort.shed") > shed_be
    assert _counter("serve.tenant.interactive.shed") == shed_int


def test_tenant_metrics_in_serve_snapshot_exclude_shadow():
    plans, params = _mlp_spec(seed=9)
    engine = AOTEngine(plans, params, (16,), ladder=(8, 32), device=CPU)
    engine.compile()
    batcher = ContinuousBatcher(engine, max_delay_s=0.001).start()
    served_int = _counter("serve.tenant.interactive.requests")
    served_batch = _counter("serve.tenant.batch.requests")
    try:
        x = numpy.random.RandomState(0).rand(16).astype(numpy.float32)
        ref = engine.infer(x[None])[0]
        assert (batcher.infer(x) == ref).all()
        out = batcher.submit(x, slo_class="interactive")
        assert out.done.wait(10.0) and (out.result == ref).all()
        shadow = batcher.submit_shadow(x)
        assert shadow.done.wait(10.0)
        assert (shadow.result == ref).all()
    finally:
        batcher.stop()
    assert _counter("serve.tenant.interactive.requests") - served_int == 1
    assert _counter("serve.tenant.batch.requests") - served_batch == 1
    tenants = serve_snapshot()["tenants"]
    for cls in ("interactive", "batch"):
        assert tenants[cls]["requests"] >= 1
        assert tenants[cls]["latency_ms"]["p99"] >= \
            tenants[cls]["latency_ms"]["p50"] >= 0


@pytest.mark.transport
def test_transport_tenant_quota_and_class_labels():
    plans, params = _mlp_spec(seed=2)
    engine = AOTEngine(plans, params, (16,), ladder=(8, 32), device=CPU)
    engine.compile()
    batcher = ContinuousBatcher(engine, max_delay_s=0.001).start()
    quota = TenantQuota({"metered": (0.0, 2.0)})
    server = BinaryTransportServer(batcher, port=None, quota=quota,
                                   retry_jitter=RetryJitter(seed=1))
    server.start_background()
    clients = []

    def connect(**kwargs):
        ours, theirs = socket.socketpair()
        server.serve_socket(ours)
        client = BinaryTransportClient(sock=theirs, shm=False, **kwargs)
        clients.append(client)
        return client

    try:
        x = numpy.random.RandomState(1).rand(16).astype(numpy.float32)
        ref = engine.infer(x[None])
        legacy = connect()
        assert (legacy.infer(x) == ref).all()
        metered = connect(tenant="metered", slo_class="interactive")
        assert (metered.infer(x) == ref).all()
        assert (metered.infer(x) == ref).all()
        with pytest.raises(ServeOverload) as exc1:
            metered.infer(x)
        with pytest.raises(ServeOverload) as exc2:
            metered.infer(x)
        assert exc1.value.retry_after > 0
        assert exc1.value.retry_after != exc2.value.retry_after
        with pytest.raises(ServeOverload):
            legacy.infer(x, tenant="metered")
        assert (legacy.infer(x) == ref).all()
    finally:
        for client in clients:
            client.close()
        server.stop()
        batcher.stop()


# -- the fleet cases: hedge budgets, the front's bound, the fleet canary -----


def _fleet(plans, params, **router_kwargs):
    from tests.test_torch_fleet import _Hosts
    from veles_tpu_torch.serve import FleetRouter
    hosts = _Hosts(2, plans, params)
    router = FleetRouter(**router_kwargs).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
    except Exception:
        router.stop()
        hosts.stop()
        raise
    return hosts, router


@pytest.mark.fleet
@pytest.mark.chaos
def test_hedge_budget_exhaustion_routes_normally_never_fails():
    plans, params = _mlp_spec(seed=3)
    budget = HedgeBudget({cls: (0.0, 0.0) for cls in
                          ("interactive", "batch", "best_effort")})
    hosts, router = _fleet(plans, params, hedge_factor=1.2,
                           hedge_floor_s=0.01, hedge_tick_s=0.01,
                           hedge_warmup=2, hedge_budget=budget)
    try:
        x = numpy.random.RandomState(4).rand(4, 16).astype(numpy.float32)
        ref = hosts.entries[0][0].infer(x)
        for i in range(router.hedge_warmup):
            router.infer(x[i % 4], timeout=15.0)
        fired = _counter("serve.hedge.fired")
        exhausted = _counter("serve.hedge.budget_exhausted")
        chaos.install(chaos.FaultPlan(seed=1).add(
            "serve.host.stall", "stall", times=2, param=0.4))
        try:
            for i in range(4):
                out = router.infer(x[i], timeout=15.0,
                                   slo_class="interactive")
                assert (out == ref[i]).all()
        finally:
            chaos.uninstall()
        assert _counter("serve.hedge.fired") == fired
        assert _counter("serve.hedge.budget_exhausted") > exhausted
    finally:
        router.stop()
        hosts.stop()


@pytest.mark.fleet
@pytest.mark.chaos
def test_fleet_front_class_aware_inflight_bound():
    """Past ``max_inflight`` the front evicts a strictly lower class
    (the shed counted on the victim), so the interactive request
    proceeds."""
    plans, params = _mlp_spec(seed=3)
    hosts, router = _fleet(plans, params, hedge=False, max_inflight=2)
    try:
        x = numpy.random.RandomState(6).rand(16).astype(numpy.float32)
        ref = hosts.entries[0][0].infer(x[None])[0]
        shed_be = _counter("serve.tenant.best_effort.shed")
        chaos.install(chaos.FaultPlan(seed=2).add(
            "serve.host.stall", "stall", times=2, param=0.6))
        try:
            victims = [router.submit(x, slo_class="best_effort")
                       for _ in range(2)]
            out = router.infer(x, timeout=15.0, slo_class="interactive")
            assert (out == ref).all()
        finally:
            chaos.uninstall()
        evicted = [v for v in victims
                   if isinstance(v.error, ServeOverload)]
        assert len(evicted) == 1
        assert _counter("serve.tenant.best_effort.shed") - shed_be == 1
        survivor = [v for v in victims if v not in evicted][0]
        assert survivor.done.wait(15.0)
        if survivor.error is None:
            assert (survivor.result == ref).all()
    finally:
        router.stop()
        hosts.stop()


class _Traffic(object):
    """A closed-loop interactive client thread on the fleet front,
    counting failures and answers that differ from the reference."""

    def __init__(self, router, samples, reference):
        self.router = router
        self.samples = samples
        self.reference = reference
        self.served = 0
        self.failed = 0
        self.mismatched = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="qos-traffic")

    def _loop(self):
        i = 0
        while not self._stop.is_set():
            k = i % len(self.samples)
            i += 1
            try:
                out = self.router.infer(self.samples[k], timeout=15.0,
                                        slo_class="interactive")
            except Exception:
                self.failed += 1
                continue
            self.served += 1
            if not (out == self.reference[k]).all():
                self.mismatched += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)


def _poisoned(good):
    """Same shapes and digest (it passes the swap's structural gate),
    the output classes permuted: only mirrored evidence can catch it."""
    poison = [dict(p) for p in good]
    poison[1] = dict(poison[1],
                     weights=numpy.ascontiguousarray(
                         good[1]["weights"][:, ::-1]),
                     bias=numpy.ascontiguousarray(good[1]["bias"][::-1]))
    return poison


def _jax_canary_verdicts(seed=3):
    """The JAX fleet canary on the same spec, candidates and traffic:
    its two verdicts."""
    from tests.test_serve import _mlp_spec as jax_mlp_spec
    from tests.test_serve_fleet import _Hosts as JaxHosts
    from veles_tpu.serve import FleetRouter as JaxRouter
    from veles_tpu.serve.freshness import (
        FleetCanaryController as JaxController,
        LocalHostControl as JaxControl)
    plans, good = jax_mlp_spec(seed=seed)
    hosts = JaxHosts(2, plans, good)
    router = JaxRouter(hedge=False).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
        host_ids = sorted(router.snapshot()["hosts"])
        controls = {hid: JaxControl(hosts.entries[i][1])
                    for i, hid in enumerate(host_ids)}
        controller = JaxController(
            router, controls, mirror_fraction=1.0, min_mirrors=4,
            divergence_limit=1e-4, breach_budget=2,
            verdict_timeout_s=30.0, seed=7)
        x = numpy.random.RandomState(8).rand(6, 16).astype(numpy.float32)
        reference = hosts.entries[0][0].infer(x)
        verdicts = []
        for params in (good, _poisoned(good)):
            with _Traffic(router, x, reference):
                verdicts.append(controller.run(params,
                                               host_ids[0])["verdict"])
        return verdicts
    finally:
        router.stop()
        hosts.stop()


@pytest.mark.fleet
@pytest.mark.freshness
def test_fleet_canary_promotes_good_and_rolls_back_poison():
    from veles_tpu_torch.serve import (FleetCanaryController,
                                       LocalHostControl)
    plans, good = _mlp_spec(seed=3)
    poison = _poisoned(good)
    hosts, router = _fleet(plans, good, hedge=False)
    try:
        host_ids = sorted(router.snapshot()["hosts"])
        controls = {hid: LocalHostControl(hosts.entries[i][1])
                    for i, hid in enumerate(host_ids)}
        controller = FleetCanaryController(
            router, controls, mirror_fraction=1.0, min_mirrors=4,
            divergence_limit=1e-4, breach_budget=2,
            verdict_timeout_s=30.0, seed=7)
        x = numpy.random.RandomState(8).rand(6, 16).astype(numpy.float32)
        reference = hosts.entries[0][0].infer(x)
        canary_host = host_ids[0]
        mirrors = _counter("serve.fleet.canary.mirrors")
        with _Traffic(router, x, reference) as traffic:
            promoted = controller.run(good, canary_host)
        assert promoted["verdict"] == "promote"
        assert promoted["new_compiles"] == 0
        assert promoted["mirrors"] >= 4
        assert promoted["max_divergence"] == 0.0
        assert traffic.failed == 0
        assert traffic.mismatched == 0 and traffic.served > 0
        assert _counter("serve.fleet.canary.mirrors") > mirrors
        with _Traffic(router, x, reference) as traffic:
            rolled = controller.run(poison, canary_host)
        assert rolled["verdict"] == "rolled_back"
        assert rolled["new_compiles"] == 0
        assert "divergence" in rolled["reason"]
        assert traffic.failed == 0
        assert traffic.mismatched == 0, \
            "the poison must never answer a primary request"
        snap = router.snapshot()
        assert snap["hosts_live"] == 2 and snap["canary"] is None
        for i in range(6):
            assert (router.infer(x[i], timeout=15.0)
                    == reference[i]).all()
        assert _counter("serve.fleet.canary.promotions") >= 1
        assert _counter("serve.fleet.canary.rollbacks") >= 1
    finally:
        router.stop()
        hosts.stop()
    assert _jax_canary_verdicts() == [promoted["verdict"],
                                      rolled["verdict"]]


@pytest.mark.fleet
def test_canary_poison_never_served_and_mirrors_not_counted():
    """While a poison is staged on the canary host, primary traffic is
    bit-equal to the good model, and the mirrored shadows stay out of
    the tenant served counters."""
    from veles_tpu_torch.serve import LocalHostControl
    plans, good = _mlp_spec(seed=3)
    poison = [dict(p) for p in good]
    poison[0] = dict(poison[0], weights=numpy.ascontiguousarray(
        good[0]["weights"] * 50.0))
    hosts, router = _fleet(plans, good, hedge=False)
    try:
        host_ids = sorted(router.snapshot()["hosts"])
        controls = {hid: LocalHostControl(hosts.entries[i][1])
                    for i, hid in enumerate(host_ids)}
        x = numpy.random.RandomState(9).rand(4, 16).astype(numpy.float32)
        reference = hosts.entries[0][0].infer(x)
        pairs = []
        slice_ = router.begin_canary_slice(
            host_ids[0], fraction=1.0, seed=1,
            on_pair=lambda *pair: pairs.append(pair))
        receipt = controls[host_ids[0]].stage(poison)
        assert receipt["new_compiles"] == 0 and receipt["captures"] == 0
        slice_.armed = True
        served_int = _counter("serve.tenant.interactive.requests")
        n = 24
        for i in range(n):
            out = router.infer(x[i % 4], timeout=15.0,
                               slo_class="interactive")
            assert (out == reference[i % 4]).all()
        deadline = time.monotonic() + 10.0
        while len(pairs) < n and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(pairs) == n
        assert any(not numpy.array_equal(p, s) for p, s, _, _ in pairs)
        assert _counter("serve.tenant.interactive.requests") \
            - served_int == n
        controls[host_ids[0]].revert()
        stats = router.end_canary_slice()
        assert stats["mirrored"] == n and stats["pairs"] == n
        assert stats["shadow_errors"] == 0
        for i in range(4):
            assert (router.infer(x[i], timeout=15.0)
                    == reference[i]).all()
    finally:
        router.stop()
        hosts.stop()
