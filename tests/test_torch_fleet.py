"""The port's multi-host serve tier (veles_tpu_torch/serve/fleet.py)
against the JAX package's, on the CPU.

- The fast cases of tests/test_serve_fleet.py on the port: membership
  epochs over the pipelined link, least-loaded routing bit-equal to the
  sequential engine, the hedge's first result winning, the duplicate
  fence under chaos ``serve.hedge.lose_race``, a host killed with
  requests wedged on it (zero failed, requeued), the cascade to a 503
  carrying the fleet's minimum ``retry_after``, the rejoin receipt
  (``new_compiles``, ``kernel_builds`` and ``captures`` all 0 on the
  CPU, where nothing is captured), the idle keepalive and the refusal
  of a second digest.
- The same seeded inputs through a JAX fleet: the port's answers equal
  the JAX fleet's within 1e-5 max-rel.
- Across the packages: the router's frames (pipelined hello, infer,
  cancel, telemetry poll) are byte for byte the JAX package's; a port
  front serves over a JAX host and a JAX front over a port host; the
  two packages' digests differ for the same params (the port's mixes
  in the torch version), so one router refuses a fleet that mixes them.
- The telemetry polls: NTP offsets near 0 in process, the hosts' series
  chunks in ``fleet_rollup()``, the router's alert manager in
  ``/healthz``.

Hosts are in-process socketpair adoptions: no port binds.  Every
router, host and batcher stops in ``finally``, and every wait has its
own deadline.
"""

import socket
import time

import numpy
import pytest

from tests.test_torch_serve_tier import _mlp_spec
from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch import chaos
from veles_tpu_torch.backends import Device
from veles_tpu_torch.observe.metrics import registry
from veles_tpu_torch.serve import (
    AOTEngine, BinaryTransportServer, ContinuousBatcher, FleetRouter,
    ServeOverload, ServeService, serve_snapshot)

pytestmark = [pytest.mark.serve, pytest.mark.fleet]

CPU = Device(backend="cpu")


class _Hosts(object):
    """N in-process port serve hosts (engine + batcher + transport)
    sharing one spec, and the socketpair plumbing into a router."""

    def __init__(self, n, plans, params, first=0):
        self.entries = []
        try:
            for i in range(n):
                self.entries.append(self.build(plans, params,
                                               "h%d" % (first + i)))
        except Exception:
            self.stop()
            raise

    @staticmethod
    def build(plans, params, host_id):
        engine = AOTEngine(plans, params, (16,), ladder=(8, 32),
                           device=CPU)
        engine.compile()
        batcher = ContinuousBatcher(engine, max_delay_s=0.002).start()
        server = BinaryTransportServer(batcher, port=None,
                                       host_meta={"host_id": host_id})
        server.start_background()
        return [engine, batcher, server]

    def connect(self, router, i):
        ours, theirs = socket.socketpair()
        self.entries[i][2].serve_socket(ours)
        return router.add_host(sock=theirs)

    def stop(self, i=None):
        which = self.entries if i is None else [self.entries[i]]
        for engine, batcher, server in which:
            server.stop()
            batcher.stop()


@pytest.fixture
def fleet():
    """Two port hosts behind a hedging port router, and the sequential
    reference engine."""
    plans, params = _mlp_spec(seed=3)
    hosts = _Hosts(2, plans, params)
    router = FleetRouter(hedge_factor=1.5, hedge_floor_s=0.05,
                         hedge_tick_s=0.01).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
        yield hosts, router, hosts.entries[0][0]
    finally:
        router.stop()
        hosts.stop()


def _counter(name):
    return registry.counter(name).value


def _wait_for(predicate, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError("timed out waiting for " + what)


def _max_rel(got, want):
    got = numpy.asarray(got, numpy.float64)
    want = numpy.asarray(want, numpy.float64)
    return float(numpy.max(numpy.abs(got - want) /
                           numpy.maximum(numpy.abs(want), 1e-30)))


def _jax_fleet_answers(rows, block):
    """The JAX fleet (two JAX hosts, a JAX router) on the same spec and
    inputs: its per-row answers and its block answer."""
    from tests.test_serve import _mlp_spec as jax_mlp_spec
    from tests.test_serve_fleet import _Hosts as JaxHosts
    from veles_tpu.serve import FleetRouter as JaxRouter
    plans, params = jax_mlp_spec(seed=3)
    hosts = JaxHosts(2, plans, params)
    router = JaxRouter(hedge=False).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
        singles = [router.infer(row, timeout=15.0) for row in rows]
        return numpy.stack(singles), router.infer_block(block,
                                                        timeout=15.0)
    finally:
        router.stop()
        hosts.stop()


def test_fleet_routes_bit_identical_with_membership_epochs(fleet):
    """Routed singles and blocks equal the sequential engine bit for bit
    wherever they land, and the JAX fleet's answers within 1e-5; each
    join bumped the epoch once; serve_snapshot carries the fleet keys."""
    hosts, router, engine = fleet
    x = numpy.random.RandomState(1).rand(6, 16).astype(numpy.float32)
    ref = engine.infer(x)
    got = []
    for row, want in zip(x, ref):
        out = router.infer(row, timeout=15.0)
        assert (out == want).all()
        got.append(out)
    block = router.infer_block(numpy.ascontiguousarray(x), timeout=15.0)
    assert (block == ref).all()
    assert router.fleet.membership_epoch == 2
    snap = router.snapshot()
    assert snap["hosts_live"] == 2
    assert snap["digest"] == engine.digest
    summary = serve_snapshot()
    assert summary["hosts_live"] == 2
    assert summary["fleet_membership_epoch"] == 2
    assert any(h["throughput_ema"] != 1.0
               for h in snap["hosts"].values())
    jax_singles, jax_block = _jax_fleet_answers(x, x)
    assert _max_rel(numpy.stack(got), jax_singles) <= 1e-5
    assert _max_rel(block, jax_block) <= 1e-5


@pytest.mark.chaos
def test_hedged_first_result_wins_bit_identity(fleet):
    """A ``serve.host.stall`` straggler: the hedge fires past the
    threshold and the sibling's answer, bit-equal to the reference,
    arrives well under the stall."""
    hosts, router, engine = fleet
    x = numpy.random.RandomState(2).rand(3, 16).astype(numpy.float32)
    ref = engine.infer(x)
    for i in range(router.hedge_warmup):
        router.infer(x[i % 2], timeout=15.0)
    fired = _counter("serve.hedge.fired")
    wins = _counter("serve.hedge.wins")
    chaos.install(chaos.FaultPlan(seed=1).add(
        "serve.host.stall", "stall", nth=1, param=2.0))
    try:
        t0 = time.perf_counter()
        out = router.infer(x[2], timeout=15.0)
        elapsed = time.perf_counter() - t0
    finally:
        chaos.uninstall()
    assert (out == ref[2]).all()
    assert elapsed < 1.5, "the hedge must beat the 2 s straggler " \
        "(took %.2fs)" % elapsed
    assert _counter("serve.hedge.fired") == fired + 1
    assert _counter("serve.hedge.wins") == wins + 1


@pytest.mark.chaos
def test_lose_race_duplicate_result_rejected(fleet):
    """``serve.hedge.lose_race`` skips the loser's cancel: its late
    result meets the exactly-once fence and is dropped, the answer
    unchanged."""
    hosts, router, engine = fleet
    x = numpy.random.RandomState(4).rand(16).astype(numpy.float32)
    ref = engine.infer(x)
    for _ in range(router.hedge_warmup):
        router.infer(x, timeout=15.0)
    dups = _counter("serve.hedge.duplicates_dropped")
    chaos.install(chaos.FaultPlan(seed=1)
                  .add("serve.host.stall", "stall", nth=1, param=0.4)
                  .add("serve.hedge.lose_race", "skip"))
    try:
        out = router.infer(x, timeout=15.0)
        assert (out == ref[0]).all()
        _wait_for(lambda: _counter("serve.hedge.duplicates_dropped")
                  > dups, what="duplicate rejection")
    finally:
        chaos.uninstall()


@pytest.mark.chaos
def test_host_kill_requeues_in_flight_zero_drops():
    """A host severed with requests wedged on it: the epoch bumps,
    its in-flight requests requeue to the survivor, and every request
    completes bit-equal: zero failed."""
    plans, params = _mlp_spec(seed=3)
    hosts = _Hosts(2, plans, params)
    router = FleetRouter(hedge=False).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
        x = numpy.random.RandomState(5).rand(6, 16).astype(numpy.float32)
        ref = hosts.entries[0][0].infer(x)
        requeues = _counter("serve.fleet.requeues")
        epoch_before = router.fleet.membership_epoch
        chaos.install(chaos.FaultPlan(seed=2).add(
            "serve.host.stall", "stall", times=6, param=0.5))
        try:
            reqs = [router.submit(row) for row in x]
            hosts.stop(0)
            for req in reqs:
                assert req.done.wait(20), "request dropped on the floor"
                assert req.error is None, req.error
        finally:
            chaos.uninstall()
        for req, want in zip(reqs, ref):
            assert (req.result == want).all()
        assert router.fleet.membership_epoch == epoch_before + 1
        assert _counter("serve.fleet.requeues") > requeues
        assert router.snapshot()["hosts_live"] == 1
    finally:
        router.stop()
        hosts.stop(1)


def test_cascade_then_503_with_fleet_minimum_retry_after(fleet):
    """Every live host shedding: the fleet sheds once, with the
    smallest retry_after a host offered, after cascading through both."""
    hosts, router, engine = fleet

    def shedding(retry_after):
        def _admit(slo_class=None):
            raise ServeOverload("test shed", retry_after=retry_after)
        return _admit

    saved = [entry[1]._admit for entry in hosts.entries]
    hosts.entries[0][1]._admit = shedding(0.7)
    hosts.entries[1][1]._admit = shedding(0.3)
    try:
        req = router.submit(numpy.zeros(16, numpy.float32))
        assert req.done.wait(10)
        assert isinstance(req.error, ServeOverload)
        assert req.error.retry_after == pytest.approx(0.3)
    finally:
        for entry, admit in zip(hosts.entries, saved):
            entry[1]._admit = admit
    out = router.infer(numpy.zeros(16, numpy.float32), timeout=15.0)
    assert out.shape == (4,)


def test_rejoin_rewarm_zero_new_compiles_receipt():
    """A restarted host's hello carries its receipt to the router
    before it re-enters rotation: on the CPU nothing is captured or
    built, so ``new_compiles``, ``kernel_builds`` and ``captures`` are
    0; the epoch rises at the leave and again at the rejoin."""
    plans, params = _mlp_spec(seed=6)
    hosts = _Hosts(2, plans, params)
    router = FleetRouter(hedge=False).start()
    try:
        h0 = hosts.connect(router, 0)
        hosts.connect(router, 1)
        assert router.infer(numpy.zeros(16, numpy.float32),
                            timeout=15.0).shape == (4,)
        epoch = router.fleet.membership_epoch
        hosts.stop(0)
        _wait_for(lambda: router.snapshot()["hosts_live"] == 1,
                  what="host loss")
        assert router.fleet.membership_epoch == epoch + 1
        hosts.entries[0] = _Hosts.build(plans, params, "h0")
        assert hosts.entries[0][0].compile_receipt["new_compiles"] == 0
        rejoined = hosts.connect(router, 0)
        assert rejoined == h0
        snap = router.snapshot()
        assert snap["hosts"][rejoined]["new_compiles"] == 0
        info = router.compile_receipt["hosts"][rejoined]
        assert info["kernel_builds"] == 0 and info["captures"] == 0
        assert router.fleet.membership_epoch == epoch + 2
        assert snap["hosts_live"] == 2
        assert router.infer(numpy.zeros(16, numpy.float32),
                            timeout=15.0).shape == (4,)
    finally:
        router.stop()
        hosts.stop()


def test_idle_link_keepalive_does_not_retire_healthy_hosts():
    """A silent link at a frame boundary is pinged, not retired: after
    several keepalive intervals the membership is unchanged."""
    plans, params = _mlp_spec(seed=3)
    hosts = _Hosts(2, plans, params)
    router = FleetRouter(hedge=False, keepalive_s=0.2).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
        x = numpy.zeros(16, numpy.float32)
        router.infer(x, timeout=15.0)
        epoch = router.fleet.membership_epoch
        time.sleep(1.0)
        assert router.snapshot()["hosts_live"] == 2
        assert router.fleet.membership_epoch == epoch
        assert router.infer(x, timeout=15.0).shape == (4,)
    finally:
        router.stop()
        hosts.stop()


def test_digest_mismatch_refused(fleet):
    """One fleet serves one digest: a host of other shapes is refused
    at the handshake."""
    hosts, router, engine = fleet
    plans, params = _mlp_spec(seed=9, hidden=8)
    other = _Hosts(1, plans, params, first=5)
    try:
        with pytest.raises(ValueError, match="mixed fleet"):
            other.connect(router, 0)
        assert router.snapshot()["hosts_live"] == 2
    finally:
        other.stop()


# -- across the packages ------------------------------------------------------


class _RecordingSocket(object):
    """A socket stand-in: records what a HostLink sends and answers its
    hello with a scripted pipelined reply."""

    def __init__(self, reply):
        self.sent = []
        self._inbox = bytearray(reply)

    def settimeout(self, _):
        pass

    def sendall(self, data):
        self.sent.append(bytes(data))

    def recv(self, n):
        if not self._inbox:
            raise ConnectionError("closed")
        chunk = bytes(self._inbox[:n])
        del self._inbox[:n]
        return chunk

    def close(self):
        pass


def test_fleet_frames_byte_for_byte_jax(monkeypatch):
    """The router's frames, as each package's HostLink sends them: the
    pipelined hello, an infer with class, shadow and trace, a cancel
    and a telemetry poll are the same bytes."""
    import time as time_mod

    from veles_tpu.serve import fleet as jax_fleet
    from veles_tpu_torch.network_common import pack_frame
    from veles_tpu_torch.serve import fleet as port_fleet
    monkeypatch.setattr(time_mod, "time", lambda: 1234.5)
    reply = pack_frame({"op": "hello", "mid": "m", "digest": "d",
                        "dtype": "<f4", "sample_shape": [16],
                        "max_batch": 32, "ladder": [8, 32],
                        "pipeline": True, "shm_ok": False,
                        "shm_reply_ok": False,
                        "host": {"host_id": "h0", "new_compiles": 0}})
    sent = []
    for mod in (port_fleet, jax_fleet):
        sock = _RecordingSocket(reply)
        link = mod.HostLink(sock=sock, secret=b"")
        assert link.host_info["host_id"] == "h0"
        assert link.ladder == (8, 32)
        link.send_infer(7, numpy.arange(16, dtype=numpy.float32),
                        slo_class="interactive", shadow=True,
                        trace="t-1")
        link.send_cancel(7)
        link.send_telemetry_poll()
        sent.append(sock.sent)
    assert sent[0] == sent[1]
    assert len(sent[0]) == 4


def test_port_front_serves_over_a_jax_host():
    """A port FleetRouter over a JAX serve host on a socketpair: the
    pipelined link, the host block and the answers (bit-equal to the
    JAX engine) all cross the package boundary."""
    from tests.test_serve import _mlp_spec as jax_mlp_spec
    from tests.test_serve_fleet import _Hosts as JaxHosts
    plans, params = jax_mlp_spec(seed=3)
    hosts = JaxHosts(1, plans, params)
    router = FleetRouter(hedge=False).start()
    try:
        hid = hosts.connect(router, 0)
        assert hid == "h0"
        x = numpy.random.RandomState(7).rand(4, 16).astype(numpy.float32)
        want = hosts.entries[0][0].infer(x)
        for row, ref in zip(x, want):
            assert (router.infer(row, timeout=15.0) == ref).all()
        assert (router.infer_block(x, timeout=15.0) == want).all()
        assert router.snapshot()["digest"] == hosts.entries[0][0].digest
    finally:
        router.stop()
        hosts.stop()


def test_jax_front_serves_over_a_port_host_and_refuses_a_mixed_fleet():
    """A JAX FleetRouter over a port host answers bit-equal to the
    port engine.  The two packages' digests of the same params differ
    (the port's mixes in the torch version), so the router refuses
    the JAX host beside it as a mixed fleet."""
    from tests.test_serve import _mlp_spec as jax_mlp_spec
    from tests.test_serve_fleet import _Hosts as JaxHosts
    from veles_tpu.serve import FleetRouter as JaxRouter
    plans, params = _mlp_spec(seed=3)
    port_hosts = _Hosts(1, plans, params)
    jax_hosts = JaxHosts(1, *jax_mlp_spec(seed=3))
    router = JaxRouter(hedge=False).start()
    try:
        ours, theirs = socket.socketpair()
        port_hosts.entries[0][2].serve_socket(ours)
        assert router.add_host(sock=theirs) == "h0"
        x = numpy.random.RandomState(8).rand(3, 16).astype(numpy.float32)
        want = port_hosts.entries[0][0].infer(x)
        for row, ref in zip(x, want):
            assert (router.infer(row, timeout=15.0) == ref).all()
        assert port_hosts.entries[0][0].digest != \
            jax_hosts.entries[0][0].digest
        with pytest.raises(ValueError, match="mixed fleet"):
            jax_hosts.connect(router, 0)
    finally:
        router.stop()
        port_hosts.stop()
        jax_hosts.stop()


def test_telemetry_polls_offsets_rollup_and_health(fleet, monkeypatch):
    """The watchdog's telemetry polls: each host's clock offset (same
    process, so near 0), its series chunks in ``fleet_rollup()``, and
    the front's ``/healthz`` body with the fleet block and the router's
    own alert manager; the poll reply carries JAX's keys."""
    from veles_tpu.serve.transport import \
        BinaryTransportServer as JaxServer
    from veles_tpu_torch.observe.timeseries import series
    hosts, router, engine = fleet
    router.stop()
    monkeypatch.setattr(series, "interval_s", 0.05)
    router = FleetRouter(hedge=False, telemetry_interval_s=0.05).start()
    try:
        for i in range(2):
            hosts.connect(router, i)
        x = numpy.zeros(16, numpy.float32)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            router.infer(x, timeout=15.0)
            # every poll reply closes a clock probe; the hosts share
            # this process's one series ring, so its buckets go to
            # whichever poll takes them first
            probed = set(router.telemetry._probes)
            if probed >= {"h0", "h1"} and router.fleet_rollup():
                break
            time.sleep(0.05)
        assert set(router.telemetry._probes) >= {"h0", "h1"}
        for host in ("h0", "h1"):
            assert abs(router.telemetry.offset(host)) < 0.5
        cells = router.fleet_rollup()
        assert cells and any("serve.requests" in c["counters"]
                             for c in cells)
        health = ServeService(router).health()
        assert health["fleet"]["hosts_live"] == 2
        assert health["alerts"] == router.alerts.snapshot()
        assert any(rule.name.startswith("slo_burn.fleet.")
                   for rule in router.alerts.rules)
        assert health["model_digest"] == engine.digest
    finally:
        router.stop()
    port_reply = hosts.entries[0][2]._telemetry_reply(
        {"op": "telemetry", "id": -2, "t0": 1.0})
    jax_reply = JaxServer._telemetry_reply(
        hosts.entries[0][2], {"op": "telemetry", "id": -2, "t0": 1.0})
    assert set(port_reply) == set(jax_reply)
    assert port_reply["host"] == "h0" and port_reply["t0"] == 1.0


def test_pipelined_cancel_retires_the_batchers_requests():
    """A ``cancel`` frame on a pipelined link: the request's batcher
    entries are marked cancelled and no reply is written for it, while
    the link keeps serving."""
    from veles_tpu_torch.network_common import (pack_frame,
                                                read_frame_sync)
    from veles_tpu_torch.serve.transport import encode_tensor
    plans, params = _mlp_spec(seed=3)
    hosts = _Hosts(1, plans, params)
    ours, theirs = socket.socketpair()
    try:
        hosts.entries[0][2].serve_socket(ours)
        theirs.settimeout(10.0)

        def recv(n):
            buf = bytearray()
            while len(buf) < n:
                chunk = theirs.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("closed")
                buf += chunk
            return bytes(buf)

        theirs.sendall(pack_frame({"op": "hello", "mid": "x",
                                   "pipeline": True}))
        hello, _ = read_frame_sync(recv, None)
        assert hello["pipeline"] and hello["host"]["host_id"] == "h0"
        assert hello["host"]["captures"] == 0
        chaos.install(chaos.FaultPlan(seed=1).add(
            "serve.host.stall", "stall", nth=1, param=0.3))
        meta, raw = encode_tensor(numpy.ones(16, numpy.float32))
        theirs.sendall(pack_frame(dict({"op": "infer", "id": 1}, **meta),
                                  raw))
        theirs.sendall(pack_frame({"op": "cancel", "id": 1}))
        theirs.sendall(pack_frame(dict({"op": "infer", "id": 2}, **meta),
                                  raw))
        reply, _ = read_frame_sync(recv, None)
        assert reply["op"] == "result" and reply["id"] == 2
        theirs.settimeout(0.6)
        with pytest.raises(socket.timeout):
            read_frame_sync(recv, None)  # id 1 is answered with nothing
    finally:
        chaos.uninstall()
        theirs.close()
        hosts.stop()


def test_serve_command_fleet_flags_take_jax_defaults():
    """``python -m veles_tpu_torch.serve`` takes every fleet flag of the
    JAX command with the same defaults and the same parsed values."""
    from veles_tpu.serve.__main__ import build_parser as jax_parser
    from veles_tpu_torch.serve.__main__ import build_parser
    flags = ("fleet", "fleet_host", "host_id", "no_hedge", "hedge_budget",
             "max_inflight", "hedge_factor", "hedge_floor_ms",
             "transport_port", "port", "tenant_quota")
    argv_sets = [[], ["--fleet", "a:1,b:2", "--no-hedge",
                      "--hedge-budget", "--max-inflight", "64",
                      "--hedge-factor", "1.5", "--hedge-floor-ms", "20"],
                 ["--demo", "--fleet-host", "--host-id", "h7",
                  "--transport-port", "0"]]
    for argv in argv_sets:
        got = vars(build_parser().parse_args(argv))
        want = vars(jax_parser().parse_args(argv))
        assert {k: got[k] for k in flags} == {k: want[k] for k in flags}
    defaults = vars(build_parser().parse_args([]))
    assert defaults["hedge_factor"] == 2.0
    assert defaults["hedge_floor_ms"] == 50.0
    assert defaults["device"] == "cuda"
