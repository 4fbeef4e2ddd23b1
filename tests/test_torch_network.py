"""The port's master-slave control plane (veles_tpu_torch/server.py,
client.py, network_common.py) on the CPU, against the JAX package's.

- The counterparts of tests/test_network.py: payload codecs, the full
  job cycle (sync and async slave), the checksum reject and its reason,
  slave death and requeue, frame authentication both ways, pause and
  resume, the shm bypass on and off; in-process master and slave over
  127.0.0.1.
- ``pack_payload`` gives the JAX package's bytes for the same object,
  and a port master's job payload is byte for byte a JAX master's on
  the same seeds.
- The slice held against the JAX package: tests/test_network.py's
  seeded momentum MLP runs master + one sync slave in each package for
  3 epochs; the masters' ``epoch_metrics`` are equal and their final
  weights and accumulators agree within 1e-4 (max-rel, the workflow
  tests' epoch limit).  A tiny conv + max-pool net does the same for
  one epoch (the JAX side's level-0 backward in interpret mode), so the
  GD conv and pooling units' solver-state deltas are held too.
- The counterpart of tests/test_cli.py's Server and Client flags, and
  of tests/test_health.py's TTL blacklist and per-slave respawn
  backoff.
"""

import threading
import time

import numpy
import pytest

from tests.torch_master_slave import (  # noqa: F401
    CPU, LAYERS, Blobs, build, port_net_isolated, start_server, weights)
from veles_tpu_torch.client import Client
from veles_tpu_torch.network_common import (
    ProtocolError, ShmChannel, available_codecs, decode_payload,
    encode_payload, pack_payload, parse_address, unpack_payload)

#: the workflow tests' epoch limit (tests/test_torch_workflow.py)
EPOCH_TOL = 1e-4


def _max_rel(a, b):
    a = numpy.asarray(a, numpy.float64)
    b = numpy.asarray(b, numpy.float64)
    return float(numpy.abs(a - b).max() / max(numpy.abs(b).max(), 1e-30))


def test_payload_codecs_roundtrip():
    obj = {"x": numpy.arange(1000), "s": "hello", "n": None}
    for codec in ("none", "gzip"):
        back = decode_payload(encode_payload(obj, codec))
        numpy.testing.assert_array_equal(back["x"], obj["x"])
        assert back["s"] == "hello" and back["n"] is None


def test_all_codecs_roundtrip():
    obj = {"x": numpy.arange(2000, dtype=numpy.float32), "s": "веles"}
    codecs = available_codecs()
    assert {"none", "gzip", "bz2", "xz"} <= set(codecs)
    for codec in codecs:
        back = unpack_payload(pack_payload(obj, codec), codec)
        numpy.testing.assert_array_equal(back["x"], obj["x"])
        assert back["s"] == obj["s"]
    with pytest.raises(ValueError):
        pack_payload(obj, "brotli")


@pytest.mark.parametrize("codec", ["none", "gzip", "bz2", "xz"])
def test_pack_payload_gives_jax_bytes(codec):
    from veles_tpu import network_common as jnc
    rng = numpy.random.RandomState(3)
    obj = [None, {"indices": rng.randint(0, 99, 17).astype(numpy.int32),
                  "minibatch_class": 2, "minibatch_size": 17,
                  "minibatch_offset": 97, "epoch_number": 1},
           {"weights": rng.randn(16, 32).astype(numpy.float32),
            "bias": rng.randn(32).astype(numpy.float32)},
           {"complete": False}, {"n_err": [0, 3, 11]}, True]
    assert pack_payload(obj, codec) == jnc.pack_payload(obj, codec)
    assert encode_payload(obj, codec) == jnc.encode_payload(obj, codec)
    assert parse_address("10.0.0.1:99") == jnc.parse_address("10.0.0.1:99")
    assert parse_address(":7") == jnc.parse_address(":7")


def _jax_build(mode, seed_key, max_epochs=3, layers=LAYERS, image=False):
    """tests/test_network.py's _build, the layer-init stream seeded as
    the port's (tests/torch_master_slave.build)."""
    from veles_tpu import prng as jprng
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyWorkflow as JaxDummy
    from veles_tpu.models.nn_workflow import StandardWorkflow as JaxSW
    from veles_tpu.prng import RandomGenerator as JaxRG
    from tests.test_models import BlobsLoader
    loader = _jax_image_blobs() if image else BlobsLoader
    jprng.get().seed(4242)
    wf = JaxDummy()
    wf.workflow.workflow_mode = mode
    sw = JaxSW(wf.workflow, layers=[dict(spec) for spec in layers],
               loader_factory=lambda w: loader(
                   w, minibatch_size=64, prng=JaxRG(seed_key, seed=7)),
               decision_config=dict(max_epochs=max_epochs))
    sw.initialize(device=JaxDevice(backend="cpu"))
    return sw


def test_job_payload_is_jax_bytes():
    """A port master's first job for a slave pickles to the JAX
    master's bytes on the same seeds: the same loader window, the same
    initial weights, zero accumulators, the decision's flag."""
    from veles_tpu.server import SlaveDescription as JaxSlave
    from veles_tpu_torch.server import SlaveDescription
    jax_master = _jax_build("master", "pay_m")
    port_master = build("master", "pay_m")
    for _ in range(3):
        want = jax_master.generate_data_for_slave(JaxSlave("s", "m", 0, 1))
        got = port_master.generate_data_for_slave(
            SlaveDescription("s", "m", 0, 1))
        assert pack_payload(got) == pack_payload(want)


@pytest.mark.parametrize("async_slave", [False, True])
def test_master_slave_full_cycle(async_slave):
    master = build("master", "net_m")
    slave = build("slave", "net_s")
    server, _ = start_server(master)
    client = Client("127.0.0.1:%d" % server.port, slave,
                    async_slave=async_slave)
    client.run()  # until the master says stop
    assert server._done.wait(10)
    assert client.jobs_done > 0
    assert server.jobs_dispatched >= client.jobs_done
    assert server.updates_applied > 0
    assert bool(master.decision.complete)
    assert master.decision.epoch_metrics[1] is not None
    assert master.decision.epoch_metrics[1] < 15.0, \
        "validation error %s%%" % master.decision.epoch_metrics[1]
    assert numpy.isfinite(weights(master)[0]).all()


class _ChecksumProxy(object):
    """Wraps a workflow but lies about its checksum."""

    def __init__(self, workflow):
        self._wf = workflow

    checksum = "bogus"

    def __getattr__(self, name):
        return getattr(self._wf, name)


def test_checksum_mismatch_rejected_with_reason():
    master = build("master", "net_m2")
    slave = build("slave", "net_s2")
    server, _ = start_server(master)
    client = Client("127.0.0.1:%d" % server.port, slave)
    object.__setattr__(client, "workflow", _ChecksumProxy(slave))
    try:
        client.run()
    finally:
        server.stop()
        server._done.wait(5)
    assert client.jobs_done == 0
    assert client._stopping  # gave up after the reject
    assert client.reject_reason == "checksum mismatch"


def test_slave_death_requeues_jobs():
    """A slave that dies on every job: the master requeues its pending
    minibatches and a healthy slave finishes the run."""
    master = build("master", "net_m3")
    server, _ = start_server(master)
    doomed = build("slave", "net_s3")
    doomed_client = Client("127.0.0.1:%d" % server.port, doomed,
                           death_probability=1.0, reconnect_limit=1)
    doomed_client.run()
    assert doomed_client.jobs_done == 0
    deadline = time.time() + 5
    while not master.loader.failed_minibatches and time.time() < deadline:
        time.sleep(0.02)
    assert master.loader.total_failed >= 1
    healthy = build("slave", "net_s4")
    healthy_client = Client("127.0.0.1:%d" % server.port, healthy)
    healthy_client.run()
    assert server._done.wait(10)
    assert bool(master.decision.complete)
    assert healthy_client.jobs_done > 0


def test_frame_auth_full_cycle():
    master = build("master", "net_m5", max_epochs=2)
    slave = build("slave", "net_s5", max_epochs=2)
    server, _ = start_server(master, secret=b"sesame")
    client = Client("127.0.0.1:%d" % server.port, slave, secret=b"sesame")
    client.run()
    assert server._done.wait(10)
    assert client.jobs_done > 0
    assert bool(master.decision.complete)


def test_frame_auth_mismatch_rejected():
    master = build("master", "net_m6")
    slave = build("slave", "net_s6")
    server, _ = start_server(master, secret=b"right")
    client = Client("127.0.0.1:%d" % server.port, slave,
                    secret=b"wrong", reconnect_limit=1)
    try:
        client.run()
    finally:
        server.stop()
        server._done.wait(5)
    assert client.jobs_done == 0
    assert server.updates_applied == 0


def test_pause_resume():
    master = build("master", "net_m8", max_epochs=2)
    slave = build("slave", "net_s8", max_epochs=2)
    server, _ = start_server(master)
    server.pause()
    client = Client("127.0.0.1:%d" % server.port, slave)
    cthread = client.start_background()
    deadline = time.time() + 5
    while client.sid is None and time.time() < deadline:
        time.sleep(0.01)
    assert client.sid is not None, "the handshake succeeds while paused"
    time.sleep(0.5)
    assert client.jobs_done == 0, "no jobs flow while paused"
    assert client.paused
    assert server.paused
    server.resume()
    cthread.join(20)
    assert server._done.wait(10)
    assert client.jobs_done > 0
    assert bool(master.decision.complete)


def test_shm_channel_slots():
    chan = ShmChannel.create(1 << 12)
    try:
        peer = ShmChannel.attach(chan.name)
        try:
            a = chan.write(b"first")
            b = chan.write(b"second")
            assert a[0] != b[0], "slots alternate"
            assert peer.read(*a) == b"first"
            assert peer.read(*b) == b"second"
            c = chan.write(b"third")
            assert c[0] == a[0]
            assert peer.read(*c) == b"third"
            assert chan.write(b"x" * (1 << 12)) is None
            with pytest.raises(ProtocolError):
                peer.read(1 << 11, 1 << 12)
        finally:
            peer.close()
    finally:
        chan.close()


@pytest.mark.parametrize("use_shm", [True, False])
def test_shm_bypass(use_shm):
    """Same-host master and slave: with the bypass on, payloads ride
    shared memory both ways; off, every payload rides the socket."""
    master = build("master", "net_m9", max_epochs=2)
    slave = build("slave", "net_s9", max_epochs=2)
    server, _ = start_server(master, use_shm=use_shm)
    client = Client("127.0.0.1:%d" % server.port, slave)
    client.run()
    assert server._done.wait(10)
    assert client.jobs_done > 0
    assert bool(master.decision.complete)
    if use_shm:
        assert server.shm_sends > 0 and client.shm_sends > 0
    else:
        assert server.shm_sends == 0 and client.shm_sends == 0


# -- the slice held against the JAX package -------------------------------


def _jax_run(mode_pairs):
    from veles_tpu.client import Client as JaxClient
    from veles_tpu.server import Server as JaxServer
    master, slave = mode_pairs
    server = JaxServer("127.0.0.1:0", master)
    master.workflow.on_workflow_finished = server.on_workflow_finished
    server.start_background()
    assert server.wait_listening(10)
    JaxClient("127.0.0.1:%d" % server.port, slave).run()
    assert server._done.wait(60)
    return server


def _port_run(master, slave):
    server, _ = start_server(master)
    Client("127.0.0.1:%d" % server.port, slave).run()
    assert server._done.wait(60)
    return server


def _hold_masters(jax_master, port_master):
    assert list(port_master.decision.epoch_metrics) == \
        list(jax_master.decision.epoch_metrics)
    assert port_master.decision.best_metric == \
        jax_master.decision.best_metric
    for jfwd, pfwd in zip(jax_master.forwards, port_master.forwards):
        for name in ("weights", "bias"):
            jarr, parr = getattr(jfwd, name), getattr(pfwd, name)
            if not parr:
                continue
            jarr.map_read()
            parr.map_read()
            assert _max_rel(parr.mem, jarr.mem) < EPOCH_TOL, name
    held = 0
    for jgd, pgd in zip(jax_master.gds, port_master.gds):
        for name in ("accum_weights", "accum_bias"):
            jarr, parr = getattr(jgd, name), getattr(pgd, name)
            if not parr:
                continue
            jarr.map_read()
            parr.map_read()
            assert numpy.abs(parr.mem).max() > 0, name
            assert _max_rel(parr.mem, jarr.mem) < EPOCH_TOL, name
            held += 1
    return held


def test_master_slave_run_equals_jax():
    jax_server = _jax_run((_jax_build("master", "par_m"),
                           _jax_build("slave", "par_s")))
    jax_master = jax_server.workflow
    port_master = build("master", "par_m")
    port_server = _port_run(port_master, build("slave", "par_s"))
    assert port_server.updates_applied == jax_server.updates_applied
    assert port_server.jobs_dispatched == jax_server.jobs_dispatched
    assert port_master.loader.epoch_number == \
        jax_master.loader.epoch_number
    assert _hold_masters(jax_master, port_master) == 4


CONV_LAYERS = [
    {"type": "conv_tanh", "n_kernels": 6, "kx": 3, "ky": 3,
     "padding": 1, "learning_rate": 0.02, "gradient_moment": 0.9},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "softmax", "output_sample_shape": 4,
     "learning_rate": 0.02, "gradient_moment": 0.9},
]


def _load_image_blobs(self):
    self.class_lengths[:] = [0, 64, 256]
    self._calc_class_end_offsets()
    self.create_originals((4, 4, 1))
    rng = numpy.random.RandomState(99)
    centers = rng.randn(4, 4, 4, 1) * 2.0
    for i in range(self.total_samples):
        label = i % 4
        self.original_data.mem[i] = (
            centers[label] + rng.randn(4, 4, 1) * 0.3)
        self.original_labels[i] = label


class ImageBlobs(Blobs):
    """The blobs as (4, 4, 1) images."""

    load_data = _load_image_blobs


def _jax_image_blobs():
    from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFBL
    return type("JaxImageBlobs", (JaxFBL,),
                {"load_data": _load_image_blobs})


def test_master_slave_conv_pool_equals_jax(monkeypatch):
    from veles_tpu.ops import common as jax_common
    monkeypatch.setattr(jax_common, "PALLAS_BWD_ENV", "1")
    jax_server = _jax_run((
        _jax_build("master", "cnv_m", max_epochs=1, layers=CONV_LAYERS,
                   image=True),
        _jax_build("slave", "cnv_s", max_epochs=1, layers=CONV_LAYERS,
                   image=True)))
    port_master = build("master", "cnv_m", max_epochs=1,
                        layers=CONV_LAYERS, loader=ImageBlobs)
    port_server = _port_run(port_master, build(
        "slave", "cnv_s", max_epochs=1, layers=CONV_LAYERS,
        loader=ImageBlobs))
    assert port_server.updates_applied == jax_server.updates_applied
    # the conv's and the softmax's weight and bias velocities
    assert _hold_masters(jax_server.workflow, port_master) == 4


# -- the Server's and Client's flags; quarantine TTL and respawn backoff --


def test_server_and_client_flags_reach_their_constructors():
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.cmdline import apply_parsed_args
    from veles_tpu_torch.config import root
    from veles_tpu_torch.server import Server
    parser = Main().init_parser()
    args = parser.parse_args([
        "wf.py", "-", "--job-timeout", "123.5", "--async-slave",
        "--reconnect-limit", "3", "--codec", "gzip", "--no-shm",
        "--blacklist-ttl", "7", "--speculation-factor", "3",
        "--min-speculation-s", "0.5", "--listen-address", "0.0.0.0:9999"])
    saved = {node: dict(node.__dict__) for node in (
        root.common.network, root.common.launcher, root.common.observe,
        root.common.snapshot)}
    try:
        apply_parsed_args(args)
        assert root.common.network.get("job_timeout") == 123.5
        assert root.common.network.get("async_slave") is True
        assert root.common.launcher.get("listen_address") == "0.0.0.0:9999"
        server = Server("127.0.0.1:0", None)
        assert server.job_timeout == 123.5
        assert server.codec == "gzip" and server.use_shm is False
        assert server.blacklist_ttl == 7
        assert server.speculation_factor == 3
        assert server.min_speculation_s == 0.5
        client = Client("127.0.0.1:1", None)
        assert client.async_slave is True
        assert client.reconnect_limit == 3
        assert client.codec == "gzip"
    finally:
        for node, state in saved.items():
            node.__dict__.clear()
            node.__dict__.update(state)


class _StubMasterWorkflow(object):
    checksum = "stub"


@pytest.mark.health
def test_blacklist_ttl_expires():
    from veles_tpu_torch.server import Server
    server = Server("127.0.0.1:0", _StubMasterWorkflow(),
                    blacklist_ttl=30.0)
    server._blacklist("m1")
    assert server._blacklisted("m1")
    assert not server._blacklisted("m2")
    server.blacklist["m1"] = 0.0
    assert not server._blacklisted("m1")
    assert "m1" not in server.blacklist


@pytest.mark.health
def test_respawn_backoff_is_per_slave():
    from veles_tpu_torch.server import Server
    server = Server("127.0.0.1:0", _StubMasterWorkflow())
    assert server._respawn_delay("a") == 2.0
    assert server._respawn_delay("a") == 4.0
    assert server._respawn_delay("a") == 8.0
    assert server._respawn_delay("b") == 2.0
    for _ in range(10):
        delay = server._respawn_delay("a")
    assert delay == 30.0
    server._respawn_attempts.pop("a", None)
    assert server._respawn_delay("a") == 2.0


@pytest.mark.chaos
def test_client_reconnects_twice_across_healthy_intervals():
    """The attempt budget bounds CONSECUTIVE unproductive attempts; a
    productive session resets it, so two blips survive
    reconnect_limit=1 (tests/test_chaos.py's counterpart)."""
    import asyncio

    from veles_tpu_torch.network_common import read_frame, write_frame
    handshakes = []
    stop_after = 3

    async def handle(reader, writer):
        msg, _ = await read_frame(reader)
        assert msg["type"] == "handshake"
        handshakes.append(msg)
        write_frame(writer, {"type": "handshake_ack",
                             "id": "s%d" % len(handshakes),
                             "codec": "none"}, pack_payload([]))
        await read_frame(reader)  # job_request
        if len(handshakes) >= stop_after:
            write_frame(writer, {"type": "stop"})
            await writer.drain()
            writer.close()
            return
        write_frame(writer, {"type": "job", "job_id": "j",
                             "codec": "none"}, pack_payload(None))
        await read_frame(reader)  # the update: a productive session
        writer.close()

    class _StubWorkflow(object):
        checksum = "stub"
        device = CPU

        def apply_initial_data_from_master(self, data):
            pass

        def do_job(self, data, update, callback):
            callback({"ok": True})

    started = threading.Event()
    port = [0]

    def serve():
        async def main():
            server = await asyncio.start_server(handle, "127.0.0.1", 0)
            port[0] = server.sockets[0].getsockname()[1]
            started.set()
            async with server:
                for _ in range(200):
                    await asyncio.sleep(0.05)
                    if len(handshakes) >= stop_after:
                        await asyncio.sleep(0.5)
                        return
        asyncio.run(main())

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    assert started.wait(5)
    client = Client("127.0.0.1:%d" % port[0], _StubWorkflow(),
                    reconnect_limit=1)
    client.run()
    assert client.sessions_established == stop_after
    assert client.jobs_done == stop_after - 1
    thread.join(10)
