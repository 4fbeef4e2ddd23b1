"""The port's binary transport (veles_tpu_torch/serve/transport.py and
network_common.py) against the JAX package's, on the CPU.

- The cases of tests/test_transport.py: the tensor codec's round trips
  and its refusal of hostile headers, inline round trips over socketpair
  streams (no port binds), a batch wider than the ladder chunked through
  it, the same-host shared-memory bypass with its stale-segment
  fallback, an oversized segment refused at the handshake, a hostile
  length prefix dropping the connection, HMAC, overload as a transient
  error frame, and the batcher's block path the transport feeds.
- Frames are byte for byte the JAX package's, both ways: ``pack_frame``
  (with and without a secret) and ``encode_tensor`` give the same
  bytes, each package reads the other's frames, and a client of each
  package is answered by a server of the other.

Every shared-memory segment a test opens is closed in ``finally``; a
test that leaks one fails.
"""

import socket
import struct

import numpy
import pytest

from tests.test_torch_serve_tier import _mlp_spec
from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch import chaos
from veles_tpu_torch.backends import Device
from veles_tpu_torch.network_common import (ProtocolError, ShmChannel,
                                            pack_frame, read_frame_sync)
from veles_tpu_torch.observe.metrics import registry
from veles_tpu_torch.serve import (
    AOTEngine, BinaryTransportClient, BinaryTransportServer,
    ContinuousBatcher, ServeOverload, decode_tensor, encode_tensor)

pytestmark = [pytest.mark.serve, pytest.mark.transport]

CPU = Device(backend="cpu")


@pytest.fixture(autouse=True)
def _no_port_leaks():
    """The port's own segments must be closed by the code under test;
    a plan left installed must not reach the next test."""
    before = ShmChannel.open_channels()
    yield
    chaos.uninstall()
    leaked = [c for c in ShmChannel.open_channels() if c not in before]
    for chan in leaked:
        chan.close()
    assert not leaked, "leaked ShmChannel segment(s): %s" % sorted(
        c.name for c in leaked)


@pytest.fixture(scope="module")
def engine():
    plans, params = _mlp_spec(seed=3)
    eng = AOTEngine(plans, params, (16,), ladder=(8, 32), device=CPU)
    eng.compile()
    return eng


@pytest.fixture
def served(engine):
    batcher = ContinuousBatcher(engine, max_delay_s=0.002).start()
    server = BinaryTransportServer(batcher, port=None)
    server.start_background()
    clients = []

    def connect(**kwargs):
        ours, theirs = socket.socketpair()
        server.serve_socket(ours)
        cli = BinaryTransportClient(sock=theirs, **kwargs)
        clients.append(cli)
        return cli

    try:
        yield engine, batcher, server, connect
    finally:
        for cli in clients:
            cli.close()
        server.stop()
        batcher.stop()


def _arrays():
    rng = numpy.random.RandomState(0)
    return (rng.rand(4, 7).astype(numpy.float32), rng.rand(2, 3, 4),
            rng.randint(-5, 90, (3, 2)).astype(numpy.int64),
            rng.rand(8) > 0.5,
            numpy.arange(6, dtype=numpy.uint8).reshape(2, 3))


# -- tensor codec -------------------------------------------------------------


def test_tensor_codec_roundtrip_bit_exact():
    for arr in _arrays():
        for codec in ("none", "gzip"):
            meta, raw = encode_tensor(arr, codec)
            out = decode_tensor(meta, raw)
            assert out.dtype == arr.dtype and out.shape == arr.shape
            assert (out == arr).all()
    meta, raw = encode_tensor(numpy.random.RandomState(1).rand(
        4, 4).astype(numpy.float32))
    assert not decode_tensor(meta, raw).flags["OWNDATA"]


def test_tensor_codec_refuses_hostile_frames():
    with pytest.raises(ValueError):
        encode_tensor(numpy.array([object()], dtype=object))
    _, raw = encode_tensor(numpy.zeros(4, numpy.float32))
    hostile = (
        {"dtype": "|O", "shape": [1], "codec": "none"},
        {"dtype": "V8", "shape": [1], "codec": "none"},
        {"dtype": "nope", "shape": [4], "codec": "none"},
        {"dtype": "<f4", "shape": [-1], "codec": "none"},
        {"dtype": "<f4", "shape": [1 << 40], "codec": "none"},
        {"dtype": "<f4", "shape": [3], "codec": "none"},
        {"dtype": "<f4", "shape": [4], "codec": "evil"},
        {"shape": [4], "codec": "none"},
    )
    for meta in hostile:
        with pytest.raises(ProtocolError):
            decode_tensor(meta, raw)


# -- byte for byte with the JAX package ---------------------------------------


@pytest.mark.parametrize("secret", [None, b"sesame"])
def test_frames_byte_identical_both_ways(secret):
    from veles_tpu import network_common as jax_nc
    from veles_tpu.serve import transport as jax_transport
    msgs = [({"op": "hello", "mid": "x", "shm": "seg"}, b""),
            ({"op": "ping", "id": 3}, b""),
            ({"op": "error", "id": 1, "error": "queue full",
              "transient": True, "retry_after": 0.0512}, b"")]
    for arr in _arrays():
        for codec in ("none", "gzip"):
            meta, raw = encode_tensor(arr, codec)
            jmeta, jraw = jax_transport.encode_tensor(arr, codec)
            assert meta == jmeta
            if codec == "none":
                assert raw == jraw
            msg = {"op": "infer", "id": 7}
            msg.update(meta)
            msgs.append((msg, raw))
    for msg, payload in msgs:
        frame = pack_frame(msg, payload, secret)
        assert frame == jax_nc.pack_frame(msg, payload, secret)
        for reader, packed in ((jax_nc.read_frame_sync, frame),
                               (read_frame_sync,
                                jax_nc.pack_frame(msg, payload, secret))):
            pos = [0]

            def recv_exactly(n, data=packed):
                chunk = data[pos[0]:pos[0] + n]
                pos[0] += n
                return chunk
            got, raw = reader(recv_exactly, secret)
            assert got == msg and raw == payload
        if msg["op"] == "infer":
            mine = decode_tensor(msg, payload)
            theirs = jax_transport.decode_tensor(msg, payload)
            assert mine.dtype == theirs.dtype
            assert (mine == theirs).all()


def _jax_engine():
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.serve import AOTEngine as JaxEngine
    from tests.test_serve import _mlp_spec as jax_mlp_spec
    plans, params = jax_mlp_spec(seed=3)
    eng = JaxEngine(plans, params, (16,), ladder=(8, 32),
                    device=JaxDevice(backend="cpu"))
    eng.compile()
    return eng


def test_port_client_talks_to_jax_server():
    from veles_tpu.serve import BinaryTransportServer as JaxServer
    from veles_tpu.serve import ContinuousBatcher as JaxBatcher
    jengine = _jax_engine()
    batcher = JaxBatcher(jengine, max_delay_s=0.002).start()
    server = JaxServer(batcher, port=None)
    server.start_background()
    cli = None
    try:
        ours, theirs = socket.socketpair()
        server.serve_socket(ours)
        cli = BinaryTransportClient(sock=theirs, shm=False)
        assert cli.server_digest == jengine.digest
        x = numpy.random.RandomState(4).rand(11, 16).astype(
            numpy.float32)
        assert (cli.infer(x) == jengine.infer(x)).all()
        assert (cli.infer(x[0]) == jengine.infer(x[:1])).all()
        assert cli.ping()
    finally:
        if cli is not None:
            cli.close()
        server.stop()
        batcher.stop()


def test_jax_client_talks_to_port_server(engine):
    from veles_tpu.serve import BinaryTransportClient as JaxClient
    batcher = ContinuousBatcher(engine, max_delay_s=0.002).start()
    server = BinaryTransportServer(batcher, port=None)
    server.start_background()
    cli = None
    try:
        ours, theirs = socket.socketpair()
        server.serve_socket(ours)
        cli = JaxClient(sock=theirs, shm=False)
        assert cli.server_digest == engine.digest
        assert cli.sample_shape == (16,) and cli.max_batch == 32
        x = numpy.random.RandomState(5).rand(40, 16).astype(
            numpy.float32)
        assert (cli.infer(x) == engine.infer(x)).all()
        assert (cli.infer(x[0]) == engine.infer(x[:1])).all()
    finally:
        if cli is not None:
            cli.close()
        server.stop()
        batcher.stop()


# -- framed round trips -------------------------------------------------------


def test_binary_roundtrip_inline(served):
    engine, _, _, connect = served
    cli = connect(shm=False)
    assert cli.server_digest == engine.digest
    assert cli.sample_shape == (16,)
    x = numpy.random.RandomState(1).rand(5, 16).astype(numpy.float32)
    ref = engine.infer(x)
    out = cli.infer(x)
    assert out.dtype == ref.dtype and (out == ref).all()
    one = cli.infer(x[0])
    assert one.shape == (1, 4) and (one[0] == ref[0]).all()
    assert cli.socket_tx_bytes == x.nbytes + x[0].nbytes
    assert cli.socket_rx_bytes == ref.nbytes + ref[0:1].nbytes
    assert cli.shm_tx_bytes == 0 and cli.shm_rx_bytes == 0
    assert cli.ping()


def test_binary_overflow_batch_chunks_through_ladder(served):
    engine, _, _, connect = served
    cli = connect(shm=False)
    x = numpy.random.RandomState(9).rand(70, 16).astype(numpy.float32)
    ref = engine.infer(x)
    out = cli.infer(x)
    assert out.shape == ref.shape and (out == ref).all()


def test_shm_bypass_and_stale_fallback(served):
    engine, _, _, connect = served
    sock_rx_before = registry.counter(
        "serve.transport.socket_rx_bytes").value
    shm_rx_before = registry.counter("serve.transport.shm_rx_bytes").value
    cli = connect(shm=True)
    assert cli.shm_active
    x = numpy.random.RandomState(2).rand(6, 16).astype(numpy.float32)
    ref = engine.infer(x)
    assert (cli.infer(x) == ref).all()
    assert cli.shm_tx_bytes == x.nbytes and cli.socket_tx_bytes == 0
    assert cli.shm_rx_bytes > 0 and cli.socket_rx_bytes == 0
    assert registry.counter(
        "serve.transport.shm_rx_bytes").value - shm_rx_before == x.nbytes
    assert registry.counter(
        "serve.transport.socket_rx_bytes").value == sock_rx_before
    cli._chan_out.close()
    assert (cli.infer(x) == ref).all()
    assert cli._chan_out is None
    assert cli.socket_tx_bytes == x.nbytes


def test_oversized_shm_segment_refused_downgrades_to_inline(served):
    engine, _, _, connect = served
    cli = connect(shm=True, shm_slot_mb=80.0)
    assert not cli.shm_active
    x = numpy.random.RandomState(7).rand(4, 16).astype(numpy.float32)
    assert (cli.infer(x) == engine.infer(x)).all()
    assert cli.socket_tx_bytes == x.nbytes and cli.shm_tx_bytes == 0


def test_hostile_length_prefix_drops_connection(served):
    _, _, server, connect = served
    healthy = connect(shm=False)
    ours, theirs = socket.socketpair()
    server.serve_socket(ours)
    try:
        theirs.settimeout(5.0)
        theirs.sendall(struct.pack("!IIB", 1 << 29, 1 << 29, 32))
        assert theirs.recv(64) == b""
    finally:
        theirs.close()
    assert healthy.infer(numpy.zeros(16, numpy.float32)).shape == (1, 4)


def test_pipelined_hello_is_refused(served):
    """A fleet link's hello is served in pipelined mode, and refused
    the shared-memory bypass even from the same host: the two-slot
    layout needs the in-order replies a pipelined link gives up."""
    from veles_tpu_torch.network_common import machine_id
    engine, _, server, _ = served
    ours, theirs = socket.socketpair()
    server.serve_socket(ours)
    chan = ShmChannel.create(1 << 16)
    try:
        theirs.settimeout(5.0)
        theirs.sendall(pack_frame({"op": "hello", "mid": machine_id(),
                                   "pipeline": True, "shm": chan.name}))
        reply, _ = read_frame_sync(_recv_exactly(theirs), None)
        assert reply["op"] == "hello" and reply["pipeline"] is True
        assert reply["shm_ok"] is False and reply["shm_reply_ok"] is False
        assert reply["digest"] == engine.digest and "host" not in reply
        meta, raw = encode_tensor(numpy.ones(16, numpy.float32))
        theirs.sendall(pack_frame(dict({"op": "infer", "id": 7}, **meta),
                                  raw))
        result, payload = read_frame_sync(_recv_exactly(theirs), None)
        assert result["op"] == "result" and result["id"] == 7
        got = decode_tensor(result, payload)
        numpy.testing.assert_array_equal(
            got, engine.infer(numpy.ones((1, 16), numpy.float32)))
    finally:
        theirs.close()
        chan.close()


def _recv_exactly(sock):
    def recv(n):
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return bytes(buf)
    return recv


def test_hmac_rejects_wrong_secret(engine):
    batcher = ContinuousBatcher(engine, max_delay_s=0.001).start()
    server = BinaryTransportServer(batcher, port=None, secret=b"sesame")
    server.start_background()
    try:
        ours, theirs = socket.socketpair()
        server.serve_socket(ours)
        cli = BinaryTransportClient(sock=theirs, secret=b"sesame",
                                    shm=False)
        try:
            assert cli.infer(numpy.zeros(16, numpy.float32)).shape == \
                (1, 4)
        finally:
            cli.close()
        ours2, theirs2 = socket.socketpair()
        server.serve_socket(ours2)
        try:
            with pytest.raises((ProtocolError, ConnectionError, OSError)):
                BinaryTransportClient(sock=theirs2, secret=b"wrong",
                                      shm=False, timeout=5.0)
        finally:
            theirs2.close()
    finally:
        server.stop()
        batcher.stop()


@pytest.mark.chaos
def test_transport_overload_is_transient(served):
    _, _, _, connect = served
    cli = connect(shm=False)
    chaos.install(chaos.FaultPlan(seed=1).add("serve.drop", "drop",
                                              nth=1))
    try:
        with pytest.raises(ServeOverload) as info:
            cli.infer(numpy.zeros(16, numpy.float32))
        assert info.value.retry_after > 0
        assert cli.infer(numpy.zeros(16, numpy.float32)).shape == (1, 4)
    finally:
        chaos.uninstall()


@pytest.mark.chaos
def test_host_chaos_points(served):
    """``serve.host.stall`` delays one frame; ``serve.host.preempt``
    (not ``kill``) severs the connection and the server serves on."""
    import time
    engine, _, _, connect = served
    cli = connect(shm=False)
    x = numpy.zeros(16, numpy.float32)
    chaos.install(chaos.FaultPlan(seed=1).add(
        "serve.host.stall", "stall", nth=1, param=0.3))
    try:
        start = time.perf_counter()
        assert (cli.infer(x) == engine.infer(x[None])).all()
        assert time.perf_counter() - start >= 0.3
    finally:
        chaos.uninstall()
    chaos.install(chaos.FaultPlan(seed=1).add(
        "serve.host.preempt", "sever", nth=1))
    try:
        with pytest.raises((ConnectionError, OSError, ProtocolError)):
            cli.infer(x)
    finally:
        chaos.uninstall()
    assert connect(shm=False).infer(x).shape == (1, 4)


# -- the block path the transport feeds ---------------------------------------


def test_submit_block_skips_staging(engine):
    batcher = ContinuousBatcher(engine, max_delay_s=0.0).start()
    try:
        rng = numpy.random.RandomState(4)
        x = numpy.ascontiguousarray(rng.rand(8, 16).astype(numpy.float32))
        ref = engine.infer(x)
        req = batcher.submit_block(x)
        assert req.done.wait(10) and req.error is None
        assert (req.result == ref).all()
        assert 8 not in batcher._stage
        req2 = batcher.submit_block(numpy.ascontiguousarray(x[:5]))
        assert req2.done.wait(10) and req2.error is None
        assert (req2.result == ref[:5]).all()
        assert 8 in batcher._stage
        with pytest.raises(ValueError):
            batcher.submit_block(rng.rand(33, 16).astype(numpy.float32))
        with pytest.raises(ValueError):
            batcher.submit_block(rng.rand(4, 7).astype(numpy.float32))
    finally:
        batcher.stop()


def test_blocks_cobatch_with_rows_bit_exact(engine):
    x = numpy.random.RandomState(5).rand(7, 16).astype(numpy.float32)
    ref = engine.infer(x)
    hist = registry.histogram("serve.batch_size")
    hist.reset()
    batcher = ContinuousBatcher(engine, max_delay_s=0.5).start()
    try:
        reqs = [batcher.submit_block(numpy.ascontiguousarray(x[:3])),
                batcher.submit(x[3]), batcher.submit(x[4]),
                batcher.submit_block(numpy.ascontiguousarray(x[5:7]))]
        for req in reqs:
            assert req.done.wait(10) and req.error is None, req.error
        assert (reqs[0].result == ref[:3]).all()
        assert (reqs[1].result == ref[3]).all()
        assert (reqs[2].result == ref[4]).all()
        assert (reqs[3].result == ref[5:7]).all()
        assert max(hist.window_values()) >= 7
    finally:
        batcher.stop()
