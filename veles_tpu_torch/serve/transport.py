"""Binary frame transport: the serving hot path without JSON.

Counterpart of ``veles_tpu/serve/transport.py``: a persistent-connection
listener speaking ``network_common``'s length-prefixed ``!IIB`` framing
(JSON control header + raw payload + optional HMAC-SHA256), with tensors
as a fixed dtype/shape/raw-bytes codec.  Frames are byte for byte the
JAX package's, so a client of either package talks to a server of the
other.

Trust boundary: the serve port never unpickles.  A tensor frame's header
carries ``{"dtype", "shape", "codec"}`` and the payload is the C-order
buffer; :func:`decode_tensor` admits only numeric and bool dtypes and
bounds the element count, so a hostile frame yields a ProtocolError or a
numpy array, never code execution.  With a secret (``VELES_TPU_SECRET``
or ``secret=``) the HMAC is checked before the header is parsed.

Wire format (one request-reply in flight per connection, in order):

===========  ==========================================================
frame        JSON header + payload
===========  ==========================================================
hello  ->    ``{"op": "hello", "mid", "shm"?, "shm_reply"?}``
hello  <-    ``{"op": "hello", "mid", "digest", "dtype",
             "sample_shape", "max_batch", "ladder", "pipeline",
             "shm_ok", "shm_reply_ok"}``
infer  ->    ``{"op": "infer", "id", "dtype", "shape", "codec",
             "shm"?: [off, len]}`` + raw tensor bytes (inline or shm)
result <-    ``{"op": "result", "id", "dtype", "shape", "codec",
             "shm"?: [off, len]}`` + raw tensor bytes
error  <-    ``{"op": "error", "id", "error", "transient"?,
             "retry_after"?}``
ping/bye     liveness / clean shutdown
===========  ==========================================================

Same-host clients hand payload bytes over :class:`ShmChannel` segments,
one per direction, both created by the client; the server only attaches
(size-bounded) and acks each road in the hello reply.  A segment that
goes stale mid-connection falls back to inline payloads instead of
failing the request; ``serve.transport.{socket,shm}_{rx,tx}_bytes``
count which road the bytes took.  A batch wider than the ladder is
chunked through it; overload answers a transient error frame with the
``retry_after``.  Chaos points ``serve.host.stall`` (the frame parks
``param`` seconds) and ``serve.host.preempt`` (``kill``: SIGKILL self;
any other action severs the connection) fire per served frame.

The fleet link (``"pipeline": true`` hellos: out-of-order replies,
``cancel`` frames, ``telemetry`` polls, ``host_meta``) waits for
ROADMAP.md Queue 1 item 15; request trace ids and segment echoes for
item 11.
"""

import asyncio
import os
import signal
import socket as _socketmod
import threading
import time

import numpy

from veles_tpu_torch import chaos
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.network_common import (
    ProtocolError, ShmChannel, default_secret, get_codec, machine_id,
    pack_frame, read_frame, read_frame_sync, write_frame)
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.serve import qos
from veles_tpu_torch.serve.batcher import ServeOverload

__all__ = ["encode_tensor", "decode_tensor", "BinaryTransportServer",
           "BinaryTransportClient", "MAX_FRAME_BYTES"]

#: dtype kinds the wire admits: floats, (un)signed ints, bool.  Never
#: object/void/str — the codec must not be able to smuggle pickles.
_SAFE_KINDS = frozenset("fiub")
#: element-count ceiling per tensor (mirrors network_common._MAX_LEN's
#: role: a hostile shape must not allocate unbounded memory)
_MAX_ELEMS = 1 << 28
#: per-frame byte ceiling on the serve port — far above any ladder
#: batch, far below the control plane's 1 GiB: a hostile length prefix
#: fails at the prefix (connection dropped) instead of parking the
#: reader buffering bytes that never arrive
MAX_FRAME_BYTES = 64 << 20


def encode_tensor(arr, codec="none"):
    """Tensor -> (header fields, payload bytes).  The header rides the
    frame's JSON header; the bytes are the raw C-order buffer (through
    the shared compression table for codecs other than ``none``)."""
    arr = numpy.ascontiguousarray(arr)
    if arr.dtype.kind not in _SAFE_KINDS:
        raise ValueError("refusing non-numeric dtype %s on the wire"
                         % arr.dtype)
    meta = {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "codec": codec}
    raw = arr.tobytes()
    if codec != "none":
        raw = get_codec(codec)[0](raw)
    return meta, raw


def decode_tensor(meta, raw):
    """(header fields, payload bytes) -> numpy array.

    Zero-copy for the ``none`` codec: the array is a read-only
    ``frombuffer`` view over the received bytes, which the batcher
    copies into the engine's input (or its staging buffer) once.
    Every field is validated:
    unknown/object dtypes, negative or oversized shapes, and length
    mismatches raise :class:`ProtocolError` — never an allocation of
    attacker-chosen size, never an unpickle."""
    try:
        dtype = numpy.dtype(str(meta["dtype"]))
        shape = tuple(int(s) for s in meta["shape"])
        codec = str(meta.get("codec", "none"))
    except (KeyError, TypeError, ValueError) as exc:
        raise ProtocolError("malformed tensor header (%s)" % exc)
    if dtype.kind not in _SAFE_KINDS or dtype.hasobject:
        raise ProtocolError("refused dtype %r on the wire"
                            % meta.get("dtype"))
    count = 1
    for dim in shape:
        if dim < 0:
            raise ProtocolError("negative tensor dimension")
        count *= dim
    if count > _MAX_ELEMS:
        raise ProtocolError("tensor too large (%d elements)" % count)
    if codec != "none":
        try:
            raw = get_codec(codec)[1](raw)
        except ValueError:
            raise ProtocolError("unknown tensor codec %r" % codec)
        except Exception as exc:
            raise ProtocolError("tensor payload decompression failed "
                                "(%s)" % exc)
    if count * dtype.itemsize != len(raw):
        raise ProtocolError(
            "tensor length mismatch (%d x %s != %d bytes)" %
            (count, dtype, len(raw)))
    return numpy.frombuffer(raw, dtype).reshape(shape)




class BinaryTransportServer(Logger):
    """Persistent-connection binary listener over a batcher or pool.

    ``pool`` is anything speaking the :class:`ContinuousBatcher` submit
    contract: a single batcher or a ``ReplicaPool``, whose least-loaded
    routing then applies per frame.  Connections are served
    concurrently; the frames of one connection in order (what keeps the
    two-slot shm layout safe).

    ``port=None`` starts the loop without a TCP listener: tests adopt
    in-process ``socket.socketpair()`` sockets through
    :meth:`serve_socket` and bind no port."""

    def __init__(self, pool, port=0, address="127.0.0.1", secret=None,
                 executor_workers=32, timeout=30.0, quota=None,
                 retry_jitter=None, **kwargs):
        super(BinaryTransportServer, self).__init__(**kwargs)
        self.pool = pool
        self.address = address
        self.port = port
        self.timeout = float(timeout)
        #: per-tenant admission quota (qos.TenantQuota), checked per
        #: infer frame before the request reaches a queue; None: none
        self.quota = quota
        self.retry_jitter = retry_jitter if retry_jitter is not None \
            else qos.RetryJitter()
        self._secret = default_secret() if secret is None \
            else (secret or None)
        self._executor_workers = int(executor_workers)
        self._executor = None
        self._loop = None
        self._thread = None
        self._server = None
        self._writers = set()
        self._channels = set()
        self._chan_lock = threading.Lock()
        self._m_conns = _registry.counter("serve.transport.connections")
        self._m_requests = _registry.counter("serve.transport.requests")
        self._m_errors = _registry.counter("serve.transport.errors")
        self._m_sock_rx = _registry.counter(
            "serve.transport.socket_rx_bytes")
        self._m_sock_tx = _registry.counter(
            "serve.transport.socket_tx_bytes")
        self._m_shm_rx = _registry.counter(
            "serve.transport.shm_rx_bytes")
        self._m_shm_tx = _registry.counter(
            "serve.transport.shm_tx_bytes")
        self._m_latency = _registry.histogram("transport.request_s")

    # -- lifecycle ----------------------------------------------------------

    def start_background(self):
        from concurrent.futures import ThreadPoolExecutor
        self._executor = ThreadPoolExecutor(
            max_workers=self._executor_workers,
            thread_name_prefix="serve-transport")
        started = threading.Event()
        failure = []

        def serve():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop

            async def boot():
                if self.port is not None:
                    self._server = await asyncio.start_server(
                        self._handle, host=self.address,
                        port=self.port)
                    self.port = \
                        self._server.sockets[0].getsockname()[1]

            try:
                loop.run_until_complete(boot())
            except Exception as exc:
                failure.append(exc)
                started.set()
                return
            started.set()
            try:
                loop.run_forever()
            finally:
                for task in asyncio.all_tasks(loop):
                    task.cancel()
                try:
                    loop.run_until_complete(loop.shutdown_asyncgens())
                except Exception:
                    pass
                loop.close()

        self._thread = threading.Thread(target=serve,
                                        name="serve-transport")
        self._thread.start()
        started.wait()
        if failure:
            self._thread.join(timeout=5)
            self._executor.shutdown(wait=False)
            raise failure[0]
        if self.port is not None:
            self.info("binary transport on %s:%d%s", self.address,
                      self.port, " (HMAC on)" if self._secret else "")
        return self._thread

    def serve_socket(self, sock):
        """Adopt an established socket (one end of a
        ``socket.socketpair()``) as a client connection."""
        if self._loop is None:
            raise RuntimeError("start_background() first")

        async def adopt():
            reader, writer = await asyncio.open_connection(sock=sock)
            asyncio.ensure_future(self._handle(reader, writer))

        asyncio.run_coroutine_threadsafe(adopt(), self._loop).result(5)

    def stop(self):
        loop, self._loop = self._loop, None
        if loop is not None:
            async def shutdown():
                if self._server is not None:
                    self._server.close()
                    await self._server.wait_closed()
                    self._server = None
                for writer in list(self._writers):
                    try:
                        writer.close()
                    except Exception:
                        pass
            try:
                asyncio.run_coroutine_threadsafe(
                    shutdown(), loop).result(5)
            except Exception:
                pass
            loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        # a handler parked on a read when the loop died never reached
        # its finally: close the segments still registered
        with self._chan_lock:
            leftovers, self._channels = set(self._channels), set()
        for chan in leftovers:
            chan.close()

    # -- connection handling ------------------------------------------------

    def _attach_bounded(self, name):
        """Attach a client-created segment, refusing one sized past the
        frame ceiling."""
        try:
            chan = ShmChannel.attach(str(name))
        except Exception:
            return None
        if chan.slot_size > MAX_FRAME_BYTES:
            chan.close()
            return None
        with self._chan_lock:
            self._channels.add(chan)
        return chan

    def _untrack_close(self, chan):
        if chan is not None:
            with self._chan_lock:
                self._channels.discard(chan)
            chan.close()

    async def _handle(self, reader, writer):
        self._m_conns.inc()
        self._writers.add(writer)
        chan_in = chan_out = None
        try:
            hello, _ = await read_frame(reader, secret=self._secret,
                                        max_len=MAX_FRAME_BYTES)
            if hello.get("op") != "hello":
                raise ProtocolError("expected hello, got %r"
                                    % hello.get("op"))
            if hello.get("pipeline"):
                raise ProtocolError(
                    "pipelined fleet links are not ported yet "
                    "(ROADMAP.md Queue 1 item 15)")
            engine = self.pool.engine
            same_host = hello.get("mid") == machine_id()
            # the connection's default QoS identity; a frame may
            # override it
            conn_tenant = hello.get("tenant")
            conn_class = hello.get("slo_class")
            reply = {
                "op": "hello", "mid": machine_id(),
                "digest": engine.digest,
                "dtype": engine.dtype.str,
                "sample_shape": list(engine.sample_shape),
                "max_batch": engine.max_batch,
                "ladder": list(engine.ladder),
                "pipeline": False,
                "shm_ok": False,
                "shm_reply_ok": False,
            }
            # the client creates both segments; the server only
            # attaches, and acks each road it could map
            if same_host and hello.get("shm"):
                chan_in = self._attach_bounded(hello["shm"])
                reply["shm_ok"] = chan_in is not None
            if same_host and hello.get("shm_reply"):
                chan_out = self._attach_bounded(hello["shm_reply"])
                reply["shm_reply_ok"] = chan_out is not None
            write_frame(writer, reply, secret=self._secret)
            await writer.drain()
            while True:
                try:
                    msg, payload = await read_frame(
                        reader, secret=self._secret,
                        max_len=MAX_FRAME_BYTES)
                except (asyncio.IncompleteReadError, ConnectionError,
                        OSError):
                    break
                op = msg.get("op")
                if op == "bye":
                    break
                if op == "ping":
                    write_frame(writer,
                                {"op": "pong", "id": msg.get("id")},
                                secret=self._secret)
                    await writer.drain()
                    continue
                if op != "infer":
                    raise ProtocolError("unknown op %r" % op)
                # in order: the reply goes out before the next frame is
                # read (the two-slot shm layout relies on it)
                await self._serve_one(msg, payload, chan_in, chan_out,
                                      writer, tenant=conn_tenant,
                                      slo_class=conn_class)
        except ProtocolError as exc:
            self._m_errors.inc()
            self.debug("transport protocol error: %s", exc)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # the peer went away
        finally:
            self._untrack_close(chan_in)
            self._untrack_close(chan_out)
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _fire_host_chaos():
        """``serve.host.stall`` parks this frame ``param`` seconds (the
        caller awaits the returned stall); ``serve.host.preempt`` kills
        the process (``kill``) or severs the connection."""
        if chaos.plan is None:
            return 0.0
        stall = 0.0
        fault = chaos.plan.fire("serve.host.stall")
        if fault is not None:
            stall = fault.param if fault.param else 0.05
        fault = chaos.plan.fire("serve.host.preempt")
        if fault is not None:
            if fault.action == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise ConnectionError("chaos: serve.host.preempt")
        return stall

    async def _serve_one(self, msg, payload, chan_in, chan_out, writer,
                         tenant=None, slo_class=None):
        start = time.perf_counter()
        rid = msg.get("id")
        self._m_requests.inc()
        tenant = msg.get("tenant", tenant)
        slo_class = qos.normalize_class(msg.get("slo_class", slo_class))

        async def reply_frame(frame, raw=b""):
            write_frame(writer, frame, payload=raw, secret=self._secret)
            await writer.drain()

        try:
            if self.quota is not None:
                wait = self.quota.admit(tenant)
                if wait is not None:
                    # over quota: rejected before any queue sees it
                    qos.note_shed(slo_class)
                    raise ServeOverload(
                        "tenant %r over quota" % (tenant,),
                        retry_after=self.retry_jitter.apply(
                            max(wait, 0.05), slo_class))
            stall = self._fire_host_chaos()
            if stall:
                await asyncio.sleep(stall)
            if "shm" in msg:
                if chan_in is None:
                    raise ProtocolError(
                        "shm descriptor without an attached channel")
                offset, length = (int(v) for v in msg["shm"])
                raw = chan_in.read(offset, length)
                self._m_shm_rx.inc(len(raw))
            else:
                raw = payload
                self._m_sock_rx.inc(len(raw))
            arr = decode_tensor(msg, raw)
            loop = asyncio.get_event_loop()
            result = await loop.run_in_executor(
                self._executor, self._infer, arr, slo_class)
            meta, raw_out = encode_tensor(
                result, codec=str(msg.get("codec", "none")))
            reply = {"op": "result", "id": rid}
            reply.update(meta)
            if chan_out is not None:
                try:
                    slot = chan_out.write(raw_out)
                except Exception:
                    slot = None  # a stale segment: inline fallback
                if slot is not None:
                    reply["shm"] = list(slot)
                    self._m_shm_tx.inc(len(raw_out))
                    raw_out = b""
            if raw_out:
                self._m_sock_tx.inc(len(raw_out))
            await reply_frame(reply, raw_out)
        except ServeOverload as exc:
            self._m_errors.inc()
            await reply_frame({
                "op": "error", "id": rid, "error": str(exc),
                "transient": True,
                "retry_after": round(exc.retry_after, 4),
            })
        except (ProtocolError, ValueError, TypeError) as exc:
            self._m_errors.inc()
            await reply_frame(
                {"op": "error", "id": rid, "error": str(exc)})
        except (ConnectionError, OSError):
            raise
        except Exception as exc:
            self._m_errors.inc()
            self.exception("transport request failed")
            await reply_frame(
                {"op": "error", "id": rid, "error": str(exc)})
        finally:
            # the transport.request tracer span: ROADMAP.md item 11
            self._m_latency.observe(time.perf_counter() - start)

    def _infer(self, arr, slo_class=None):
        """Blocking dispatch (executor thread): a sample rides
        ``submit``, a contiguous batch ``submit_block``, chunked at the
        top of the ladder.  Returns the 2-D result."""
        engine = self.pool.engine
        shape = engine.sample_shape
        if arr.shape == shape:
            requests = [self.pool.submit(arr, slo_class=slo_class)]
            single = True
        elif arr.shape[1:] == shape and arr.ndim == len(shape) + 1 \
                and arr.shape[0] >= 1:
            single = False
            requests = []
            try:
                for i in range(0, arr.shape[0], engine.max_batch):
                    requests.append(self.pool.submit_block(
                        arr[i:i + engine.max_batch],
                        slo_class=slo_class))
            except Exception:
                for req in requests:
                    req.cancelled = True
                raise
        else:
            raise ValueError("expected sample shape %s or a batch of "
                             "them, got %s" % (shape, arr.shape))
        rows = []
        try:
            for req in requests:
                if not req.done.wait(self.timeout):
                    raise TimeoutError(
                        "inference timed out after %.1fs"
                        % self.timeout)
                if req.error is not None:
                    raise req.error
                rows.append(req.result)
        except Exception:
            # a failed chunk must not leave its siblings computing for
            # nobody
            for req in requests:
                if not req.done.is_set():
                    req.cancelled = True
            raise
        if single:
            return rows[0][None]
        return rows[0] if len(rows) == 1 else numpy.concatenate(rows)


class BinaryTransportClient(object):
    """Blocking persistent-connection client (load generators,
    same-host services, tests).

    One request in flight at a time (``infer`` holds a lock), the
    discipline the shm slots rely on.  ``sock=`` adopts an established
    socket (tests pair it with ``serve_socket``); ``shm=`` offers the
    same-host shared-memory bypass, degrading to inline payloads when a
    segment cannot be created or attached, or goes stale."""

    def __init__(self, host="127.0.0.1", port=None, sock=None,
                 secret=None, shm=True, shm_slot_mb=4.0, codec="none",
                 timeout=30.0, tenant=None, slo_class=None):
        #: QoS identity stamped into the hello as this connection's
        #: default; ``infer(..., slo_class=)`` overrides it per request
        self.tenant = tenant
        self.slo_class = slo_class
        if sock is None:
            sock = _socketmod.create_connection((host, port), timeout)
        else:
            sock.settimeout(timeout)
        self._sock = sock
        self._secret = default_secret() if secret is None \
            else (secret or None)
        self.codec = codec
        self._lock = threading.Lock()
        self._next_id = 0
        self._chan_out = None   # client -> server payloads
        self._chan_in = None    # server -> client payloads
        # payload bytes by road (the shm-bypass receipts)
        self.socket_tx_bytes = 0
        self.socket_rx_bytes = 0
        self.shm_tx_bytes = 0
        self.shm_rx_bytes = 0
        hello = {"op": "hello", "mid": machine_id()}
        if tenant is not None:
            hello["tenant"] = tenant
        if slo_class is not None:
            hello["slo_class"] = slo_class
        if shm:
            try:
                self._chan_out = ShmChannel.create(
                    2 * int(shm_slot_mb * (1 << 20)))
                self._chan_in = ShmChannel.create(
                    2 * int(shm_slot_mb * (1 << 20)))
                hello["shm"] = self._chan_out.name
                hello["shm_reply"] = self._chan_in.name
            except Exception:
                self._drop_channels()
        try:
            self._send(hello)
            reply, _ = self._read()
            if reply.get("op") != "hello":
                raise ProtocolError("expected hello reply, got %r"
                                    % reply.get("op"))
        except Exception:
            # a failed handshake must not leak the segments
            self._drop_channels()
            raise
        self.server_digest = reply.get("digest")
        self.server_dtype = numpy.dtype(str(reply.get("dtype", "<f4")))
        self.sample_shape = tuple(reply.get("sample_shape", ()))
        self.max_batch = int(reply.get("max_batch", 1))
        # keep only the roads the server attached
        if self._chan_out is not None and not reply.get("shm_ok"):
            self._drop_chan_out()
        if self._chan_in is not None and not reply.get("shm_reply_ok"):
            chan, self._chan_in = self._chan_in, None
            chan.close()

    # -- framing ------------------------------------------------------------

    def _recv_exactly(self, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return bytes(buf)

    def _send(self, msg, payload=b""):
        self._sock.sendall(pack_frame(msg, payload, self._secret))

    def _read(self):
        return read_frame_sync(self._recv_exactly, self._secret,
                               max_len=MAX_FRAME_BYTES)

    # -- API ----------------------------------------------------------------

    @property
    def shm_active(self):
        return self._chan_out is not None

    def infer(self, x, slo_class=None, tenant=None):
        """One tensor round trip: a sample or a contiguous batch in, the
        probability block out (numpy).  An overload answer raises
        :class:`ServeOverload` with the server's ``retry_after``."""
        with self._lock:
            meta, raw = encode_tensor(x, self.codec)
            rid = self._next_id
            self._next_id += 1
            msg = {"op": "infer", "id": rid}
            if slo_class is not None:
                msg["slo_class"] = slo_class
            if tenant is not None:
                msg["tenant"] = tenant
            msg.update(meta)
            payload = raw
            if self._chan_out is not None:
                slot = None
                try:
                    slot = self._chan_out.write(raw)
                except Exception:
                    # a stale or closed segment: drop it and send inline
                    self._drop_chan_out()
                if slot is not None:
                    msg["shm"] = list(slot)
                    payload = b""
                    self.shm_tx_bytes += len(raw)
            if payload:
                self.socket_tx_bytes += len(payload)
            self._send(msg, payload)
            reply, rpayload = self._read()
            if reply.get("op") == "error":
                if reply.get("transient"):
                    raise ServeOverload(
                        reply.get("error", "overloaded"),
                        retry_after=float(reply.get("retry_after", 0.1)))
                raise RuntimeError(reply.get("error", "serve error"))
            if reply.get("op") != "result" or reply.get("id") != rid:
                raise ProtocolError("unexpected reply %r" % reply)
            if "shm" in reply and self._chan_in is not None:
                offset, length = (int(v) for v in reply["shm"])
                rraw = self._chan_in.read(offset, length)
                self.shm_rx_bytes += len(rraw)
            else:
                rraw = rpayload
                self.socket_rx_bytes += len(rraw)
            return decode_tensor(reply, rraw)

    def ping(self):
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._send({"op": "ping", "id": rid})
            reply, _ = self._read()
            return reply.get("op") == "pong"

    def _drop_chan_out(self):
        chan, self._chan_out = self._chan_out, None
        if chan is not None:
            chan.close()

    def _drop_channels(self):
        self._drop_chan_out()
        chan, self._chan_in = self._chan_in, None
        if chan is not None:
            chan.close()

    def close(self):
        try:
            self._send({"op": "bye"})
        except Exception:
            pass
        try:
            self._sock.close()
        except Exception:
            pass
        self._drop_channels()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
