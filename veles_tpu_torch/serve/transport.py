"""Binary frame transport: the serving hot path without JSON.

Counterpart of ``veles_tpu/serve/transport.py``: a persistent-connection
listener speaking ``network_common``'s length-prefixed ``!IIB`` framing
(JSON control header + raw payload + optional HMAC-SHA256), with tensors
as a fixed dtype/shape/raw-bytes codec.  Frames are byte for byte the
JAX package's, so a client (or a fleet front) of either package talks to
a server of the other.

Trust boundary: the serve port never unpickles.  A tensor frame's header
carries ``{"dtype", "shape", "codec"}`` and the payload is the C-order
buffer; :func:`decode_tensor` admits only numeric and bool dtypes and
bounds the element count, so a hostile frame yields a ProtocolError or a
numpy array, never code execution.  With a secret (``VELES_TPU_SECRET``
or ``secret=``) the HMAC is checked before the header is parsed.

Wire format (one request-reply per in-flight frame; in order per
connection unless the hello asked for a pipelined link):

===========  ==========================================================
frame        JSON header + payload
===========  ==========================================================
hello  ->    ``{"op": "hello", "mid", "shm"?, "shm_reply"?,
             "trace"?: true, "pipeline"?: true}``
hello  <-    ``{"op": "hello", "mid", "digest", "dtype",
             "sample_shape", "max_batch", "ladder", "pipeline",
             "shm_ok", "shm_reply_ok", "host"?}``
infer  ->    ``{"op": "infer", "id", "dtype", "shape", "codec",
             "shm"?: [off, len], "trace"?: str, "shadow"?}`` + raw
             tensor bytes (inline or shm)
result <-    ``{"op": "result", "id", "dtype", "shape", "codec",
             "shm"?: [off, len], "trace"?, "segs"?}`` + raw tensor
             bytes
error  <-    ``{"op": "error", "id", "error", "transient"?,
             "retry_after"?}``
cancel ->    ``{"op": "cancel", "id"}`` (pipelined links)
telemetry    ``{"op": "telemetry", "id", "t0"}`` -> ``{"op":
             "telemetry", "id", "t0", "t1", "t2", "host"?, "series"}``
ping/bye     liveness / clean shutdown
===========  ==========================================================

Same-host clients hand payload bytes over :class:`ShmChannel` segments,
one per direction, both created by the client; the server only attaches
(size-bounded) and acks each road in the hello reply.  A segment that
goes stale mid-connection falls back to inline payloads instead of
failing the request; ``serve.transport.{socket,shm}_{rx,tx}_bytes``
count which road the bytes took.  A batch wider than the ladder is
chunked through it; overload answers a transient error frame with the
``retry_after``.

Fleet links: a hello carrying ``"pipeline": true`` switches the
connection into the router-host mode :mod:`veles_tpu_torch.serve.fleet`
speaks: many ``infer`` frames in flight, each dispatched concurrently
and answered by ``id`` (out of order), and a best-effort ``cancel``
frame that retires a hedged loser's batcher requests.  A pipelined link
never negotiates shm (the two-slot layout needs the in-order discipline)
and a cancelled request is answered with nothing: exactly-once is the
router's accounting, the cancel only bounds wasted work.  A cancel that
lands while its batch replays a captured graph cannot stop the replay;
the row's result is dropped.  ``telemetry`` polls are answered in line
in both modes, with NTP echo timestamps and the series buckets since
the last poll.  A server built with ``host_meta`` (a fleet HOST) adds a
``"host"`` block to its hello: the host id plus the pool's compile
receipt (``new_compiles``, ``kernel_builds``, ``captures``), which is
how a rejoining host shows what its restart paid before it re-enters
rotation.  Request trace ids ride the frames, and a traced reply echoes
the id and the per-segment seconds.

Chaos points ``serve.host.stall`` (the frame parks ``param`` seconds:
the straggler the hedging A/B measures) and ``serve.host.preempt``
(``kill``: SIGKILL self; any other action severs the connection) fire
per served frame, also host-scoped (``point:host_id``) once
``host_meta`` names the host.
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
from veles_tpu_torch.observe import requests as reqtrace
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer
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


class _CancelledByPeer(Exception):
    """The peer cancelled this in-flight request (hedged loser): the
    serving side drops it silently — no reply frame, the router
    already retired the copy."""


class _InflightScope(object):
    """Cancellation bridge for ONE pipelined in-flight request: the
    event-loop-side cancel handler and the executor-side dispatch race
    through here.  ``add`` registers a batcher request under the scope
    (raising immediately when the cancel already landed); ``cancel``
    marks every registered request cancelled — the batcher worker
    drops undispatched ones at collect time — and releases the waiting
    executor thread with :class:`_CancelledByPeer` so it never waits
    out its timeout computing for nobody."""

    __slots__ = ("_lock", "_reqs", "cancelled")

    def __init__(self):
        self._lock = threading.Lock()
        self._reqs = []
        self.cancelled = False

    def add(self, req):
        with self._lock:
            if self.cancelled:
                req.cancelled = True
                raise _CancelledByPeer("cancelled by peer")
            self._reqs.append(req)
        return req

    def cancel(self):
        with self._lock:
            self.cancelled = True
            reqs, self._reqs = list(self._reqs), []
        for req in reqs:
            req.cancelled = True
            if not req.done.is_set():
                # racing the worker's result fill is benign: done is
                # set either way and the reply is suppressed on the
                # scope flag, not on which write landed last
                req.error = _CancelledByPeer("cancelled by peer")
                req.done.set()


class BinaryTransportServer(Logger):
    """Persistent-connection binary listener over a batcher or pool.

    ``pool`` is anything speaking the :class:`ContinuousBatcher`
    submit contract — a single batcher or a :class:`ReplicaPool`
    (whose least-loaded routing then applies per frame).  Connections
    are handled concurrently; frames within one connection are served
    in order (the discipline that keeps the two-slot shm layout safe).

    ``port=None`` starts the loop WITHOUT a TCP listener — tests adopt
    in-process ``socket.socketpair()`` duplex sockets through
    :meth:`serve_socket` and never bind a real port."""

    def __init__(self, pool, port=0, address="127.0.0.1", secret=None,
                 executor_workers=32, timeout=30.0, host_meta=None,
                 quota=None, retry_jitter=None, **kwargs):
        super(BinaryTransportServer, self).__init__(**kwargs)
        self.pool = pool
        self.address = address
        self.port = port
        self.timeout = float(timeout)
        #: per-tenant admission quota (qos.TenantQuota) — checked per
        #: infer frame BEFORE the request reaches any queue; None =
        #: quota disabled (legacy behavior, nothing rejected here)
        self.quota = quota
        self.retry_jitter = retry_jitter if retry_jitter is not None \
            else qos.RetryJitter()
        #: fleet-host identity ({"host_id": ...}) acked back in every
        #: hello reply's "host" block together with the pool's compile
        #: receipt summary; None = not a fleet host, no block
        self.host_meta = dict(host_meta) if host_meta else None
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
        # transport-owned request segments (observe/requests.py
        # taxonomy): frame decode, admission, reply encode+write
        self._h_wire_rx = _registry.histogram("serve.segment.wire_rx_s")
        self._h_wire_tx = _registry.histogram("serve.segment.wire_tx_s")
        self._h_admit = _registry.histogram("serve.segment.admit_s")
        if self.host_meta and hasattr(pool, "set_host_tag"):
            # leg attribution: request spans emitted by this host's
            # batchers carry the fleet host id, so merged cross-host
            # timelines can name the slow leg
            pool.set_host_tag(self.host_meta.get("host_id"))

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
                    loop.run_until_complete(
                        loop.shutdown_asyncgens())
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
                      self.port,
                      " (HMAC on)" if self._secret else "")
        return self._thread

    def serve_socket(self, sock):
        """Adopt an already-established socket (e.g. one end of a
        ``socket.socketpair()``) as a client connection — the
        in-process duplex path the transport tests use so tier-1 never
        binds a real port."""
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
        # its finally: close whatever segments are still registered
        with self._chan_lock:
            leftovers, self._channels = set(self._channels), set()
        for chan in leftovers:
            chan.close()

    # -- connection handling ------------------------------------------------

    def _track(self, chan):
        if chan is not None:
            with self._chan_lock:
                self._channels.add(chan)
        return chan

    def _attach_bounded(self, name):
        """Attach a client-created segment — refusing one sized past
        the frame ceiling (the segment is client-owned; the bound is
        about what this server is willing to map and write)."""
        try:
            chan = ShmChannel.attach(str(name))
        except Exception:
            return None
        if chan.slot_size > MAX_FRAME_BYTES:
            chan.close()
            return None
        return self._track(chan)

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
            engine = self.pool.engine
            same_host = hello.get("mid") == machine_id()
            pipelined = bool(hello.get("pipeline"))
            # connection-default QoS identity: a client that labels
            # its hello stamps every frame on this link; individual
            # infer frames may still override per request, and
            # un-labelled legacy clients fall through to class "batch"
            conn_tenant = hello.get("tenant")
            conn_class = hello.get("slo_class")
            # connection-default request tracing: a truthy hello
            # "trace" asks the server to mint an id for every frame
            # that does not carry its own (fleet links send explicit
            # per-frame ids instead)
            conn_trace = bool(hello.get("trace"))
            reply = {
                "op": "hello", "mid": machine_id(),
                "digest": engine.digest,
                "dtype": engine.dtype.str,
                "sample_shape": list(engine.sample_shape),
                "max_batch": engine.max_batch,
                "ladder": list(engine.ladder),
                "pipeline": pipelined,
                "shm_ok": False,
                "shm_reply_ok": False,
            }
            if self.host_meta is not None:
                # fleet-host identity + the re-warm receipt: what the
                # host's start paid (a captured graph does not outlive
                # its process, so new_compiles counts the captures;
                # kernel_builds is 0 once the library is on disk),
                # read by the router before the host enters rotation
                host = dict(self.host_meta)
                receipt = getattr(self.pool, "compile_receipt", None) \
                    or getattr(engine, "compile_receipt", None)
                if receipt:
                    host["new_compiles"] = receipt.get("new_compiles")
                    host["cache_hits"] = receipt.get("cache_hits")
                    host["kernel_builds"] = receipt.get("kernel_builds")
                    host["captures"] = receipt.get("captures")
                reply["host"] = host
            # the CLIENT creates both segments and owns their size and
            # lifetime; the server only ever ATTACHES (bounded below) —
            # so a hostile hello cannot make the server allocate, and
            # an attach failure is known HERE and acked back, never
            # discovered mid-request (each side uses only channels it
            # verifiably has).  Pipelined (fleet) links never get shm:
            # the two-slot layout needs the in-order reply discipline
            # this mode deliberately gives up.
            if same_host and hello.get("shm") and not pipelined:
                chan_in = self._attach_bounded(hello["shm"])
                reply["shm_ok"] = chan_in is not None
            if same_host and hello.get("shm_reply") and not pipelined:
                chan_out = self._attach_bounded(hello["shm_reply"])
                reply["shm_reply_ok"] = chan_out is not None
            write_frame(writer, reply, secret=self._secret)
            await writer.drain()
            if pipelined:
                await self._handle_pipelined(reader, writer,
                                             tenant=conn_tenant,
                                             slo_class=conn_class,
                                             trace_default=conn_trace)
                return
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
                if op == "telemetry":
                    write_frame(writer, self._telemetry_reply(msg),
                                secret=self._secret)
                    await writer.drain()
                    continue
                if op != "infer":
                    raise ProtocolError("unknown op %r" % op)
                # in-order per connection: the reply goes out before
                # the next frame is read, which is what makes the
                # two-slot shm layout race-free
                await self._serve_one(msg, payload, chan_in, chan_out,
                                      writer, tenant=conn_tenant,
                                      slo_class=conn_class,
                                      trace_default=conn_trace)
        except ProtocolError as exc:
            self._m_errors.inc()
            self.debug("transport protocol error: %s", exc)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # peer went away: clean close
        finally:
            self._untrack_close(chan_in)
            self._untrack_close(chan_out)
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_pipelined(self, reader, writer, tenant=None,
                                slo_class=None, trace_default=False):
        """The fleet-link loop: every ``infer`` frame becomes its own
        task (replies out of order, matched by id), ``cancel`` frames
        retire in-flight scopes, and frame WRITES are serialized by
        one lock so concurrent replies never interleave bytes.  On
        disconnect every in-flight scope is cancelled: a dead link's
        requests must not keep executor threads waiting out their
        timeouts for a peer that is gone."""
        write_lock = asyncio.Lock()
        inflight = {}
        tasks = set()

        async def one(msg, payload, scope):
            try:
                await self._serve_one(msg, payload, None, None, writer,
                                      write_lock=write_lock,
                                      scope=scope, tenant=tenant,
                                      slo_class=slo_class,
                                      trace_default=trace_default)
            except (ConnectionError, OSError):
                # chaos sever / peer gone: drop the whole connection
                try:
                    writer.close()
                except Exception:
                    pass
            finally:
                inflight.pop(msg.get("id"), None)

        try:
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
                    async with write_lock:
                        write_frame(writer,
                                    {"op": "pong", "id": msg.get("id")},
                                    secret=self._secret)
                        await writer.drain()
                    continue
                if op == "cancel":
                    scope = inflight.get(msg.get("id"))
                    if scope is not None:
                        scope.cancel()
                    continue
                if op == "telemetry":
                    async with write_lock:
                        write_frame(writer, self._telemetry_reply(msg),
                                    secret=self._secret)
                        await writer.drain()
                    continue
                if op != "infer":
                    raise ProtocolError("unknown op %r" % op)
                scope = inflight[msg.get("id")] = _InflightScope()
                task = asyncio.ensure_future(one(msg, payload, scope))
                tasks.add(task)
                task.add_done_callback(tasks.discard)
        finally:
            for scope in list(inflight.values()):
                scope.cancel()
            for task in list(tasks):
                task.cancel()

    def _telemetry_reply(self, msg):
        """One telemetry poll answered in-line: NTP echo timestamps
        (the poller's t0 comes back with our t1/t2, so the router's
        t3 closes a clock-probe sample — telemetry polls double as
        the fleet's clock sync) plus the series buckets NEW since the
        last poll, straight in the JSON frame.  Ticks the process
        ring first so a serve host needs no Heartbeat to bucketize.
        A telemetry failure costs the buckets, never the link."""
        now = time.time()
        reply = {"op": "telemetry", "id": msg.get("id"),
                 "t0": msg.get("t0"), "t1": now, "t2": now}
        host_id = self.host_meta.get("host_id") \
            if self.host_meta else None
        if host_id is not None:
            reply["host"] = host_id
        try:
            from veles_tpu_torch.observe.timeseries import series
            series.maybe_tick()
            reply["series"] = series.take_chunk(label=host_id)
        except Exception:
            reply["series"] = None
        return reply

    def _fire_host_chaos(self):
        """The fleet-host fault surface, fired
        per served frame: ``serve.host.stall`` parks this request
        ``param`` seconds (the induced straggler request hedging must
        beat), ``serve.host.preempt`` kills the host mid-stream
        (``kill`` = SIGKILL self for subprocess soaks; anything else
        severs the connection — the in-process stand-in).  Both points
        also fire HOST-SCOPED (``point:host_id``, the network_common
        peer-scope convention) so an in-process multi-host harness can
        arm ONE straggler while its siblings stay healthy.  Returns
        the stall seconds (awaited by the caller so a pipelined stall
        parks only its own task, never the link)."""
        stall = 0.0
        if chaos.plan is None:
            return stall
        host_id = self.host_meta.get("host_id") \
            if self.host_meta else None

        def fire(point):
            fault = chaos.plan.fire(point)
            if fault is None and host_id is not None:
                fault = chaos.plan.fire("%s:%s" % (point, host_id))
            return fault

        fault = fire("serve.host.stall")
        if fault is not None:
            stall = fault.param if fault.param else 0.05
        fault = fire("serve.host.preempt")
        if fault is not None:
            if fault.action == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise ConnectionError("chaos: serve.host.preempt")
        return stall

    async def _serve_one(self, msg, payload, chan_in, chan_out,
                         writer, write_lock=None, scope=None,
                         tenant=None, slo_class=None,
                         trace_default=False):
        start = time.perf_counter()
        rid = msg.get("id")
        self._m_requests.inc()
        # per-frame QoS labels override the hello's connection default
        tenant = msg.get("tenant", tenant)
        slo_class = qos.normalize_class(msg.get("slo_class", slo_class))
        shadow = bool(msg.get("shadow"))
        # request trace id: per-frame id (validated — plain bounded
        # string, the never-unpickle trust boundary is unchanged) wins;
        # the hello's trace default mints one per frame for clients
        # that opted in without supplying ids
        trace = None
        if reqtrace.enabled:
            trace = reqtrace.normalize_trace_id(msg.get("trace"))
            if trace is None and (trace_default or
                                  msg.get("trace") is True):
                trace = reqtrace.mint_trace_id()

        async def reply_frame(frame, raw=b""):
            if write_lock is None:
                write_frame(writer, frame, payload=raw,
                            secret=self._secret)
                await writer.drain()
            else:
                async with write_lock:
                    write_frame(writer, frame, payload=raw,
                                secret=self._secret)
                    await writer.drain()

        try:
            if self.quota is not None and not shadow:
                # shadow (canary mirror) frames are evidence, not
                # tenant load: never quota-charged, never counted
                wait = self.quota.admit(tenant)
                if wait is not None:
                    # over-quota: reject BEFORE any queue sees the
                    # request, shed attributed to the tenant's class,
                    # retry_after seeded-jittered per class so a
                    # synchronized flood does not re-stampede
                    qos.note_shed(slo_class)
                    raise ServeOverload(
                        "tenant %r over quota" % (tenant,),
                        retry_after=self.retry_jitter.apply(
                            max(wait, 0.05), slo_class))
            stall = self._fire_host_chaos()
            if stall:
                await asyncio.sleep(stall)
            t_rx = time.perf_counter()
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
            wire_rx = time.perf_counter() - t_rx
            if trace is not None:
                # admit covers quota + chaos gating (start -> decode
                # begin); wire_rx the frame decode — kept sequential so
                # the request track nests cleanly
                self._h_admit.observe(t_rx - start)
                self._h_wire_rx.observe(wire_rx)
            loop = asyncio.get_event_loop()
            result, reqs = await loop.run_in_executor(
                self._executor, self._infer, arr, scope, slo_class,
                shadow, trace, [("admit", start, t_rx - start),
                                ("wire_rx", t_rx, wire_rx)]
                if trace is not None else None)
            if scope is not None and scope.cancelled:
                return  # hedged loser: the peer forgot this copy
            t_tx = time.perf_counter()
            meta, raw_out = encode_tensor(
                result, codec=str(msg.get("codec", "none")))
            reply = {"op": "result", "id": rid}
            reply.update(meta)
            if trace is not None:
                # echo the id + the aggregated per-segment seconds so
                # a fleet front (or any client) can attribute this
                # leg's time without a trace file round-trip — plain
                # bounded JSON values only
                reply["trace"] = trace
                segs = {}
                for req in reqs:
                    for name, _, dur in (req.marks or ()):
                        segs[name] = segs.get(name, 0.0) + max(0.0, dur)
                if segs:
                    reply["segs"] = {name: round(dur, 6)
                                     for name, dur in segs.items()}
            if chan_out is not None:
                slot = None
                try:
                    slot = chan_out.write(raw_out)
                except Exception:
                    slot = None  # stale segment: inline fallback
                if slot is not None:
                    reply["shm"] = list(slot)
                    self._m_shm_tx.inc(len(raw_out))
                    raw_out = b""
            if raw_out:
                self._m_sock_tx.inc(len(raw_out))
            await reply_frame(reply, raw_out)
            if trace is not None:
                self._h_wire_tx.observe(time.perf_counter() - t_tx)
        except _CancelledByPeer:
            return  # no reply: cancelled requests answer with nothing
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
            elapsed = time.perf_counter() - start
            self._m_latency.observe(elapsed)
            if _tracer.active:
                args = {"trace": trace} if trace is not None else None
                _tracer.complete("transport.request", start, elapsed,
                                 cat="serve", args=args)

    def _infer(self, arr, scope=None, slo_class=None, shadow=False,
               trace=None, marks_prefix=None):
        """Blocking dispatch (executor thread): single samples ride
        :meth:`submit`, contiguous blocks ride :meth:`submit_block` —
        the zero-intermediate-copy path — chunked at the ladder top.
        Returns ``(block, requests)`` — the 2-D result plus the
        batcher requests it rode, so the caller can echo their segment
        timelines.  ``scope`` (pipelined mode) registers every batcher
        request so a wire cancel can retire them mid-flight instead of
        computing for a departed peer.  ``shadow`` frames (canary
        mirrors from a fleet front) ride :meth:`submit_shadow` so they
        are excluded from the served and tenant counters; a dropped
        shadow answers with a transient error — lost evidence, never a
        failed request.  ``trace`` labels every request of the frame;
        ``marks_prefix`` (wire_rx/admit marks stamped by the IO side)
        is prepended to the first request's timeline."""
        engine = self.pool.engine
        shape = engine.sample_shape
        track = scope.add if scope is not None else (lambda req: req)
        if shadow:
            if arr.shape != shape:
                raise ValueError(
                    "shadow frames mirror single samples only, got %s"
                    % (arr.shape,))
            req = self.pool.submit_shadow(arr, trace=trace)
            if req is None:
                raise ServeOverload(
                    "shadow mirror dropped (host loaded)",
                    retry_after=0.05)
            requests, single = [track(req)], True
        elif arr.shape == shape:
            requests = [track(self.pool.submit(arr,
                                               slo_class=slo_class,
                                               trace=trace))]
            single = True
        elif arr.shape[1:] == shape and arr.ndim == len(shape) + 1 \
                and arr.shape[0] >= 1:
            single = False
            requests = []
            try:
                for i in range(0, arr.shape[0], engine.max_batch):
                    requests.append(track(self.pool.submit_block(
                        arr[i:i + engine.max_batch],
                        slo_class=slo_class, trace=trace)))
            except Exception:
                for req in requests:
                    req.cancelled = True
                raise
        else:
            raise ValueError("expected sample shape %s or a batch of "
                             "them, got %s" % (shape, arr.shape))
        if marks_prefix and \
                getattr(requests[0], "marks", None) is None:
            # best-effort: the worker may already have completed the
            # request, in which case the wire marks stay histogram-only
            requests[0].marks = list(marks_prefix)
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
            # a failed/timed-out chunk must not leave its siblings
            # computing for nobody (same discipline as infer_payload)
            for req in requests:
                if not req.done.is_set():
                    req.cancelled = True
            raise
        if single:
            return rows[0][None], requests
        return (rows[0] if len(rows) == 1
                else numpy.concatenate(rows)), requests


class BinaryTransportClient(object):
    """Synchronous persistent-connection client (load generators,
    same-host services, tests).

    One request in flight at a time (``infer`` is serialized by a
    lock): the closed-loop shape the latency-bound benchmarks model,
    and the discipline the shm slots rely on.  ``sock=`` adopts an
    established socket (tests pair it with ``serve_socket``); ``shm=``
    offers the same-host shared-memory bypass, silently degrading to
    inline payloads when the segment cannot be created, attached, or
    has gone stale."""

    def __init__(self, host="127.0.0.1", port=None, sock=None,
                 secret=None, shm=True, shm_slot_mb=4.0, codec="none",
                 timeout=30.0, tenant=None, slo_class=None,
                 trace=False):
        #: QoS identity stamped into the hello as this connection's
        #: default (every frame inherits it server-side; per-call
        #: overrides ride infer(..., slo_class=...)).  None = legacy
        #: un-labelled client, served as class "batch"
        self.tenant = tenant
        self.slo_class = slo_class
        #: request tracing opt-in: a truthy hello "trace" makes the
        #: server mint an id per frame; per-call ids override via
        #: infer(..., trace="...").  The reply's id + per-segment
        #: breakdown land in :attr:`last_trace` / :attr:`last_segments`
        self.trace = bool(trace)
        self.last_trace = None
        self.last_segments = None
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
        # payload-byte accounting by road (the shm-bypass receipts)
        self.socket_tx_bytes = 0
        self.socket_rx_bytes = 0
        self.shm_tx_bytes = 0
        self.shm_rx_bytes = 0
        hello = {"op": "hello", "mid": machine_id()}
        if tenant is not None:
            hello["tenant"] = tenant
        if slo_class is not None:
            hello["slo_class"] = slo_class
        if self.trace:
            hello["trace"] = True
        if shm:
            # the client creates BOTH segments (it owns size and
            # lifetime; the server only attaches what it acks), so
            # there is no client-side attach step that could fail
            # after the handshake committed to the bypass
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
            # a failed handshake must not leak the created segments
            self._drop_channels()
            raise
        self.server_digest = reply.get("digest")
        self.server_dtype = numpy.dtype(str(reply.get("dtype", "<f4")))
        self.sample_shape = tuple(reply.get("sample_shape", ()))
        self.max_batch = int(reply.get("max_batch", 1))
        # keep only the roads the server confirmed it attached
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

    def infer(self, x, slo_class=None, tenant=None, trace=None):
        """One tensor round-trip: a sample or a contiguous batch in,
        the probability block out (numpy).  Overload answers raise
        :class:`ServeOverload` with the server's ``retry_after``.
        ``slo_class``/``tenant`` override this connection's hello
        default for one request; ``trace`` carries an explicit request
        trace id (the hello's ``trace=True`` default mints one
        server-side instead).  The reply's id and per-segment seconds
        are kept in :attr:`last_trace`/:attr:`last_segments`."""
        with self._lock:
            meta, raw = encode_tensor(x, self.codec)
            rid = self._next_id
            self._next_id += 1
            msg = {"op": "infer", "id": rid}
            if slo_class is not None:
                msg["slo_class"] = slo_class
            if tenant is not None:
                msg["tenant"] = tenant
            if trace is not None:
                msg["trace"] = trace
            msg.update(meta)
            payload = raw
            if self._chan_out is not None:
                slot = None
                try:
                    slot = self._chan_out.write(raw)
                except Exception:
                    # stale/closed segment mid-flight: drop the channel
                    # and fall back to the socket — the request still
                    # serves (tests/test_transport.py)
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
                        retry_after=float(
                            reply.get("retry_after", 0.1)))
                raise RuntimeError(reply.get("error", "serve error"))
            if reply.get("op") != "result" or reply.get("id") != rid:
                raise ProtocolError("unexpected reply %r" % reply)
            self.last_trace = reply.get("trace")
            self.last_segments = reply.get("segs")
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
