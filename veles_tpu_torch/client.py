"""The slave's half of the master-slave control plane.

Counterpart of ``veles_tpu/client.py``, with its names and behaviour:
the checksum handshake with the slave's computing power, the job ->
``do_job`` -> update cycle, async-slave pipelining (the next job is
requested while the previous update is in flight), reconnection with an
attempt budget that a productive session resets, ``death_probability``
and the ``client.job`` / ``slave.preempt`` / ``net.update`` chaos
points, the NTP-style clock-offset probes at join, and the trace and
series chunks shipped back with the updates.

A slave's jobs run per unit on its workflow's device (the card unless
``-d cpu`` or ``-d numpy`` asked for the host), on the event loop's
executor threads: the unit graph's launches go to the device's current
stream and a payload is read only after its host copy (which waits for
the card).

The computing power is the port's rating (``ops.benchmark.
estimate_computing_power`` at 256 cubed, the matmul kernel on the
card) on the workflow's device; on the host pseudo-device
(``NumpyDevice``) it is that device's ``numpy.dot`` rating.  A failed
rating raises: the JAX package reports a neutral 1.0 there, which on
the card would hide a kernel that does not run.
"""

import asyncio
import os
import random
import signal
import threading
import time

from veles_tpu_torch import chaos
from veles_tpu_torch.cmdline import CommandLineArgumentsRegistry
from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.network_common import (
    ProtocolError, ShmChannel, default_secret, machine_id, pack_payload,
    parse_address, read_frame, unpack_payload, write_frame)
from veles_tpu_torch.observe.cluster import estimate_offset
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer

__all__ = ["Client"]


class Client(Logger, metaclass=CommandLineArgumentsRegistry):

    @classmethod
    def init_parser(cls, parser):
        parser.add_argument(
            "--async-slave", action="store_true", default=None,
            help="pipeline: request the next job while the previous "
                 "update is in flight")
        parser.add_argument(
            "--reconnect-limit", type=int, default=None,
            help="reconnection attempt budget")
        parser.add_argument(
            "--death-probability", type=float, default=None,
            help="chaos testing: per-job probability of simulated "
                 "sudden death")
        return parser

    @classmethod
    def apply_args(cls, args):
        cfg = {}
        for flag in ("async_slave", "reconnect_limit",
                     "death_probability"):
            value = getattr(args, flag, None)
            if value is not None:
                cfg[flag] = value
        root.common.network.update(cfg)

    def __init__(self, address, workflow, launcher=None, codec=None,
                 async_slave=None, reconnect_limit=None,
                 death_probability=None, secret=None, tracer=None,
                 trace_scope="process", trace_chunk_max=2048):
        super(Client, self).__init__()
        net = root.common.network
        self.host, self.port = parse_address(address,
                                             default_host="127.0.0.1")
        self.workflow = workflow
        self.launcher = launcher
        self.codec = codec if codec is not None else net.get(
            "codec", "none")
        self.async_slave = async_slave if async_slave is not None \
            else net.get("async_slave", False)
        self.reconnect_limit = reconnect_limit \
            if reconnect_limit is not None \
            else net.get("reconnect_limit", 5)
        self.death_probability = death_probability \
            if death_probability is not None \
            else net.get("death_probability", 0.0)
        self.secret = secret if secret is not None else default_secret()
        self.sid = None
        self.jobs_done = 0
        # distributed tracing (docs/observability.md): the master's
        # run-scoped trace id arrives in the handshake ack; bounded
        # chunks of this process's recorded spans ship back with the
        # updates (and at session end) for cluster-scope merging
        self.trace_id = None
        #: estimated master-minus-local clock offset (NTP-style join
        #: handshake; None until a session established one)
        self.clock_offset = None
        self.clock_delay = None
        self.trace_chunks_sent = 0
        self.series_chunks_sent = 0
        self._mid = "%s:%d" % (os.uname().nodename, os.getpid())
        self._trace_tracer = tracer if tracer is not None else _tracer
        # "process": ship every recorded event (one-process-per-role
        # deployments).  "threads": ship only events recorded by THIS
        # client's threads — the in-process two-node tests share one
        # tracer between master and slave and must not cross-ship
        self._trace_scope = trace_scope
        self._trace_chunk_max = int(trace_chunk_max)
        self._trace_tids = set()
        self.reject_reason = None
        self.power_rating = None
        self.shm_sends = 0
        #: successful handshakes over this client's lifetime
        self.sessions_established = 0
        #: elasticity state (docs/distributed.md, "Elasticity
        #: contract"): the membership epoch this slave was admitted
        #: at rides the handshake ack; reshard pushes update the
        #: fleet's current epoch, this slave's power-weighted share of
        #: the unserved remainder, and the live fleet size
        self.member_epoch = None
        self.share = None
        self.fleet_size = None
        self.reshards_seen = 0
        #: device-mesh epoch stamped into reshard frames when the
        #: master trains on an elastic mesh (parallel.mesh.MeshManager)
        self.mesh_epoch = None
        self._handshaken = False
        self._session_progress = False
        self._stopping = False
        self._paused = False
        self._pending_update = None
        self._loop = None
        self._shm_in = None         # master -> slave payload channel
        self._shm_out = None        # slave -> master payload channel

    # -- lifecycle ----------------------------------------------------------

    def run(self):
        asyncio.run(self._main())

    def start_background(self):
        thread = threading.Thread(target=self.run, daemon=True)
        thread.start()
        return thread

    def on_workflow_finished(self):
        pass  # per-job workflow completion is normal on a slave

    def stop(self):
        self._stopping = True

    @property
    def paused(self):
        """True while the master has this slave parked."""
        return self._paused

    def pause(self):
        pass  # pausing is master-driven; see Server.pause()

    def resume(self):
        pass

    @property
    def computing_power(self):
        """1000 / seconds per 256-cubed product on the workflow's device
        (the launcher's when the workflow has none; else the backend
        ``-d`` / ``VELES_BACKEND`` names, the card by default), measured
        at each handshake, under ``graphs.shared()``.  Raises when the
        rating fails."""
        from veles_tpu_torch.launcher import _resolve_device
        from veles_tpu_torch.ops.benchmark import estimate_computing_power
        from veles_tpu_torch import graphs
        device = getattr(self.workflow, "device", None) or \
            getattr(self.launcher, "device", None) or _resolve_device()
        if not device.exists:
            # the host pseudo-device (-d numpy) rates the host, as the
            # JAX package's rates itself: numpy.dot
            return float(device.computing_power)
        # a farm's workers rate themselves while the others' jobs may
        # capture CUDA graphs on the same card
        with graphs.shared():
            return float(estimate_computing_power(size=256, repeats=1,
                                                  device=device))

    # -- asyncio internals ---------------------------------------------------

    async def _main(self):
        self._loop = asyncio.get_running_loop()
        attempts = 0
        while not self._stopping and attempts <= self.reconnect_limit:
            self._handshaken = False
            self._session_progress = False
            try:
                await self._session()
                return
            except ProtocolError as exc:
                if not self._handshaken:
                    # authentication/handshake failure is not
                    # transient: don't retry
                    self.reject_reason = str(exc)
                    self.error("protocol failure: %s", exc)
                    self._stopping = True
                    return
                # mid-session protocol violation (e.g. a corrupted
                # frame rejected by the HMAC check): the address and
                # secret are proven good, treat like a connection loss
                attempts = 1 if self._session_progress else attempts + 1
                self.warning("session protocol failure (%s); "
                             "reconnecting (retry %d/%d)", exc,
                             attempts, self.reconnect_limit)
            except (ConnectionError, OSError) as exc:
                # a session that made real progress (handshake + at
                # least one job) RESETS the budget: it bounds
                # consecutive unproductive attempts, so a long run
                # never exhausts a lifetime allowance on unrelated
                # blips — while a slave that dies on every job (or a
                # flapping master) still runs out
                attempts = 1 if self._session_progress else attempts + 1
                self.warning("connection lost (%s); retry %d/%d", exc,
                             attempts, self.reconnect_limit)
            if attempts > self.reconnect_limit:
                continue  # budget spent: exit now, skip a dead backoff
            # full jitter on the exponential backoff: simultaneously
            # orphaned slaves must not stampede a restarted master
            delay = min(0.2 * 2 ** attempts, 5.0)
            await asyncio.sleep(delay * (0.5 + random.random() / 2))
        if not self._stopping:
            self.error("giving up after %d reconnect attempts", attempts)

    async def _session(self):
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            self._mid = "%s:%d" % (os.uname().nodename, os.getpid())
            #: the rating this session's handshake reported
            self.power_rating = self.computing_power
            self._send(writer, {
                "type": "handshake",
                "checksum": self.workflow.checksum,
                "power": self.power_rating,
                "mid": self._mid,
                "machine": machine_id(),
                "pid": os.getpid()})
            msg, payload = await self._recv(reader)
            # the fleet reshards on EVERY membership change: another
            # slave joining or leaving while our handshake is still in
            # flight can push a reshard frame ahead of our ack (the
            # master registers us before generating our initial data).
            # Absorb them — dying here would turn a concurrent join
            # into a permanent loss of this slave
            while msg.get("type") == "reshard":
                self._apply_reshard(msg)
                msg, payload = await self._recv(reader)
            if msg.get("type") == "reject":
                self.reject_reason = msg.get("reason")
                retry_after = msg.get("retry_after")
                if retry_after is not None and not self._stopping:
                    # TTL quarantine, not a verdict: sleep out the FULL
                    # TTL (capped only against absurd values) so ONE
                    # attempt-budget charge outlives the blacklist —
                    # sleeping less would burn the whole budget on
                    # rejections before a long TTL ever expires
                    self.warning(
                        "master quarantined us (%s); retrying in "
                        "%.1fs", self.reject_reason, retry_after)
                    await asyncio.sleep(
                        min(max(float(retry_after), 0.0), 600.0) + 0.05)
                    raise ConnectionResetError(
                        "temporarily blacklisted by master")
                self.error("master rejected us: %s", self.reject_reason)
                self._stopping = True
                return
            if msg.get("type") == "stop":
                # a (re)join racing the master's shutdown: the
                # handshake is answered with 'stop' instead of an ack
                # — a clean end of the run, not a protocol violation
                self.info("master is stopping; ending session")
                self._stopping = True
                return
            assert msg.get("type") == "handshake_ack"
            self.sid = msg["id"]
            self._handshaken = True
            self.sessions_established += 1
            if "member_epoch" in msg:
                self.member_epoch = msg["member_epoch"]
            self._trace_tids.add(threading.get_ident())
            if msg.get("trace"):
                self.trace_id = msg["trace"]
                if self._trace_tracer.label is None:
                    self._trace_tracer.label = "slave:" + self._mid
            if "shm" in msg:
                try:
                    self._shm_in = ShmChannel.attach(msg["shm"]["m2s"])
                    self._shm_out = ShmChannel.attach(msg["shm"]["s2m"])
                    self.info("shm payload bypass engaged")
                except Exception:
                    self.exception("shm attach failed; staying on socket")
                    self._close_shm()
            initial = unpack_payload(payload, msg.get("codec", "none"))
            if initial:
                await self._in_thread(
                    self.workflow.apply_initial_data_from_master, initial)
            if "epoch" in msg:
                self.info("connected as %s (admitted at epoch %s)",
                          self.sid[:8], msg["epoch"])
            else:
                self.info("connected as %s", self.sid[:8])
            if self.trace_id is not None:
                # capability-gated: only masters that advertise
                # cluster tracing (a trace id in the ack) understand
                # clock_probe frames; older/stub masters are not sent
                # messages they would misparse as job traffic
                await self._clock_sync(reader, writer)
            await self._job_loop(reader, writer)
        finally:
            self._ship_trace_chunk(writer, final=True)
            self._ship_series_chunk(writer, final=True)
            self._close_shm()
            writer.close()

    async def _clock_sync(self, reader, writer, probes=4):
        """NTP-style offset estimate at join time (observe/cluster.py):
        probe the master's wall clock over the live connection, report
        the minimum-delay estimate so the master can offset-correct
        this slave's shipped trace chunks.  Failures only cost the
        estimate, never the session."""
        try:
            samples = []
            for _ in range(probes):
                t0 = time.time()
                self._send(writer, {"type": "clock_probe", "t0": t0})
                for _ in range(8):  # skip interleaved broadcasts
                    msg, _ = await self._recv(reader)
                    mtype = msg.get("type")
                    if mtype == "clock_probe_ack":
                        break
                    if mtype == "pause":
                        self._paused = True
                    elif mtype == "resume":
                        self._paused = False
                    elif mtype == "reshard":
                        self._apply_reshard(msg)
                    elif mtype == "stop":
                        self._stopping = True
                        return
                else:
                    return
                t3 = time.time()
                samples.append((msg.get("t0", t0), msg["t1"],
                                msg["t2"], t3))
            offset, delay = estimate_offset(samples)
            self.clock_offset, self.clock_delay = offset, delay
            self._send(writer, {"type": "clock_report",
                                "offset": offset, "delay": delay})
        except (KeyError, TypeError, ValueError) as exc:
            self.warning("clock sync failed (%s); traces from this "
                         "slave merge uncorrected", exc)

    def _ship_trace_chunk(self, writer, final=False):
        """Ship a bounded chunk of recorded trace events to the master
        (riding along with updates, or the remainder at session end).
        Never lets a telemetry failure touch the job cycle."""
        tracer = self._trace_tracer
        if not tracer.enabled or not self._handshaken:
            return
        try:
            idents = (self._trace_tids
                      if self._trace_scope == "threads" else None)
            # the label names THIS slave explicitly: an in-process
            # two-node setup shares one tracer whose label belongs to
            # the master, and the merged trace must not show two
            # tracks with the master's name
            chunk = tracer.take_chunk(
                max_events=self._trace_chunk_max, idents=idents,
                extra={"trace_id": self.trace_id, "final": final,
                       "label": "slave:" + self._mid})
            if chunk is None:
                return
            # chunks ride INLINE, never shm: the master closes its shm
            # segments at shutdown while late frames are still being
            # read (a chunk referencing a dead segment arrives empty),
            # and keeping telemetry off the two-slot channel preserves
            # its one-payload-in-flight-per-direction invariant
            self._send(writer, {"type": "trace_chunk",
                                "codec": self.codec}, payload=chunk,
                       use_shm=False)
            self.trace_chunks_sent += 1
        except Exception as exc:
            self.debug("trace chunk shipping failed: %s", exc)

    def _ship_series_chunk(self, writer, final=False):
        """Ship new telemetry buckets (observe/timeseries.py) to the
        master over the same inline path as trace chunks.  Gated on
        the same capability signal (a trace id in the ack) so stub or
        older masters never see a frame they would misparse; ticks
        the process ring first so slaves without a Heartbeat still
        bucketize at update cadence.  Never raises into the job
        cycle."""
        if not self._handshaken or self.trace_id is None:
            return
        try:
            from veles_tpu_torch.observe.timeseries import series
            series.maybe_tick()
            if final:
                series.tick()  # flush the partial tail bucket
            chunk = series.take_chunk(label="slave:" + self._mid)
            if chunk is None:
                return
            self._send(writer, {"type": "series_chunk",
                                "codec": self.codec}, payload=chunk,
                       use_shm=False)
            self.series_chunks_sent += 1
        except Exception as exc:
            self.debug("series chunk shipping failed: %s", exc)

    async def _job_loop(self, reader, writer):
        self._send(writer, {"type": "job_request"})
        while not self._stopping:
            msg, payload = await self._recv(reader)
            mtype = msg.get("type")
            if mtype == "stop":
                self.info("master signalled stop after %d jobs",
                          self.jobs_done)
                return
            if mtype == "pause":
                # master parked our outstanding job_request server-side;
                # nothing to do but note it — the next frame wakes us
                self._paused = True
                continue
            if mtype == "resume":
                # the server releases our parked request itself;
                # re-requesting here would double-request
                self._paused = False
                continue
            if mtype == "wait":
                # parked server-side at a sync point; the master
                # releases parked requesters itself (on updates, on
                # resume, on new farm batches).  Re-requesting here
                # would DOUBLE-SERVE: the release path and the poll
                # both hand out jobs, the per-connection backlog grows
                # without bound, and queued updates overrun the
                # two-slot shm channel (measured: stale results
                # surfacing six farm batches late)
                continue
            if mtype == "update_ack":
                continue
            if mtype == "reshard":
                # membership changed somewhere in the fleet: learn the
                # new split (and our admission epoch) without breaking
                # the job cycle
                self._apply_reshard(msg)
                continue
            if mtype != "job":
                continue
            if (self.death_probability > 0 and
                    random.random() < self.death_probability):
                # chaos: simulated sudden death (reference
                # client.py:438-442)
                self.warning("fault injection: dying")
                raise ConnectionResetError("injected death")
            if chaos.plan is not None:
                # deterministic variant: die on exactly the Nth job,
                # BEFORE running it — the master must requeue it and
                # this client (re-handshaken) must replay it
                fault = chaos.plan.fire("client.job")
                if fault is not None and fault.action == "die":
                    self.warning("fault injection: dying on job %d",
                                 self.jobs_done + 1)
                    raise ConnectionResetError("injected death (chaos)")
                # the REAL preemption: SIGKILL this process, the
                # closest in-tree stand-in for a preemptible chip
                # being reclaimed (no atexit, no finally blocks, no
                # goodbye frame).  Subprocess soaks arm this; the
                # in-process variant above covers the same master-side
                # requeue path without taking the test runner with it
                fault = chaos.plan.fire("slave.preempt")
                if fault is not None and fault.action == "kill":
                    self.warning(
                        "fault injection: preempting (SIGKILL self, "
                        "pid %d) on job %d", os.getpid(),
                        self.jobs_done + 1)
                    os.kill(os.getpid(), signal.SIGKILL)
            job8 = str(msg.get("job_id") or "")[:8]
            _tracer.instant("proto.job_in", cat="proto", job=job8,
                            trace=str(self.trace_id or "")[:8])
            data = unpack_payload(payload, msg.get("codec", "none"))
            if self.async_slave:
                # pipeline: ask for the next job before running this one
                self._send(writer, {"type": "job_request"})
            # the slave-side span a merged cluster trace hangs between
            # the master's proto.job_out and proto.update_in instants
            with _tracer.span("slave.job", cat="proto", job=job8,
                              trace=str(self.trace_id or "")[:8]):
                update = await self._run_job(data)
            self.jobs_done += 1
            self._session_progress = True
            if chaos.plan is not None:
                # poisoned-update injection (docs/health.md): ship a
                # structurally-valid update whose float payloads are
                # all NaN — the master's finiteness quarantine must
                # catch it BEFORE apply_data_from_slave
                fault = chaos.plan.fire("net.update")
                if fault is not None and fault.action == "nan":
                    self.warning("fault injection: poisoning update "
                                 "payload with non-finite values")
                    update = chaos.poison_tree(
                        update, float("nan") if fault.param is None
                        else fault.param)
            self._send(writer, {
                "type": "update", "job_id": msg.get("job_id"),
                "codec": self.codec}, payload=update)
            _registry.counter("client.jobs_done").inc()
            _tracer.instant("proto.update_out", cat="proto", job=job8,
                            trace=str(self.trace_id or "")[:8])
            # trace + telemetry chunks ride back WITH the update
            # cadence: bounded, so a chatty tracer never starves the
            # data plane
            self._ship_trace_chunk(writer)
            self._ship_series_chunk(writer)
            if not self.async_slave:
                self._send(writer, {"type": "job_request"})

    def _apply_reshard(self, msg):
        """A membership change repartitioned the epoch's unserved
        remainder (docs/distributed.md, "Elasticity contract"): record
        the fleet's new membership epoch and this slave's power-
        weighted share, and forward both to the workflow's
        ``apply_reshard`` hook when it defines one (the loader records
        them as its window hint).  The share itself is advisory — the
        master still serves minibatches job by job, so a stale share
        can never corrupt the sample accounting — but a FAILED hook is
        not: a slave whose loader could not adopt the new window is
        operating on stale elasticity state, so it severs and rejoins
        at the fresh epoch instead of limping along."""
        self.member_epoch = msg.get("epoch", self.member_epoch)
        self.share = msg.get("share")
        self.fleet_size = msg.get("fleet")
        self.mesh_epoch = msg.get("mesh_epoch", self.mesh_epoch)
        self.reshards_seen += 1
        _registry.gauge("elastic.membership_epoch").set(
            self.member_epoch or 0)
        self.info("resharded: membership epoch %s, fleet of %s, our "
                  "share %s", self.member_epoch, self.fleet_size,
                  "?" if self.share is None else self.share)
        hook = getattr(self.workflow, "apply_reshard", None)
        if hook is not None:
            try:
                hook({"epoch": self.member_epoch, "share": self.share,
                      "fleet": self.fleet_size,
                      "mesh_epoch": self.mesh_epoch,
                      "remaining": msg.get("remaining")})
            except Exception:
                self.exception("apply_reshard hook failed; severing to "
                               "rejoin at membership epoch %s",
                               self.member_epoch)
                _registry.counter("elastic.reshard_failures").inc()
                raise ConnectionResetError(
                    "apply_reshard hook failed; rejoining at a fresh "
                    "epoch")

    async def _run_job(self, data):
        result = {}

        def callback(update):
            result["update"] = update

        def invoke():
            # remember which executor threads run OUR jobs: with
            # trace_scope="threads" only their spans ship in chunks
            self._trace_tids.add(threading.get_ident())
            self.workflow.do_job(data, self._pending_update, callback)

        await self._in_thread(invoke)
        self._pending_update = None
        return result.get("update")

    # -- helpers -------------------------------------------------------------

    _NO_PAYLOAD = object()

    def _send(self, writer, msg, payload=_NO_PAYLOAD, use_shm=True):
        if payload is not Client._NO_PAYLOAD:
            raw = pack_payload(payload, self.codec)
            if use_shm and self._shm_out is not None:
                desc = self._shm_out.write(raw)
                if desc is not None:
                    msg = dict(msg, shm=list(desc))
                    self.shm_sends += 1
                    raw = b""
        else:
            raw = b""
        write_frame(writer, msg, raw, self.secret, peer="slave")

    async def _recv(self, reader):
        try:
            msg, payload = await read_frame(reader, self.secret,
                                            peer="slave")
        except asyncio.IncompleteReadError:
            raise ConnectionResetError("EOF from master")
        if self._shm_in is not None and "shm" in msg:
            off, length = msg["shm"]
            payload = self._shm_in.read(off, length)
        return msg, payload

    def _close_shm(self):
        for chan in (self._shm_in, self._shm_out):
            if chan is not None:
                chan.close()
        self._shm_in = self._shm_out = None

    async def _in_thread(self, fn, *args):
        return await self._loop.run_in_executor(None, fn, *args)
