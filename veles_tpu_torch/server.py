"""The master's half of the master-slave control plane: job farming with
elastic failure semantics.

Counterpart of ``veles_tpu/server.py``, with its names and behaviour.
A :class:`Server` serves a workflow's jobs to connecting slaves
(``veles_tpu_torch/client.py``) over asyncio streams of the frames of
``network_common``:

- the handshake checks the workflow's CHECKSUM, gives the slave an id,
  and hands it the workflow's initial data (and, on the same host, a
  pair of shared-memory channels for the payloads);
- job generation and update merging run on the event loop's executor
  threads, so the loop never blocks on workflow code; on the card the
  master's units do their device work there (one device-to-host copy
  per array to build a job, one add on the device to merge a delta, on
  the device's current stream, finished before a payload is read);
- sync points: a workflow answering "not ready" (``False``) parks the
  requester until an update lands;
- the ADAPTIVE TIMEOUT: a slave whose job takes longer than
  max(mean + 3 sigma of all job times, ``job_timeout``) is dropped and
  blacklisted for ``blacklist_ttl`` seconds;
- drop and requeue (``workflow.drop_slave``: the loader requeues the
  slave's minibatches), and a respawn hook with a per-slave
  exponential backoff;
- MEMBERSHIP EPOCHS: every join and leave bumps
  ``fleet.membership_epoch`` (``veles_tpu_torch/elastic.py``) and pushes
  each slave its power-weighted share of the epoch's unserved
  remainder (a ``reshard`` frame, stamped with the ``mesh_epoch`` of a
  ``MeshManager`` when one is set);
- EXACTLY-ONCE updates: a dropped slave's work is requeued at drop
  time, so its late update is rejected as ``stale``; the requeue is
  deferred while one of the slave's updates is being applied, and a
  second copy of a job (a speculative backup's loser) is dropped as a
  duplicate before validation;
- SPECULATIVE BACKUPS: an idle requester at a sync point shadows the
  oldest straggling job (``elastic.speculation_threshold``); the first
  result wins;
- poisoned-update QUARANTINE: an update with a non-finite float is never
  merged; its sender is dropped and blacklisted and the flight ring is
  dumped;
- pause and resume; a run-scoped trace id, a ``TraceCollector`` of the
  slaves' trace chunks with their clock offsets, and a
  ``FleetTelemetry`` of their series chunks.
"""

import asyncio
import math
import threading
import time
from collections import deque

import numpy

from veles_tpu_torch import chaos, elastic, health
from veles_tpu_torch.cmdline import CommandLineArgumentsRegistry
from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.network_common import (
    ProtocolError, ShmChannel, available_codecs, default_secret,
    machine_id, new_id, pack_payload, parse_address, read_frame,
    unpack_payload, write_frame)
from veles_tpu_torch.observe.cluster import TraceCollector
from veles_tpu_torch.observe.flight import flight as _flight
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.timeseries import FleetTelemetry
from veles_tpu_torch.observe.trace import tracer as _tracer

__all__ = ["Server", "SlaveDescription"]


class SlaveDescription(object):
    """What workflow code sees as ``slave`` in the data contract."""

    def __init__(self, sid, mid, pid, power):
        self.id = sid
        self.mid = mid
        self.pid = pid
        self.power = power

    def __repr__(self):
        return "<Slave %s power=%.1f>" % (self.id[:8], self.power)


class _SlaveConn(object):
    def __init__(self, slave, reader, writer):
        self.slave = slave
        self.reader = reader
        self.writer = writer
        self.jobs_out = {}          # job_id -> dispatch timestamp
        self.job_times = deque(maxlen=50)
        self.parked = False
        self.shm_out = None         # master -> slave payload channel
        self.shm_in = None          # slave -> master payload channel
        #: membership epoch this slave was admitted at (handshake)
        self.member_epoch = 0
        #: sample share from the last reshard push (None = unknown)
        self.share = None
        #: set by _drop: frames still in flight from this conn are
        #: STALE — its work was requeued, applying them would double
        self.dropped = False
        #: a generate_data_for_slave for this conn is in the executor:
        #: a reservation may exist that jobs_out does not show yet, so
        #: _speculate must not shadow this owner's in-flight job (the
        #: TOCTOU half of the single-reservation invariant)
        self.generating = False

    def close_shm(self):
        for chan in (self.shm_out, self.shm_in):
            if chan is not None:
                chan.close()
        self.shm_out = self.shm_in = None


class _InflightJob(object):
    """One dispatched-but-unapplied job: the stamp the speculation and
    exactly-once paths key on (the jobfarm's job-stamp logic, lifted).

    ``owner`` is the slave the workflow RESERVED the work for
    (``generate_data_for_slave``) — every copy's result applies under
    the owner's reservation so loader bookkeeping stays consistent;
    ``copies`` maps slave id -> dispatch stamp for the owner plus any
    speculative backups (first result wins, the rest are duplicates)."""

    __slots__ = ("job_id", "data", "owner", "copies")

    def __init__(self, job_id, data, owner, t0):
        self.job_id = job_id
        self.data = data
        self.owner = owner
        self.copies = {owner.id: t0}


class Server(Logger, metaclass=CommandLineArgumentsRegistry):
    """Serve a workflow's jobs to connecting slaves."""

    #: sentinel returned by the update validator when a payload failed
    #: the finiteness check (either mode) -> quarantine path
    _POISONED = object()
    #: sentinel for an apply that raised (already acked 0); distinct
    #: from a legal None return, which counts as a served update
    _FAILED = object()
    #: bound on the shutdown drain of in-flight applies (_main's
    #: teardown waits for apply bookkeeping, not forever on a wedged
    #: executor)
    APPLY_DRAIN_S = 10.0

    @classmethod
    def init_parser(cls, parser):
        parser.add_argument(
            "--job-timeout", type=float, default=None,
            help="base seconds before a slave's job is considered "
                 "stuck (the adaptive threshold never drops below it)")
        parser.add_argument(
            "--codec", default=None, choices=available_codecs(),
            help="wire payload codec")
        parser.add_argument(
            "--no-shm", action="store_true", default=None,
            help="disable the same-host shared-memory payload bypass")
        parser.add_argument(
            "--blacklist-ttl", type=float, default=None,
            help="seconds a dropped/quarantined slave stays "
                 "blacklisted before it may rejoin")
        parser.add_argument(
            "--speculation-factor", type=float, default=None,
            help="straggler bar: an in-flight job older than this "
                 "factor x the mean job duration is shadowed on an "
                 "idle slave (first result wins)")
        parser.add_argument(
            "--min-speculation-s", type=float, default=None,
            help="absolute floor (seconds) under the speculation "
                 "threshold, so millisecond-scale jobs don't "
                 "speculate their whole tail")
        return parser

    @classmethod
    def apply_args(cls, args):
        cfg = {}
        if getattr(args, "job_timeout", None) is not None:
            cfg["job_timeout"] = args.job_timeout
        if getattr(args, "codec", None) is not None:
            cfg["codec"] = args.codec
        if getattr(args, "no_shm", None):
            cfg["shm"] = False
        if getattr(args, "blacklist_ttl", None) is not None:
            cfg["blacklist_ttl"] = args.blacklist_ttl
        if getattr(args, "speculation_factor", None) is not None:
            cfg["speculation_factor"] = args.speculation_factor
        if getattr(args, "min_speculation_s", None) is not None:
            cfg["min_speculation_s"] = args.min_speculation_s
        root.common.network.update(cfg)

    def __init__(self, address, workflow, launcher=None, codec=None,
                 job_timeout=None, respawn_hook=None, secret=None,
                 use_shm=None, shm_size=None, blacklist_ttl=None,
                 speculation_factor=None, min_speculation_s=None):
        super(Server, self).__init__()
        net = root.common.network
        self.host, self.port = parse_address(address)
        self.workflow = workflow
        self.launcher = launcher
        self.codec = codec if codec is not None else net.get(
            "codec", "none")
        self.use_shm = use_shm if use_shm is not None else net.get(
            "shm", True)
        self.shm_size = shm_size if shm_size is not None else net.get(
            "shm_size", 1 << 24)
        self.shm_sends = 0
        self.job_timeout = job_timeout if job_timeout is not None \
            else net.get("job_timeout", 60.0)
        self.respawn_hook = respawn_hook
        self.secret = secret if secret is not None else default_secret()
        # mid -> expiry timestamp: blacklisting is a QUARANTINE with a
        # TTL, not a life sentence — a once-slow machine (or one that
        # sent one poisoned update) may rejoin after it expires
        self.blacklist_ttl = blacklist_ttl if blacklist_ttl is not None \
            else net.get("blacklist_ttl", 30.0)
        self.blacklist = {}
        #: per-slave consecutive respawn attempts (mid -> count); the
        #: respawn delay backs off on THIS, not on global blacklist
        #: size, and resets once the slave applies a productive update
        self._respawn_attempts = {}
        #: run-scoped trace id: propagated to every slave in the
        #: handshake ack so the whole job's spans — master and slave —
        #: stitch under ONE id in the merged cluster trace
        self.trace_id = new_id()
        #: shipped slave trace chunks + per-slave clock offsets
        self.trace_collector = TraceCollector()
        # master-side half of the fleet telemetry plane: per-slave
        # series chunks merged with the trace-merge clock offsets
        self.fleet_telemetry = FleetTelemetry()
        self.quarantined = 0
        self.slaves = {}
        self._waiting = deque()     # parked requesters (sync points)
        self._all_job_times = deque(maxlen=500)
        #: live-membership ledger: every join/leave bumps the
        #: membership epoch and triggers a reshard push
        self.fleet = elastic.FleetView()
        #: dispatched-but-unapplied jobs (job_id -> _InflightJob); the
        #: stamp speculation and the exactly-once duplicate drop key on.
        #: Workflows that run their OWN backup-copy bookkeeping (the
        #: jobfarm adapter dedups by result slot) set
        #: ``owns_speculation = True`` and opt out of both.
        self._inflight = {}
        self._workflow_speculates = bool(
            getattr(workflow, "owns_speculation", False))
        self.speculation_factor = speculation_factor \
            if speculation_factor is not None \
            else net.get("speculation_factor", 2.0)
        self.min_speculation_s = min_speculation_s \
            if min_speculation_s is not None \
            else net.get("min_speculation_s", 5.0)
        #: speculation_factor=inf is the off-switch (the threshold is
        #: infinite, nothing ever straggles past it); with it off the
        #: job stamps skip caching payloads — the stamp stays (the
        #: exactly-once duplicate/stale fences key on it) but the
        #: master no longer retains every in-flight job's payload
        self._speculation_on = math.isfinite(self.speculation_factor)
        #: updates currently mid-apply on the executor, keyed by the
        #: slave id the apply RETIRES A RESERVATION OF (the owner for
        #: speculated jobs, the sender otherwise).  _drop defers the
        #: requeue while that slave has an apply in flight — the
        #: drop-vs-apply race: the same job must not requeue AND
        #: apply.  Keying on the apply target (not the sender's conn)
        #: also covers dropping a straggling OWNER while its backup's
        #: winning update is mid-apply.
        self._applying = {}
        #: drops parked by _drop while an apply for that slave id is
        #: in flight: slave id -> (conn, reason); the apply path
        #: finishes them when the executor returns
        self._deferred_drops = {}
        #: optional parallel.mesh.MeshManager driving an elastic device
        #: mesh on this master: when set, reshard frames carry its
        #: ``mesh_epoch`` so slaves see which train-state layout their
        #: membership change produced
        self.mesh_manager = None
        # elastic-fleet accounting (mirrored into elastic.* metrics)
        self.reshards = 0
        self.speculated = 0
        self.duplicates_dropped = 0
        self.stale_updates = 0
        self.drops_deferred = 0
        self._loop = None
        self._server = None
        self._finishing = False
        self._paused = False
        self._stop_event = None
        self._done = threading.Event()
        self._listening = threading.Event()
        self.bind_error = None
        self.jobs_dispatched = 0
        self.updates_applied = 0

    # -- public lifecycle ---------------------------------------------------

    def run(self):
        """Blocking: serve until the workflow finishes."""
        asyncio.run(self._main())

    def start_background(self):
        thread = threading.Thread(target=self.run, daemon=True)
        thread.start()
        return thread

    def wait_listening(self, timeout=10.0):
        """Block until the socket accepts connections.  Returns True
        when listening; False on bind failure (see ``bind_error``) or
        timeout — a background server that failed to bind would
        otherwise die silently on its daemon thread."""
        if not self._listening.wait(timeout):
            return False
        return self.bind_error is None

    def on_workflow_finished(self):
        self._finishing = True
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._signal_stop)

    def stop(self):
        self.on_workflow_finished()

    def pause(self):
        """Park all slaves: broadcast 'pause'; job requests queue up
        server-side until resume()."""
        if self._loop is None:
            self._paused = True
            return
        self._loop.call_soon_threadsafe(self._do_pause)

    def resume(self):
        if self._loop is None:
            self._paused = False
            return
        self._loop.call_soon_threadsafe(
            lambda: asyncio.ensure_future(self._do_resume()))

    @property
    def paused(self):
        return self._paused

    def _do_pause(self):
        self._paused = True
        self._broadcast({"type": "pause"})

    async def _do_resume(self):
        self._paused = False
        self._broadcast({"type": "resume"})
        await self._release_parked()

    # -- asyncio internals ---------------------------------------------------

    def _signal_stop(self):
        self._broadcast_stop()
        if self._stop_event is not None:
            self._stop_event.set()

    async def _main(self):
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        if self._finishing:
            self._stop_event.set()
        try:
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self.port)
        except OSError as exc:
            # surface the failure to waiters (start_background callers
            # can only see it through bind_error) instead of dying
            # silently on a daemon thread
            self.bind_error = exc
            self.error("failed to bind %s:%s: %s", self.host,
                       self.port, exc)
            self._listening.set()
            self._done.set()
            return
        self.port = self._server.sockets[0].getsockname()[1]
        self._listening.set()
        if getattr(self.workflow, "restored_from_snapshot_", False):
            self.info(
                "master listening on %s:%d (restored from snapshot; "
                "re-admitting slaves at epoch %s)", self.host, self.port,
                getattr(getattr(self.workflow, "loader", None),
                        "epoch_number", "?"))
        else:
            self.info("master listening on %s:%d", self.host, self.port)
        watchdog = asyncio.ensure_future(self._watchdog())
        try:
            await self._stop_event.wait()
        finally:
            self._finishing = True
            watchdog.cancel()
            self._broadcast_stop()
            # Drain in-flight applies before tearing down.  A workflow
            # that completes INSIDE check_and_apply (decision latching
            # ``complete`` on the executor thread) schedules the stop
            # via call_soon_threadsafe BEFORE the executor future's own
            # continuation, so returning here would let asyncio.run
            # cancel the _apply_update coroutine mid-bookkeeping: the
            # weights already mutated but updates_applied / the ack /
            # deferred drops never ran (the kill-during-reshard
            # lost-update race).  The continuation from the executor
            # await through the counter bump has no awaits, so an empty
            # _applying map guarantees the bookkeeping finished.
            deadline = self._loop.time() + self.APPLY_DRAIN_S
            while self._applying and self._loop.time() < deadline:
                await asyncio.sleep(0.01)
            if self._applying:
                self.warning(
                    "shutdown drain timed out with %d apply(s) still "
                    "in flight", len(self._applying))
            for conn in list(self.slaves.values()):
                conn.close_shm()
            self._server.close()
            await self._server.wait_closed()
            self._done.set()

    async def _handle_conn(self, reader, writer):
        conn = None
        try:
            while True:
                msg, payload = await read_frame(reader, self.secret,
                                                peer="master")
                if conn is not None and conn.shm_in is not None \
                        and "shm" in msg:
                    off, length = msg["shm"]
                    payload = conn.shm_in.read(off, length)
                conn = await self._dispatch(
                    msg, payload, conn, reader, writer)
                if conn is None and msg.get("type") != "handshake":
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except ProtocolError as exc:
            self.warning("rejecting peer: %s", exc)
        except Exception:
            self.exception("connection handler failed")
        finally:
            if conn is not None:
                self._drop(conn, "disconnected")
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, msg, payload, conn, reader, writer):
        mtype = msg.get("type")
        if mtype == "handshake":
            return await self._handshake(msg, reader, writer)
        if conn is None:
            self._send(writer, {"type": "error",
                                "reason": "handshake required"})
            return None
        if conn.dropped:
            # this membership is OVER: the slave's work was requeued at
            # drop time, so frames still buffered on the old session
            # must not act.  A late update is rejected as STALE (the
            # exactly-once half of the elasticity contract) and any
            # other traffic severs the conn — the slave reconnects and
            # rejoins at a fresh membership epoch.
            if mtype == "update":
                self._reject_stale(conn, msg)
            else:
                try:
                    conn.writer.close()
                except Exception:
                    pass
            return conn
        if mtype == "job_request":
            await self._serve_job(conn)
        elif mtype == "update":
            await self._apply_update(conn, msg, payload)
        elif mtype == "clock_probe":
            # NTP-style offset handshake (observe/cluster.py): answer
            # IN the event loop — a thread hop here would inflate the
            # apparent one-way delay the estimate divides by
            now = time.time()
            self._send(conn.writer, {
                "type": "clock_probe_ack", "t0": msg.get("t0"),
                "t1": now, "t2": now})
        elif mtype == "clock_report":
            offset = msg.get("offset")
            if isinstance(offset, (int, float)):
                # the client reports "server ahead by offset", i.e.
                # slave_wall + offset = master_wall — exactly the
                # additive correction merge_parts applies
                self.trace_collector.set_offset(
                    conn.slave.mid, float(offset), msg.get("delay"))
                # the fleet telemetry merge corrects with the SAME
                # estimate trace merging uses: "slave:" prefix matches
                # the label series chunks arrive under
                self.fleet_telemetry.set_offset(
                    "slave:" + conn.slave.mid, float(offset),
                    msg.get("delay"))
                self.debug("slave %s clock offset %.6fs (delay %.6fs)",
                           conn.slave.id[:8], offset,
                           msg.get("delay") or -1.0)
        elif mtype == "trace_chunk":
            try:
                chunk = unpack_payload(payload, msg.get("codec", "none"))
            except Exception as exc:
                self.warning("undecodable trace chunk from slave %s "
                             "dropped (%s: %s)", conn.slave.id[:8],
                             type(exc).__name__, exc)
            else:
                self.trace_collector.add_chunk(conn.slave.mid, chunk)
        elif mtype == "series_chunk":
            # telemetry buckets ride the same inline path as trace
            # chunks and get the same validate-and-drop discipline: a
            # malformed chunk costs the chunk, never the session
            try:
                chunk = unpack_payload(payload, msg.get("codec", "none"))
            except Exception as exc:
                self.warning("undecodable series chunk from slave %s "
                             "dropped (%s: %s)", conn.slave.id[:8],
                             type(exc).__name__, exc)
            else:
                self.fleet_telemetry.add_chunk(
                    "slave:" + conn.slave.mid, chunk)
        return conn

    def _blacklist(self, mid):
        self.blacklist[mid] = time.time() + self.blacklist_ttl
        _registry.gauge("server.blacklist_size").set(len(self.blacklist))

    def _blacklisted(self, mid):
        """True while ``mid``'s quarantine TTL has not expired; expired
        entries are dropped on the way (the slave may rejoin)."""
        expiry = self.blacklist.get(mid)
        if expiry is None:
            return False
        if time.time() >= expiry:
            del self.blacklist[mid]
            _registry.gauge("server.blacklist_size").set(
                len(self.blacklist))
            self.info("blacklist TTL expired for slave %s; eligible "
                      "to rejoin", mid)
            return False
        return True

    async def _handshake(self, msg, reader, writer):
        if self._finishing:
            # a join racing shutdown must not allocate per-slave
            # resources (shm segments): the event loop may be torn
            # down before this handler's cleanup path ever runs,
            # leaking the segments past process exit
            self._send(writer, {"type": "stop"})
            return None
        checksum = msg.get("checksum")
        mid = msg.get("mid", "?")
        if checksum != self.workflow.checksum:
            self.warning("rejecting slave %s: checksum mismatch", mid)
            self._send(writer, {"type": "reject",
                                "reason": "checksum mismatch"})
            return None
        if self._blacklisted(mid):
            retry_after = max(self.blacklist[mid] - time.time(), 0.0)
            self.warning("rejecting blacklisted slave %s (%.1fs left)",
                         mid, retry_after)
            # retry_after marks the rejection TRANSIENT: the client
            # sleeps it out and retries instead of giving up for good
            self._send(writer, {"type": "reject",
                                "reason": "blacklisted",
                                "retry_after": retry_after})
            return None
        sid = new_id()
        slave = SlaveDescription(sid, mid, msg.get("pid", 0),
                                 msg.get("power", 1.0))
        conn = _SlaveConn(slave, reader, writer)
        # the run's trace id rides the protocol header: every span or
        # chunk the slave records correlates back to THIS master run
        ack = {"type": "handshake_ack", "id": sid,
               "trace": self.trace_id}
        epoch = getattr(getattr(self.workflow, "loader", None),
                        "epoch_number", None)
        if epoch is not None:
            # a slave (re)joining a restarted master learns the epoch
            # it is being admitted at — resume observability
            ack["epoch"] = int(epoch)
        if self.use_shm and msg.get("machine") == machine_id():
            # same host: payloads ride shared memory, not the socket
            try:
                conn.shm_out = ShmChannel.create(self.shm_size)
                conn.shm_in = ShmChannel.create(self.shm_size)
                ack["shm"] = {"m2s": conn.shm_out.name,
                              "s2m": conn.shm_in.name}
                self.info("slave %s is local: shm payload bypass on",
                          sid[:8])
            except Exception:
                self.exception("shm setup failed; staying on socket")
                conn.close_shm()
        self.slaves[sid] = conn
        # membership epoch: the join bumps it, the ack teaches the
        # slave which epoch it was admitted at, and the reshard below
        # republishes the unserved split over the grown fleet
        conn.member_epoch = self.fleet.join(sid, slave.power)
        ack["member_epoch"] = conn.member_epoch
        initial = await self._in_thread(
            self.workflow.generate_initial_data_for_slave, slave)
        self._send(writer, ack, payload=initial)
        if self._paused:
            self._send(writer, {"type": "pause"})
        self.info("slave %s connected (mid %s; membership epoch %d)",
                  sid[:8], mid, conn.member_epoch)
        self._reshard("join")
        return conn

    async def _serve_job(self, conn):
        if self._finishing:
            self._send(conn.writer, {"type": "stop"})
            return
        if self._paused:
            # parked until resume(); no reply — the slave already got
            # 'pause' and is not busy-waiting
            conn.parked = True
            self._waiting.append(conn)
            return
        if not self._workflow_speculates and (
                self._applying.get(conn.slave.id) or any(
                    len(job.copies) > 1
                    and job.owner.id == conn.slave.id
                    for job in self._inflight.values())):
            # an async (pipelining) owner asking for MORE work while
            # one of its jobs is speculated — or while a result is
            # mid-apply under its id (the backup's winning copy, once
            # it lands, applies under the OWNER's reservation): serving
            # it would open a second reservation under this owner and
            # the in-flight apply would retire the WRONG one (the
            # loader pops reservations LIFO per slave).  Park until
            # the speculated job resolves; both the apply and drop
            # paths release parked requesters.
            conn.parked = True
            self._waiting.append(conn)
            self._send(conn.writer, {"type": "wait"})
            return
        # fence the guard until the dispatch is stamped: the
        # reservation generate_data_for_slave creates is invisible to
        # jobs_out until conn.jobs_out is updated below (the executor
        # hop, and the chaos stall point, both yield the loop), and a
        # peer speculating this owner's job in that window would cross
        # the two reservations
        conn.generating = True
        try:
            data = await self._in_thread(
                self.workflow.generate_data_for_slave, conn.slave)
            if data is False:
                # nothing fresh: maybe shadow a straggler's in-flight
                # job (the jobfarm's backup-copy move, lifted here —
                # first result wins, the loser is dropped before
                # validation)
                conn.generating = False
                if self._speculate(conn):
                    return
                # sync point: park until an update unlocks new work
                conn.parked = True
                self._waiting.append(conn)
                self._send(conn.writer, {"type": "wait"})
                return
            if chaos.plan is not None:
                fault = chaos.plan.fire("server.serve")
                if fault is not None:
                    if fault.action == "kill":
                        # mid-batch conn death: the minibatch is
                        # already reserved to this slave, so the drop
                        # path MUST requeue it (watchdog/drop_slave
                        # contract)
                        self.warning("fault injection: killing conn "
                                     "of slave %s mid-batch",
                                     conn.slave.id[:8])
                        conn.writer.close()
                        return
                    if fault.action == "stall":
                        await asyncio.sleep(fault.param or 0.5)
            job_id = new_id()
            # perf_counter, not time.time: these stamps feed the
            # adaptive timeout and the job-latency stats, and a
            # wall-clock NTP step would fake a straggler (or hide one)
            t0 = time.perf_counter()
            conn.jobs_out[job_id] = t0
            if not self._workflow_speculates:
                # the job stamp: speculation re-serves this exact
                # payload and the exactly-once drop rejects the losing
                # duplicate
                self._inflight[job_id] = _InflightJob(
                    job_id, data if self._speculation_on else None,
                    conn.slave, t0)
        finally:
            conn.generating = False
        self.jobs_dispatched += 1
        _registry.counter("server.jobs_dispatched").inc()
        _tracer.instant("proto.job_out", cat="proto",
                        slave=conn.slave.id[:8], job=job_id[:8],
                        trace=self.trace_id[:8])
        self._send(conn.writer, {"type": "job", "job_id": job_id},
                   payload=data, conn=conn)

    def _speculate(self, conn):
        """Try to shadow the oldest straggling in-flight job on the
        idle requester ``conn``.  Returns True when a backup copy was
        dispatched.  The bar is the power-corrected MapReduce backup
        threshold (``elastic.speculation_threshold``); with no
        completed durations there is no credible mean and nothing
        speculates (immediate re-issue would duplicate every tail
        job).  A job is only eligible while its owner has no OTHER
        job outstanding: the loader contract pops reservations LIFO
        per slave, so shadowing one of several pipelined jobs could
        retire the wrong reservation."""
        if self._workflow_speculates or not self._speculation_on \
                or not self._all_job_times:
            return False
        mean = sum(self._all_job_times) / len(self._all_job_times)
        mean_power = elastic.fleet_mean_power(self.fleet.powers())
        now = time.perf_counter()
        best, best_age = None, 0.0
        for job in self._inflight.values():
            if conn.slave.id in job.copies:
                continue  # never a second copy on the same slave
            owner_conn = self.slaves.get(job.owner.id)
            if owner_conn is None:
                # departed owner: its stamp is about to be deleted and
                # its work requeued by the (possibly deferred) drop —
                # a backup copy would be guaranteed duplicate work
                continue
            if owner_conn.generating or len(owner_conn.jobs_out) > 1:
                continue
            age = now - min(job.copies.values())
            threshold = elastic.speculation_threshold(
                mean, self.speculation_factor, self.min_speculation_s,
                owner_power=job.owner.power, mean_power=mean_power)
            if age > threshold and age > best_age:
                best, best_age = job, age
        if best is None:
            return False
        best.copies[conn.slave.id] = now
        conn.jobs_out[best.job_id] = now
        self.speculated += 1
        # a backup copy is a dispatch like any other: count it and
        # emit the proto.job_out instant so the merged cluster trace
        # can pair the winner's proto.update_in with a dispatch event
        self.jobs_dispatched += 1
        _registry.counter("server.jobs_dispatched").inc()
        _tracer.instant("proto.job_out", cat="proto",
                        slave=conn.slave.id[:8], job=best.job_id[:8],
                        trace=self.trace_id[:8])
        _registry.counter("elastic.speculative_jobs").inc()
        _registry.gauge("elastic.speculative_inflight").set(
            self._speculative_inflight())
        _tracer.instant("elastic.speculate", cat="elastic",
                        job=best.job_id[:8], owner=best.owner.id[:8],
                        backup=conn.slave.id[:8],
                        age_s=round(best_age, 3))
        self.info("speculating job %s of straggler %s on idle slave "
                  "%s (%.2fs in flight)", best.job_id[:8],
                  best.owner.id[:8], conn.slave.id[:8], best_age)
        self._send(conn.writer, {"type": "job", "job_id": best.job_id},
                   payload=best.data, conn=conn)
        return True

    def _speculative_inflight(self):
        return sum(1 for job in self._inflight.values()
                   if len(job.copies) > 1)

    def _reject_stale(self, conn, msg):
        """Reject an update from a DEPARTED member: its work was
        requeued at drop time (membership epoch bumped past its
        admission), so applying the late duplicate would double."""
        job_id = str(msg.get("job_id") or "")[:8]
        self.stale_updates += 1
        _registry.counter("elastic.stale_updates").inc()
        _tracer.instant("elastic.stale_update", cat="elastic",
                        slave=conn.slave.id[:8], job=job_id,
                        member_epoch=conn.member_epoch,
                        fleet_epoch=self.fleet.membership_epoch)
        self.warning(
            "rejecting stale update (job %s) from departed slave %s: "
            "admitted at membership epoch %d, fleet is at %d — its "
            "work was requeued at drop time", job_id,
            conn.slave.id[:8], conn.member_epoch,
            self.fleet.membership_epoch)
        try:
            self._send(conn.writer, {"type": "update_ack", "result": 0})
        except Exception:
            pass

    async def _apply_update(self, conn, msg, payload):
        update = unpack_payload(payload, msg.get("codec", "none"))
        job_id = msg.get("job_id")
        started = conn.jobs_out.pop(job_id, None)
        if started is not None:
            elapsed = time.perf_counter() - started
            conn.job_times.append(elapsed)
            self._all_job_times.append(elapsed)
        # first result wins: pop the job stamp — a second copy of the
        # same job (speculation loser, or a backup finishing after its
        # owner was requeued) finds it gone and is dropped BEFORE
        # validation or apply ever run
        inflight = self._inflight.pop(job_id, None) \
            if job_id is not None else None
        if not self._workflow_speculates and job_id is not None \
                and inflight is None:
            self.duplicates_dropped += 1
            _registry.counter("elastic.duplicates_dropped").inc()
            _registry.gauge("elastic.speculative_inflight").set(
                self._speculative_inflight())
            _tracer.instant("elastic.duplicate_drop", cat="elastic",
                            slave=conn.slave.id[:8],
                            job=str(job_id)[:8])
            self.info("dropping duplicate update for job %s from "
                      "slave %s (another copy won)", str(job_id)[:8],
                      conn.slave.id[:8])
            self._send(conn.writer, {"type": "update_ack", "result": 0})
            if not self._paused:
                await self._release_parked()
            return
        # every copy's result applies under the OWNER's reservation:
        # the loader keyed the minibatch to the slave it generated the
        # job for, and a speculative winner must retire that exact
        # reservation, not open a phantom one of its own
        apply_slave = inflight.owner if inflight is not None \
            else conn.slave
        if inflight is not None and len(inflight.copies) > 1:
            # a speculated job just resolved (this copy won)
            _registry.gauge("elastic.speculative_inflight").set(
                self._speculative_inflight())
        # numerics quarantine: a NaN payload merged into the canonical
        # state poisons every slave's next job.  Validation and apply run
        # in ONE executor hop; a workflow whose updates are control
        # records only (update_validation == "inline") validates each
        # part during its own apply, one walk over the payload; a
        # delta-shipping workflow keeps the all-or-nothing prewalk.
        _tracer.instant("proto.update_in", cat="proto",
                        slave=conn.slave.id[:8],
                        job=str(job_id or "")[:8],
                        trace=self.trace_id[:8])

        def check_and_apply():
            inline = getattr(self.workflow, "apply_update_validated",
                             None)
            if inline is not None and getattr(
                    self.workflow, "update_validation",
                    "prewalk") == "inline":
                try:
                    return inline(update, apply_slave)
                except health.PoisonedUpdate:
                    return Server._POISONED
            if not health.all_finite(update):
                return Server._POISONED
            return self.workflow.apply_data_from_slave(
                update, apply_slave)

        apply_sid = apply_slave.id
        self._applying[apply_sid] = self._applying.get(apply_sid, 0) + 1
        try:
            result = await self._in_thread(check_and_apply)
        except Exception:
            self.exception("update application failed")
            self._send(conn.writer, {"type": "update_ack", "result": 0})
            result = Server._FAILED
        finally:
            left = self._applying.get(apply_sid, 1) - 1
            if left:
                self._applying[apply_sid] = left
            else:
                self._applying.pop(apply_sid, None)
                deferred = self._deferred_drops.pop(apply_sid, None)
                if deferred is not None:
                    # the drop that raced this apply: now that the
                    # update is fully applied (or failed), requeue
                    # what is STILL outstanding — never the job that
                    # just applied
                    self._finish_drop(*deferred)
        if result is Server._POISONED and inflight is not None \
                and conn.slave.id != inflight.owner.id \
                and len(inflight.copies) > 1 \
                and inflight.owner.id in self.slaves:
            # a poisoned SPECULATIVE backup must not lose the job: the
            # owner's copy is still running, so reinstate the stamp
            # (minus the poisoned sender) and let the owner's result
            # apply normally.  NOT when the owner itself was dropped
            # while this apply was in flight — its reservation was
            # already requeued by the (deferred) drop, so reinstating
            # would leave a phantom job racing the requeued minibatch
            inflight.copies.pop(conn.slave.id, None)
            self._inflight[inflight.job_id] = inflight
        if result is Server._FAILED and inflight is not None \
                and len(inflight.copies) > 1 \
                and inflight.owner.id in self.slaves:
            # a transient master-side apply failure must not orphan a
            # SPECULATED job: the other copy is still running, so
            # reinstate the stamp (minus the failed sender — owner or
            # backup) and let the surviving copy's result apply under
            # the owner's reservation instead of dropping as a
            # duplicate — exactly-once in the applied-zero-times
            # direction.  Same departed-owner exclusion as above.
            inflight.copies.pop(conn.slave.id, None)
            if inflight.copies:
                self._inflight[inflight.job_id] = inflight
        if result is Server._POISONED:
            self.quarantined += 1
            _registry.counter("server.quarantined").inc()
            _tracer.instant("proto.quarantine", cat="proto",
                            slave=conn.slave.id[:8], mid=conn.slave.mid)
            self._blacklist(conn.slave.mid)
            self.warning(
                "quarantining slave %s (mid %s): non-finite update "
                "payload dropped, blacklisted for %.0fs",
                conn.slave.id[:8], conn.slave.mid, self.blacklist_ttl)
            # black-box dump: the quarantine decision plus the ring of
            # spans/heartbeats leading up to it, loadable post-mortem
            _flight.dump(reason="quarantine")
            self._send(conn.writer, {"type": "update_ack", "result": 0})
            self._drop(conn, "poisoned update")
            try:
                conn.writer.close()
            except Exception:
                pass
            return
        if result is not Server._FAILED:
            # a None return is a LEGAL apply (the IDistributable
            # contract declares no return value) — count and ack it
            # exactly like the pre-demotion code did
            self.updates_applied += 1
            _registry.counter("server.updates_applied").inc()
            # a productive update resets the slave's respawn backoff
            self._respawn_attempts.pop(conn.slave.mid, None)
            self._send(conn.writer, {"type": "update_ack",
                                     "result": 1 if result else 0})
        if self._finishing:
            self._broadcast_stop()
            return
        # updates may unlock parked requesters (sync point release)
        if not self._paused:
            await self._release_parked()

    async def _release_parked(self):
        # one attempt per parked conn per pass: _serve_job may RE-park
        # the conn it was handed (speculation not yet eligible, or the
        # owner guard), and an unbounded `while self._waiting` would
        # pop the re-appended conn forever — a livelock that starves
        # the event loop of every other conn's frames (including the
        # very update whose apply would release the guard)
        for _ in range(len(self._waiting)):
            if self._paused:
                break
            parked = self._waiting.popleft()
            if parked.slave.id in self.slaves and parked.parked:
                parked.parked = False
                await self._serve_job(parked)

    async def _watchdog(self):
        """Adaptive per-slave job timeout -> drop + blacklist; also
        the periodic parked-requester retry."""
        while True:
            await asyncio.sleep(0.5)
            # clients park PASSIVELY on 'wait' (no re-poll: a client-
            # side poll double-serves against the update-driven
            # release and grows per-connection backlogs without
            # bound).  Updates release parked requesters immediately;
            # this tick covers the update-free cases — work freed by a
            # dropped slave's requeue and stragglers crossing the
            # speculation threshold
            if not self._paused:
                await self._release_parked()
            threshold = self._timeout_threshold()
            now = time.perf_counter()
            for conn in list(self.slaves.values()):
                overdue = [jid for jid, t0 in conn.jobs_out.items()
                           if now - t0 > threshold]
                if overdue:
                    self.warning(
                        "slave %s exceeded %.1fs timeout; dropping + "
                        "blacklisting for %.0fs", conn.slave.id[:8],
                        threshold, self.blacklist_ttl)
                    self._blacklist(conn.slave.mid)
                    self._drop(conn, "timeout")
                    try:
                        conn.writer.close()
                    except Exception:
                        pass

    def _timeout_threshold(self):
        # numpy is imported at module scope: this runs every 0.5 s on
        # the watchdog tick, and repeated `import` statements still pay
        # a sys.modules lookup + lock on a hot loop
        times = list(self._all_job_times)
        if len(times) < 4:
            return self.job_timeout
        arr = numpy.array(times)
        return max(float(arr.mean() + 3 * arr.std()), self.job_timeout)

    def _respawn_delay(self, mid):
        """Exponential backoff on THIS slave's consecutive respawns
        (reset by a productive update) — keying it on global blacklist
        size punished healthy slaves for unrelated machines' sins."""
        attempts = self._respawn_attempts.get(mid, 0) + 1
        self._respawn_attempts[mid] = attempts
        return min(2.0 ** attempts, 30.0)

    def _drop(self, conn, reason):
        if self.slaves.pop(conn.slave.id, None) is None:
            return
        conn.dropped = True
        self.fleet.leave(conn.slave.id)
        conn.close_shm()
        self.info("dropping slave %s (%s)", conn.slave.id[:8], reason)
        if self._applying.get(conn.slave.id):
            # drop-vs-apply race: an update that retires one of THIS
            # slave's reservations is mid-apply on the executor — its
            # own update, or a speculative backup's winning result
            # applying under this owner's reservation.  Requeueing now
            # would hand the applying job to another slave while its
            # update lands — the job both requeued AND applied.  Park
            # the requeue; the apply path finishes the drop the moment
            # the executor returns (stale rejection above already
            # fences any FURTHER frames from this conn).
            self.drops_deferred += 1
            _registry.counter("elastic.drops_deferred").inc()
            self.debug("deferring requeue for slave %s: an update is "
                       "mid-apply", conn.slave.id[:8])
            self._deferred_drops[conn.slave.id] = (conn, reason)
            return
        self._finish_drop(conn, reason)

    def _finish_drop(self, conn, reason):
        # retire this conn's job stamps: jobs it OWNED are requeued by
        # drop_slave below, so a backup copy's late result must drop
        # as a duplicate; jobs it merely backed keep the owner's copy
        for job_id, job in list(self._inflight.items()):
            job.copies.pop(conn.slave.id, None)
            if job.owner.id == conn.slave.id:
                del self._inflight[job_id]
        _registry.gauge("elastic.speculative_inflight").set(
            self._speculative_inflight())
        try:
            self.workflow.drop_slave(conn.slave)
        except Exception:
            self.exception("drop_slave failed")
        if not self._finishing:
            self._reshard("leave:" + reason)
        # the requeue may have freed work for parked requesters; with
        # passive clients nobody else would wake them until the next
        # update (which, with every other slave parked, never comes)
        if not self._paused:
            self._loop.call_soon_threadsafe(
                lambda: asyncio.ensure_future(self._release_parked()))
        if self.respawn_hook is not None and not self._finishing:
            delay = self._respawn_delay(conn.slave.mid)
            self._loop.call_later(
                delay, lambda: self.respawn_hook(conn.slave))

    # -- dynamic resharding -------------------------------------------------

    def _unserved_remainder(self):
        """How many work units of the current epoch are not yet
        APPLIED — the quantity a reshard repartitions.  Workflows may
        expose ``unserved_remainder()`` (the Workflow/Loader contract
        and the jobfarm adapter do); None = unknown, nothing to
        partition."""
        probe = getattr(self.workflow, "unserved_remainder", None)
        if probe is None:
            return None
        try:
            remaining = probe()
        except Exception:
            self.exception("unserved_remainder probe failed")
            return None
        return None if remaining is None else int(remaining)

    def _reshard(self, reason):
        """Membership changed: repartition the epoch's unserved
        remainder over the live fleet (power-weighted, exact largest-
        remainder split) and push each slave its new share, stamped
        with the membership epoch, so the fleet learns the split
        without restarting the run.

        The push is scheduled, not inline: the remainder probe is
        workflow code (the jobfarm adapter takes its master lock, user
        workflows run arbitrary counting), and this module's contract
        keeps workflow code off the event loop — a slow probe on every
        membership change would stall every connection.  Epoch and
        shares are read when the task runs, so back-to-back membership
        changes push the (identical) final split — idempotent for the
        absorbing client."""
        asyncio.ensure_future(self._do_reshard(reason))

    async def _do_reshard(self, reason):
        if self._finishing:
            return
        remaining = await self._in_thread(self._unserved_remainder)
        shares = self.fleet.shares(remaining)
        epoch = self.fleet.membership_epoch
        self.reshards += 1
        _registry.counter("elastic.reshards").inc()
        _registry.gauge("elastic.membership_epoch").set(epoch)
        _registry.gauge("elastic.fleet_live").set(len(self.fleet))
        _tracer.instant(
            "elastic.resharded", cat="elastic", reason=reason,
            epoch=epoch, fleet=len(self.fleet),
            remaining=-1 if remaining is None else remaining)
        self.info("resharded (%s): membership epoch %d, %d live, "
                  "remainder %s -> %s", reason, epoch, len(self.fleet),
                  remaining, {sid[:8]: n for sid, n in shares.items()}
                  or "n/a")
        for sid, member in list(self.slaves.items()):
            if chaos.plan is not None:
                fault = chaos.plan.fire("server.reshard")
                if fault is not None and fault.action == "kill":
                    # a slave vanishing DURING the reshard push: the
                    # kill-during-reshard case the exactly-once
                    # guarantee must survive (its work requeues, its
                    # late update is stale)
                    self.warning("fault injection: killing conn of "
                                 "slave %s mid-reshard", sid[:8])
                    try:
                        member.writer.close()
                    except Exception:
                        pass
                    continue
            member.share = shares.get(sid)
            msg = {"type": "reshard", "epoch": epoch,
                   "fleet": len(self.fleet)}
            # a master training on an elastic device mesh
            # (parallel.mesh.MeshManager) stamps its device-mesh epoch
            # so slaves can correlate membership churn with the
            # train-state reshard that followed it
            mesh_epoch = getattr(self.mesh_manager, "mesh_epoch", None)
            if mesh_epoch is not None:
                msg["mesh_epoch"] = mesh_epoch
            if member.share is not None:
                msg["share"] = member.share
            if remaining is not None:
                msg["remaining"] = remaining
            try:
                self._send(member.writer, msg)
            except Exception:
                pass
        hook = getattr(self.launcher, "on_fleet_change", None)
        if hook is not None:
            try:
                hook({"reason": reason, "epoch": epoch,
                      "live": len(self.fleet), "remaining": remaining})
            except Exception:
                self.exception("on_fleet_change hook failed")

    def _broadcast(self, msg):
        for conn in list(self.slaves.values()):
            try:
                self._send(conn.writer, msg)
            except Exception:
                pass

    def _broadcast_stop(self):
        self._broadcast({"type": "stop"})

    _NO_PAYLOAD = object()

    def _send(self, writer, msg, payload=_NO_PAYLOAD, conn=None):
        if payload is not Server._NO_PAYLOAD:
            msg = dict(msg, codec=self.codec)
            raw = pack_payload(payload, self.codec)
            if conn is not None and conn.shm_out is not None:
                desc = conn.shm_out.write(raw)
                if desc is not None:
                    msg["shm"] = list(desc)
                    self.shm_sends += 1
                    raw = b""
        else:
            raw = b""
        write_frame(writer, msg, raw, self.secret, peer="master")

    async def _in_thread(self, fn, *args):
        return await self._loop.run_in_executor(None, fn, *args)
