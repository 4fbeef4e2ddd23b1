"""Task farming over the master-slave control plane.

Counterpart of ``veles_tpu/jobfarm.py``, with its names and behaviour.
:class:`JobFarm` serves a list of picklable job specs through the
port's :class:`~veles_tpu_torch.server.Server` /
:class:`~veles_tpu_torch.client.Client` (checksum handshake, timeout
watchdog, drop and requeue, the shm bypass) and collects the results in
job order.  Its users are the GA's farmed evaluations
(:class:`~veles_tpu_torch.genetics.GeneticsOptimizer` and the schedule
tuner), and the ensembles' member trainings and evaluations
(:mod:`veles_tpu_torch.ensemble`).

One-shot::

    results = JobFarm("my-tag").run(jobs, runner=fn, local_slaves=4)

Persistent (a GA farms one batch a generation, and remote workers stay
connected between them)::

    farm = JobFarm("my-tag").start(runner=fn, local_slaves=4)
    for generation in ...:
        fits = farm.submit(specs)
    farm.shutdown()

``local_slaves`` starts in-process ``Client`` threads; a remote host runs
``JobFarm("my-tag").worker(address, fn)`` against the master's logged
address, and both mix.  An idle worker parks at the control plane's sync
point and the server pushes work to it: on an update, on ``submit()``
(which resumes parked workers) and on the watchdog tick that retries
requeued and speculative work.  The tag stands in for the trainer's
source checksum (``sha1("jobfarm:<tag>")``): master and workers quote
the same one.

- One batch at a time, every job stamped with the batch's epoch: a late
  duplicate of an earlier batch never lands in the current one.
- A job whose worker dies is requeued at the front (``drop_slave``).
- Once a job has run longer than ``speculation_factor`` x the mean
  completed-job time (power-corrected through
  ``elastic.speculation_threshold`` / ``fleet_mean_power``, with the
  ``min_speculation_s`` floor), an idle worker runs it again; the first
  result wins.
- ``context`` ships once a worker, at its handshake (the evaluation
  batch every ensemble-test job reads); the runner is then called as
  ``runner(spec, context)``.
- A runner's exception travels back as ``("err", repr)`` and fails the
  batch at collection with :class:`FarmJobError`, as does a batch
  ``timeout``: a dropped job would skew a GA's selection or an
  ensemble's vote unseen.
- Jobs are whole trainings, so the server's drop watchdog gets
  :data:`DEFAULT_JOB_TIMEOUT` (a week) instead of the trainer's 60 s.

The device.  A worker's handshake rates its computing power on its
device (the matmul kernel at 256 cubed on the card), and a runner trains
or times there.  ``device`` (a port ``Device``, ``"cuda"``, ``"cpu"``)
names it; by default it is ``-d`` / ``VELES_BACKEND``, else the card.
:meth:`JobFarm.start` with local workers and :meth:`JobFarm.worker`
resolve it before any socket opens, so without a card and without the
CPU asked for they raise ``no CUDA device``.  A worker holds
``graphs.shared()`` around its rating, and while a farm's local workers
run, ``graphs.card_shared()`` holds and their workflows hold it around
each unit: several workers of one process share a card with the
CUDA-graph captures of their jobs (``veles_tpu_torch/graphs.py``).
"""

import hashlib
import threading
import time
from collections import deque

from veles_tpu_torch import elastic, graphs
from veles_tpu_torch.logger import Logger

__all__ = ["JobFarm", "FarmJobError", "DEFAULT_JOB_TIMEOUT",
           "farm_enabled"]

#: farmed jobs are whole trainings of widely varying length; the
#: trainer plane's 60 s watchdog would drop (and blacklist) every worker
#: in the middle of a job
DEFAULT_JOB_TIMEOUT = 7 * 24 * 3600.0


class FarmJobError(RuntimeError):
    """One or more farmed jobs raised on their worker, or the batch
    timed out with jobs unfinished."""


_UNSET = object()


def farm_enabled(farm_slaves, farm_address):
    """The enablement rule of the farm's users: local workers asked for,
    or an explicit bind address (``"127.0.0.1:0"``, the default, means
    no farm; a remote-only setup passes a real address)."""
    return bool(farm_slaves) or farm_address != "127.0.0.1:0"


class _FarmMaster(object):
    """The workflow contract the Server drives on the master.

    Holds at most one active batch; ``reset(jobs)`` arms the next.  With
    no active batch every requester parks; the next ``submit()`` resumes
    them through the server's parked-requester release."""

    #: farm results are opaque payloads: the Server's all-or-nothing
    #: finiteness prewalk quarantines a worker whose result holds a NaN
    #: before ``results`` or the duration stats change
    update_validation = "prewalk"

    #: the adapter runs its own job stamps and backup copies (dedup by
    #: result slot, epoch stamps): the Server's speculation stays off,
    #: or a tail job could run three times
    owns_speculation = True

    def __init__(self, checksum, speculation_factor=2.0,
                 min_speculation_s=5.0, context=None):
        self.checksum = checksum
        self.speculation_factor = speculation_factor
        self.min_speculation_s = min_speculation_s
        self.context = context
        self._lock = threading.Lock()
        self._specs = []
        self._pending = deque()
        self._outstanding = {}      # job index -> {slave id: t0}
        self._powers = {}           # slave id -> reported power rating
        self._durations = deque(maxlen=200)
        self.epoch = 0              # batch counter; stamps every job
        self.results = []
        self._remaining = 0
        #: farm accounting: jobs served (copies included), requeues at
        #: a drop, speculative copies
        self.served = 0
        self.requeued = 0
        self.speculated = 0
        self.done = threading.Event()
        self.done.set()

    def reset(self, jobs):
        with self._lock:
            if not self.done.is_set():
                raise RuntimeError("previous batch still running")
            self.epoch += 1
            self._specs = list(jobs)
            self._pending = deque(enumerate(self._specs))
            self._outstanding = {}
            self.results = [_UNSET] * len(self._specs)
            self._remaining = len(self._specs)
            if self._specs:
                self.done.clear()

    # -- the Server's side of the workflow contract -------------------------

    def generate_initial_data_for_slave(self, slave):
        # the shared context ships once a worker, at its handshake
        if self.context is None:
            return None
        return ("ctx", self.context)

    def generate_data_for_slave(self, slave):
        with self._lock:
            self._powers[slave.id] = getattr(slave, "power", 1.0)
            if self._pending:
                i, spec = self._pending.popleft()
                # perf_counter: the stamps give job durations and the
                # speculation threshold; a wall-clock step would fake or
                # hide a straggler
                self._outstanding.setdefault(i, {})[slave.id] = \
                    time.perf_counter()
                self.served += 1
                return (self.epoch, i, spec)
            # nothing fresh: maybe shadow a straggler, once it has run
            # longer than the power-corrected threshold (never at once:
            # that would run every tail job twice)
            if not self._durations:
                return False
            mean = sum(self._durations) / len(self._durations)
            mean_power = elastic.fleet_mean_power(self._powers.values())
            now = time.perf_counter()
            for i, copies in self._outstanding.items():
                if slave.id in copies or self.results[i] is not _UNSET:
                    continue
                owner = min(copies, key=copies.get)
                threshold = elastic.speculation_threshold(
                    mean, self.speculation_factor, self.min_speculation_s,
                    owner_power=self._powers.get(owner),
                    mean_power=mean_power)
                if now - copies[owner] > threshold:
                    copies[slave.id] = now
                    self.served += 1
                    self.speculated += 1
                    return (self.epoch, i, self._specs[i])
            return False            # park until an update frees work

    def unserved_remainder(self):
        """The Server's reshard input: jobs of the current batch not yet
        resolved, pending or in flight."""
        with self._lock:
            return sum(1 for r in self.results if r is _UNSET)

    def apply_update_validated(self, update, slave):
        """The inline-validation form, for a farm that opts in
        (``update_validation = "inline"``): one opaque part, so
        validating then applying is already one traversal."""
        from veles_tpu_torch import health
        if not health.all_finite(update):
            raise health.PoisonedUpdate(self)
        return self.apply_data_from_slave(update, slave)

    def apply_data_from_slave(self, update, slave):
        epoch, i, result = update
        with self._lock:
            if epoch != self.epoch:
                # a late duplicate of an earlier batch (requeued or
                # speculated, and both copies reported)
                return True
            copies = self._outstanding.get(i)
            t0 = None
            if copies is not None and slave is not None:
                t0 = copies.pop(slave.id, None)
            if t0 is not None:
                self._durations.append(time.perf_counter() - t0)
            if self.results[i] is not _UNSET:
                return True         # a backup copy finished first
            self.results[i] = result
            self._outstanding.pop(i, None)
            self._remaining -= 1
            finished = self._remaining == 0
        if finished:
            self.done.set()
        return True

    def drop_slave(self, slave):
        with self._lock:
            # a departed member's rating leaves the fleet mean
            self._powers.pop(slave.id, None)
            for i in list(self._outstanding):
                copies = self._outstanding[i]
                copies.pop(slave.id, None)
                if not copies and self.results[i] is _UNSET:
                    # no other copy in flight: requeue at the front, so
                    # the oldest failure runs first
                    del self._outstanding[i]
                    self._pending.appendleft((i, self._specs[i]))
                    self.requeued += 1

    def apply_initial_data_from_master(self, data):  # pragma: no cover
        raise AssertionError("master adapter used as a slave")


class _FarmSlave(object):
    """The workflow contract the Client drives on a worker.

    With a context shipped by the master the runner is called as
    ``runner(spec, context)``, else ``runner(spec)``.  ``device`` is
    where the Client rates the worker at its handshake."""

    _NO_CTX = object()

    def __init__(self, checksum, runner, device=None):
        self.checksum = checksum
        self.runner = runner
        self.device = device
        self.context = self._NO_CTX

    def apply_initial_data_from_master(self, initial):
        if isinstance(initial, tuple) and len(initial) == 2 \
                and initial[0] == "ctx":
            self.context = initial[1]

    def do_job(self, data, update, callback):
        epoch, i, spec = data
        try:
            if self.context is self._NO_CTX:
                result = self.runner(spec)
            else:
                result = self.runner(spec, self.context)
            callback((epoch, i, ("ok", result)))
        except Exception as exc:  # travels back; the batch fails loudly
            callback((epoch, i, ("err", repr(exc))))


class JobFarm(Logger):
    """Farm independent picklable jobs across control-plane workers."""

    def __init__(self, tag, codec=None, speculation_factor=2.0,
                 min_speculation_s=5.0, context=None,
                 job_timeout=DEFAULT_JOB_TIMEOUT, device=None,
                 **server_kwargs):
        super(JobFarm, self).__init__()
        self.tag = tag
        self.codec = codec
        self.speculation_factor = speculation_factor
        self.min_speculation_s = min_speculation_s
        self.context = context
        self.job_timeout = job_timeout
        self.device = device
        self.server_kwargs = server_kwargs
        self.server = None
        self._master = None
        self._clients = []
        self._threads = []
        #: whether this farm's local workers hold graphs.begin_sharing()
        self._sharing = False
        #: the last started master's accounting, kept after shutdown
        self.stats = {}

    @property
    def checksum(self):
        """Stands in for the trainer's source checksum: master and
        workers agree on the job type, not on a workflow file."""
        return hashlib.sha1(
            ("jobfarm:%s" % self.tag).encode()).hexdigest()

    @property
    def address(self):
        """host:port remote workers join (once started)."""
        if self.server is None:
            return None
        return "%s:%d" % (self.server.host, self.server.port)

    def _worker_device(self):
        from veles_tpu_torch.launcher import _resolve_device
        return _resolve_device(self.device)

    # -- master side ------------------------------------------------------

    def start(self, runner=None, address="127.0.0.1:0", local_slaves=0):
        """Bind the farm master and start ``local_slaves`` in-process
        workers (``runner`` required then).  Remote workers can join
        ``self.address`` at any time.  Returns self."""
        from veles_tpu_torch.client import Client
        from veles_tpu_torch.server import Server

        if self.server is not None:
            raise RuntimeError("farm already started")
        if local_slaves and runner is None:
            raise ValueError("local_slaves > 0 requires a runner")
        # the workers' device first: no card (and no CPU asked for)
        # raises here, before any socket opens
        device = self._worker_device() if local_slaves else None
        self._master = _FarmMaster(self.checksum, self.speculation_factor,
                                   self.min_speculation_s,
                                   context=self.context)
        self.server = Server(address, self._master, codec=self.codec,
                             job_timeout=self.job_timeout,
                             **self.server_kwargs)
        self.server.start_background()
        if not self.server.wait_listening(10):
            exc = self.server.bind_error
            self.server = None
            raise RuntimeError(
                "farm master failed to bind %s: %r" % (address, exc))
        self.info("farm '%s' serving at %s (join remote workers with "
                  "JobFarm(%r).worker(%r, runner))",
                  self.tag, self.address, self.tag, self.address)
        if local_slaves:
            graphs.begin_sharing()
            self._sharing = True
        for _ in range(local_slaves):
            client = Client(self.address,
                            _FarmSlave(self.checksum, runner, device),
                            codec=self.codec)
            self._clients.append(client)
            self._threads.append(client.start_background())
        return self

    def submit(self, jobs, timeout=None):
        """Serve one batch until every result is in; return them in job
        order.  ``timeout`` (seconds) bounds the batch; on expiry a
        :class:`FarmJobError` names what was unfinished."""
        if self.server is None:
            raise RuntimeError("start() the farm first")
        jobs = list(jobs)
        if not jobs:
            return []
        master = self._master
        master.reset(jobs)
        # workers park between batches; release them
        self.server.resume()
        if not master.done.wait(timeout):
            missing = [i for i, r in enumerate(master.results)
                       if r is _UNSET]
            raise FarmJobError(
                "farm timed out after %ss with %d/%d jobs unfinished "
                "(indices %s)" % (timeout, len(missing), len(jobs),
                                  missing[:10]))
        errors = [(i, r[1]) for i, r in enumerate(master.results)
                  if r[0] == "err"]
        if errors:
            raise FarmJobError(
                "%d/%d farmed jobs raised on their workers: %s" % (
                    len(errors), len(jobs),
                    "; ".join("job %d: %s" % e for e in errors[:5])))
        return [r[1] for r in master.results]

    def shutdown(self):
        """Stop the master; local and remote workers leave their loops."""
        if self.server is None:
            return
        master = self._master
        self.stats = {"served": master.served,
                      "requeued": master.requeued,
                      "speculated": master.speculated,
                      "batches": master.epoch,
                      "power_ratings": sorted(
                          c.power_rating for c in self._clients
                          if c.power_rating is not None)}
        self.server.stop()
        self.server._done.wait(10)
        for thread in self._threads:
            thread.join(10)
        self.server = None
        self._master = None
        self._clients = []
        self._threads = []
        if self._sharing:
            self._sharing = False
            graphs.end_sharing()

    def run(self, jobs, runner=None, address="127.0.0.1:0",
            local_slaves=0, timeout=None, on_listening=None):
        """One shot: start, submit, shutdown.  ``on_listening``, when
        given, receives the bound Server before jobs are served (to start
        workers against its port)."""
        self.start(runner=runner, address=address,
                   local_slaves=local_slaves)
        try:
            if on_listening is not None:
                on_listening(self.server)
            return self.submit(jobs, timeout=timeout)
        finally:
            self.shutdown()

    # -- worker side ------------------------------------------------------

    def worker(self, address, runner, **client_kwargs):
        """Blocking worker loop for a remote host: run farmed jobs until
        the master shuts down.  Quote the master's tag.  Returns the
        number of jobs done."""
        from veles_tpu_torch.client import Client

        device = self._worker_device()  # raises before any socket
        client = Client(address, _FarmSlave(self.checksum, runner, device),
                        codec=self.codec, **client_kwargs)
        client.run()
        return client.jobs_done
