"""Continuous-batching request queue over the engine.

Counterpart of ``veles_tpu/serve/batcher.py``.  One worker thread drains
pending requests into the largest fitting ladder rung: the first request
of a batch waits at most ``max_delay_s`` for company, the tail is
zero-padded up to the rung, and the output rows go back to their
requests as views of the batch's one host copy.  On the card the worker
dispatches on a CUDA stream of its own (two replicas on one card
overlap) and holds ``graphs.shared()`` from the copy in to the copy out,
so a capture on another thread (a reload's new engine) pauses it
instead of breaking.

Overload: past ``max_queue`` pending requests :meth:`submit` raises
:class:`ServeOverload` carrying a ``retry_after`` estimate; the HTTP
front turns it into ``503 {"retry_after": ...}``.

Multi-tenant QoS: every request carries an SLO class (``interactive`` /
``batch`` / ``best_effort``; unlabelled traffic is ``batch``) and a full
queue evicts a pending request of a strictly lower class (the shed
counted against the victim's class, with a seeded per-class jittered
``retry_after``) before it sheds the incoming one.

Shadow traffic (:meth:`submit_shadow`, the canary mirror) is served like
any request but kept out of the served counters and the SLO window.

Degradation: an out-of-memory engine failure
(``torch.cuda.OutOfMemoryError``, ``MemoryError``) caps the ladder below
the failing rung for good and replays the batch in capped chunks:
slower, not dead.  A capture that fails that way has closed its capture
before the error reaches here (``graphs.GraphOwner``).  Other engine
failures fail only that batch's requests and keep the worker alive.

Hot swap (:meth:`swap_engine`): a new engine is adopted between
batches, so no batch is torn across engines and no queued request is
dropped.

SLO watch: each request's end-to-end latency feeds ``serve.latency_s``;
every ``slo_check_every`` batches the window's p50/p99 are compared with
the thresholds and each breach bumps ``serve.slo_violations``.

Chaos points: ``serve.drop`` (submit-side shed), ``serve.tenant.flood``
(``param`` synthetic best_effort requests), ``serve.stall`` (the worker
sleeps ``param`` s before a batch), ``serve.device.stall`` (the sleep
lands at the dispatch), ``serve.oom`` (a simulated out-of-memory at the
dispatch: the degrade path).

Request tracing: while ``VELES_REQTRACE`` is on, the worker stamps each
request's segment timeline (queue / assemble / h2d / device / d2h) on
the request before ``done.set()``, feeds the tail-exemplar ring, and
emits request-track spans for sampled ids; an SLO-breach entering edge
dumps the exemplar ring with the flight recorder.  The marks are host
time and add no synchronization: on the card the copy in, the replay
and the copy back are one stream's work that the host sees end only at
the copy back, so the device segment runs from the dispatch to the
copy back's return and holds all three; h2d is empty and d2h is the
host's own wrap of the block.  The tracer's ``serve.batch`` spans and
``serve.shed`` / ``serve.degrade`` / ``serve.reload.cutover`` /
``serve.slo_violation`` instants bracket the same host calls as the
JAX package's.

Worker spans, while the tracer or a ``torch.profiler`` records
(:attr:`~veles_tpu_torch.observe.trace.SpanTracer.live`): each pass of
the worker's loop is covered by ``serve.idle`` (blocked in the queue
with nothing pending), ``serve.collect`` (from claiming a batch's
first request to closing the batch: the batching delay waited) and
the ``serve.batch`` span, the parent of ``serve.assemble`` (staging
and padding), the engine's ``serve.h2d`` and ``serve.launch``,
``serve.d2h`` (the wait for the copy back) and ``serve.answer``
(fan-out, histograms, the SLO watch).  Each span begins at the reading
that ended the one before it on the worker, so a pass's bookkeeping
between them lands in the next one (the call into the engine in
``serve.h2d``).  A batch's spans and its sampled requests' spans carry
its sequence number (``seq``).  The request marks keep their extents,
and the dispatch's spans are recorded only once its requests are
answered, so recording them costs the marks and the answers nothing.  The
``serve.batch`` span runs from the end of its collect (the batch's
start where no collect is recorded) to the end of its answers, live or
flight-only.  With both off, each site costs one check.
"""

import collections
import queue
import threading
import time

import numpy
import torch

from veles_tpu_torch import chaos, graphs
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.observe import requests as reqtrace
from veles_tpu_torch.observe.metrics import percentiles
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.serve import qos

__all__ = ["ContinuousBatcher", "ServeOverload", "serve_snapshot"]


class ServeOverload(Exception):
    """Load shed: the queue is full (or chaos dropped the request).
    ``retry_after`` (seconds) marks the rejection transient."""

    def __init__(self, message, retry_after=0.1):
        super(ServeOverload, self).__init__(message)
        self.retry_after = float(retry_after)


class _Request(object):
    __slots__ = ("sample", "enqueued", "done", "result", "error",
                 "cancelled", "block", "shadow", "latency", "slo_class",
                 "claimed", "trace", "marks", "child")

    def __init__(self, sample, block=False, shadow=False,
                 slo_class=None, trace=None):
        self.sample = sample
        #: canonical SLO class: the shed order and the
        #: serve.tenant.<class>.* series
        self.slo_class = qos.normalize_class(slo_class)
        #: request trace id (observe/requests.py): rides the request
        #: through requeue, hedge and chunked replay unchanged
        self.trace = trace
        #: segment timeline [(segment, start_perf, dur_s)] stamped by the
        #: worker before done.set(), so a transport waiter can echo it;
        #: None while VELES_REQTRACE is off
        self.marks = None
        #: a capped-ladder slice of a block request
        self.child = False
        self.enqueued = time.perf_counter()
        self.done = threading.Event()
        self.result = None
        self.error = None
        #: set by a caller that gave up on the request (a payload shed
        #: partway through submission, an eviction); the worker drops it
        self.cancelled = False
        #: a whole (n,) + sample_shape batch from :meth:`submit_block`
        self.block = block
        #: canary-mirror shadow: served, never counted as served
        self.shadow = shadow
        #: end-to-end seconds, stamped by the worker at completion
        self.latency = None
        #: set by the worker when it dequeues the request: eviction only
        #: cancels work still waiting
        self.claimed = False

    @property
    def rows(self):
        return self.sample.shape[0] if self.block else 1


def _oom_shaped(exc):
    return isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)) \
        or "out of memory" in str(exc).lower()


class ContinuousBatcher(Logger):
    """Worker thread turning a request stream into padded-rung batches.

    ``max_delay_s`` bounds how long the oldest request of a forming
    batch waits for more arrivals; ``max_queue`` bounds the pending
    requests before :meth:`submit` sheds; ``slo_p50_ms`` /
    ``slo_p99_ms`` arm the SLO watch (None disables a threshold);
    ``replica`` scopes the gauges inside a ``ReplicaPool``."""

    def __init__(self, engine, max_delay_s=0.002, max_queue=256,
                 slo_p50_ms=None, slo_p99_ms=None, slo_check_every=4,
                 replica=None, retry_jitter=None, **kwargs):
        super(ContinuousBatcher, self).__init__(**kwargs)
        self.engine = engine
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)
        #: seeded per-class retry_after jitter: clients shed together
        #: must not come back together
        self.retry_jitter = retry_jitter if retry_jitter is not None \
            else qos.RetryJitter()
        #: pending requests a higher class may evict; interactive is
        #: never evicted (qos.SHED_ORDER)
        self._evictable = {cls: collections.deque()
                           for cls in qos.SHED_ORDER
                           if cls != "interactive"}
        self.slo_p50_ms = slo_p50_ms
        self.slo_p99_ms = slo_p99_ms
        self.slo_check_every = max(1, int(slo_check_every))
        self.replica = replica
        #: fleet host identity (``set_host_tag``, from the transport's
        #: host_meta): request spans carry it as the leg attribution
        self.host_tag = None
        self._q = queue.Queue()
        self._thread = None
        self._stop_ = False
        self._rung_cap = engine.max_batch
        self._stage = {}      # rung -> host staging buffer
        self._carry = None    # popped request that overflowed a batch
        self._pending_engine = None
        self._stream = None   # the worker's CUDA stream (on the card)
        self._batches_since_check = 0
        self._slo_breached = False
        #: the sequence number of the batch being formed, advanced only
        #: while spans are recorded
        self._batch_seq = 0
        #: rung of each of the last 4,096 batches, in order
        self.rungs = collections.deque(maxlen=4096)
        scope = "serve" if replica is None else \
            "serve.replica.%d" % replica
        self._m_depth = _registry.gauge(scope + ".queue_depth")
        self._g_rung_cap = _registry.gauge(scope + ".rung_cap")
        self._m_batch = _registry.histogram("serve.batch_size")
        self._m_latency = _registry.histogram("serve.latency_s")
        self._m_requests = _registry.counter("serve.requests")
        self._m_batches = _registry.counter("serve.batches")
        self._m_padded = _registry.counter("serve.padded_rows")
        self._m_shed = _registry.counter("serve.shed")
        self._m_errors = _registry.counter("serve.errors")
        self._m_slo = _registry.counter("serve.slo_violations")
        self._m_depth.set(0)
        # per-segment latency histograms (observe/requests.py taxonomy),
        # fed only while request tracing is on; queue per request, the
        # rest per batch
        self._h_seg = {
            name: _registry.histogram("serve.segment.%s_s" % name)
            for name in ("queue", "assemble", "h2d", "device", "d2h")}
        #: this batcher's own served rows, batches, padded rows, shed
        #: requests and errors (the registry's counters are shared by
        #: every batcher of the process)
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                      "shed": 0, "errors": 0}
        self._stats_lock = threading.Lock()

    def set_host_tag(self, tag):
        """Name the fleet host this batcher serves (the transport's
        ``host_meta``); request spans carry it as the leg attribution."""
        self.host_tag = tag

    # -- lifecycle ----------------------------------------------------------

    @property
    def running(self):
        return self._thread is not None

    def start(self):
        if self._thread is not None:
            return self
        self._stop_ = False
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher")
        self._thread.start()
        return self

    def stop(self):
        """Stop the worker and join it; pending requests fail with
        :class:`ServeOverload` so no caller blocks on a dead queue."""
        self._stop_ = True
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
        carry, self._carry = self._carry, None
        while True:
            if carry is not None:
                req, carry = carry, None
            else:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
            if not req.done.is_set():
                req.error = ServeOverload("server shutting down",
                                          retry_after=1.0)
                req.done.set()
        self._m_depth.set(0)

    # -- hot reload ---------------------------------------------------------

    def swap_engine(self, engine):
        """Queue an engine cutover (a reload with a new digest): the
        worker applies it between batches, so no batch is torn across
        engines and no queued request is dropped.  Same-digest reloads
        never come here: ``AOTEngine.swap_params`` copies the weights
        in place with no new capture."""
        if engine.compile_receipt is None:
            raise RuntimeError(
                "swap_engine needs a compiled engine (warm the ladder "
                "before the cutover, off the serving path)")
        if self._thread is None:
            self._apply_engine(engine)  # stopped: no batch to tear
        else:
            self._pending_engine = engine

    def _apply_engine(self, engine):
        """Worker-side half of :meth:`swap_engine` (between batches)."""
        self._pending_engine = None
        old = self.engine
        self.engine = engine
        # staging buffers follow the old engine's sample shape and dtype;
        # the new model's memory behavior is its own: lift an OOM cap
        self._stage.clear()
        self._rung_cap = engine.max_batch
        self._g_rung_cap.set(engine.max_batch)
        if _tracer.active:
            _tracer.instant(
                "serve.reload.cutover", cat="serve",
                replica=self.replica if self.replica is not None else 0,
                old_digest=old.digest, new_digest=engine.digest)
        self.info("engine cutover: %s -> %s", old.digest, engine.digest)

    # -- submit side --------------------------------------------------------

    def _retry_after(self):
        """Seconds until the queue has likely drained at the recent
        per-request pace, bounded to [0.05, 5]."""
        window = self._m_latency.window_values()
        p50 = percentiles(window, ps=(50,)).get("p50") if window else None
        per_batch = p50 if p50 else 0.05
        depth = self._q.qsize()
        return min(5.0, max(0.05, per_batch * (
            1 + depth / float(self.engine.max_batch))))

    def _count_shed(self, slo_class):
        self._m_shed.inc()
        with self._stats_lock:  # submitters shed on their own threads
            self.stats["shed"] += 1
        qos.note_shed(slo_class)

    def _shed(self, slo_class, message):
        """Count one shed against ``slo_class`` and raise the overload
        with the class-jittered ``retry_after``."""
        self._count_shed(slo_class)
        retry = self.retry_jitter.apply(self._retry_after(), slo_class)
        if _tracer.active:
            _tracer.instant("serve.shed", cat="serve",
                            depth=self._q.qsize(), slo_class=slo_class,
                            retry_after=round(retry, 4))
        raise ServeOverload(message, retry_after=retry)

    def _evict_lower(self, incoming_cls):
        """Cancel one pending request of a strictly lower class than
        ``incoming_cls``, the shed counted against the victim's class.
        False when none is pending: the incoming request is shed."""
        incoming_rank = qos.class_rank(incoming_cls)
        for victim_cls in qos.SHED_ORDER:
            if qos.class_rank(victim_cls) >= incoming_rank:
                return False
            dq = self._evictable[victim_cls]
            while True:
                try:
                    victim = dq.popleft()
                except IndexError:
                    break
                if victim.cancelled or victim.claimed or \
                        victim.done.is_set():
                    continue  # served, being served, or evicted
                victim.cancelled = True
                victim.error = ServeOverload(
                    "shed for %s admission (class-ordered eviction)"
                    % incoming_cls,
                    retry_after=self.retry_jitter.apply(
                        self._retry_after(), victim_cls))
                self._count_shed(victim_cls)
                if _tracer.active:
                    _tracer.instant("serve.shed", cat="serve",
                                    depth=self._q.qsize(),
                                    slo_class=victim_cls,
                                    evicted_for=incoming_cls)
                victim.done.set()
                return True
        return False

    def _flood(self, count):
        """Chaos ``serve.tenant.flood``: ``count`` synthetic zero-sample
        best_effort requests as real load (nobody waits for them)."""
        zero = numpy.zeros(self.engine.sample_shape, self.engine.dtype)
        for _ in range(count):
            if self._q.qsize() >= self.max_queue:
                self._count_shed("best_effort")
                continue
            try:
                self._enqueue(_Request(zero, slo_class="best_effort"))
            except ServeOverload:
                break  # racing a stop(): the storm dies with the queue

    def _admit(self, slo_class=qos.DEFAULT_CLASS):
        """Admission control: running check, chaos shed, class-aware
        queue bound.  Raises :class:`ServeOverload` to shed."""
        if self._thread is None or self._stop_:
            raise ServeOverload("batcher not running", retry_after=1.0)
        if chaos.plan is not None:
            fault = chaos.plan.fire("serve.tenant.flood")
            if fault is not None:
                self._flood(int(fault.param) if fault.param else 32)
            fault = chaos.plan.fire("serve.drop")
            if fault is not None:
                self._count_shed(slo_class)
                raise ServeOverload(
                    "chaos: request dropped",
                    retry_after=self.retry_jitter.apply(
                        self._retry_after(), slo_class))
        if self._q.qsize() >= self.max_queue and \
                not self._evict_lower(slo_class):
            self._shed(slo_class,
                       "queue full (%d pending)" % self._q.qsize())

    def _enqueue(self, req):
        self._q.put(req)
        if not req.shadow and req.slo_class in self._evictable:
            dq = self._evictable[req.slo_class]
            dq.append(req)
            if len(dq) > 2 * self.max_queue:
                # drop served and evicted entries
                live = [r for r in dq
                        if not r.cancelled and not r.done.is_set()]
                dq.clear()
                dq.extend(live)
        if self._stop_:
            # lost the race with stop(): its drain may have run already
            req.error = ServeOverload("server shutting down",
                                      retry_after=1.0)
            req.done.set()
            raise req.error
        self._m_depth.set(self._q.qsize())
        return req

    def _sample(self, sample):
        sample = numpy.ascontiguousarray(sample, self.engine.dtype)
        if sample.shape != self.engine.sample_shape:
            raise ValueError("expected sample shape %s, got %s" %
                             (self.engine.sample_shape, sample.shape))
        return sample

    def submit(self, sample, slo_class=None, trace=None):
        """Enqueue one sample; returns the pending request.  Raises
        :class:`ServeOverload` when shedding.  ``slo_class`` labels the
        request for the QoS layer (unlabelled: ``batch``)."""
        slo_class = qos.normalize_class(slo_class)
        self._admit(slo_class)
        return self._enqueue(_Request(self._sample(sample),
                                      slo_class=slo_class, trace=trace))

    def submit_block(self, block, slo_class=None, trace=None):
        """Enqueue a (n,) + sample_shape batch as one request whose
        result is the (n, ...) output block.  A contiguous block of the
        engine's dtype is not copied: filling a rung by itself it goes
        to the engine as it is, and co-batched it is one slice-assign
        into the staging buffer."""
        slo_class = qos.normalize_class(slo_class)
        self._admit(slo_class)
        block = numpy.asarray(block)
        if block.dtype != self.engine.dtype or \
                not block.flags["C_CONTIGUOUS"]:
            block = numpy.ascontiguousarray(block, self.engine.dtype)
        if block.ndim != len(self.engine.sample_shape) + 1 or \
                block.shape[1:] != self.engine.sample_shape:
            raise ValueError("expected a (n,) + %s block, got %s" %
                             (self.engine.sample_shape, block.shape))
        if not 1 <= block.shape[0] <= self.engine.max_batch:
            raise ValueError(
                "block of %d rows overflows the ladder (max %d); "
                "chunk at the caller" %
                (block.shape[0], self.engine.max_batch))
        return self._enqueue(_Request(block, block=True,
                                      slo_class=slo_class, trace=trace))

    def submit_shadow(self, sample, trace=None):
        """Best-effort enqueue of a canary-mirror shadow copy: never
        raises :class:`ServeOverload` (a loaded canary mirrors less) and
        returns None when dropped.  Shadows co-batch like real requests
        but stay out of the served counters and the shed count."""
        if self._thread is None or self._stop_ or \
                self._q.qsize() >= self.max_queue:
            return None
        sample = self._sample(sample)
        try:
            return self._enqueue(_Request(sample, shadow=True,
                                          trace=trace))
        except ServeOverload:
            return None  # lost the race with stop()

    def infer(self, sample, timeout=30.0):
        """Blocking submit: returns the output row (numpy) or raises
        the request's error."""
        req = self.submit(sample)
        if not req.done.wait(timeout):
            raise TimeoutError("inference timed out after %.1fs"
                               % timeout)
        if req.error is not None:
            raise req.error
        return req.result

    # -- worker side --------------------------------------------------------

    def _loop(self):
        while not self._stop_:
            pending = self._pending_engine
            if pending is not None:
                self._apply_engine(pending)
            first, self._carry = self._carry, None
            # the pass's spans share their boundary readings
            mark = time.perf_counter() if _tracer.live else None
            if first is None:
                try:
                    first = self._q.get(timeout=0.2)
                except queue.Empty:
                    if mark is not None:
                        _tracer.complete("serve.idle", mark,
                                         time.perf_counter() - mark,
                                         cat="serve")
                    continue
                if mark is not None:
                    got = time.perf_counter()
                    _tracer.complete("serve.idle", mark, got - mark,
                                     cat="serve")
                    mark = got
            first.claimed = True
            if first.cancelled:
                self._m_depth.set(self._q.qsize())
                continue
            batch = self._collect(first)
            if mark is not None:
                self._batch_seq += 1
                closed = time.perf_counter()
                _tracer.complete("serve.collect", mark, closed - mark,
                                 cat="serve", args={"requests": len(batch)},
                                 seq=self._batch_seq)
                mark = closed
            self._m_depth.set(self._q.qsize())
            try:
                self._run_batch(batch, since=mark)
            except Exception as exc:  # never kill the worker
                self._m_errors.inc()
                self.stats["errors"] += 1
                self.exception("serve batch failed")
                for req in batch:
                    if not req.done.is_set():
                        req.error = exc
                        req.done.set()

    def _collect(self, first):
        """Grow a batch around the oldest pending request, in rows, up
        to the (capped) top rung, waiting out what is left of
        ``max_delay_s``; a request that would overflow becomes the head
        of the next batch."""
        batch = [first]
        rows = first.rows
        limit = min(self._rung_cap, self.engine.max_batch)
        deadline = first.enqueued + self.max_delay_s
        while rows < limit and not self._stop_:
            remaining = deadline - time.perf_counter()
            try:
                if remaining <= 0:
                    req = self._q.get_nowait()
                else:
                    req = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            req.claimed = True
            if req.cancelled:
                continue  # evicted while queued
            if rows + req.rows > limit:
                self._carry = req
                break
            batch.append(req)
            rows += req.rows
        return batch

    def _staging(self, rung):
        mem = self._stage.get(rung)
        if mem is None:
            mem = self._stage[rung] = numpy.zeros(
                (rung,) + self.engine.sample_shape, self.engine.dtype)
        return mem

    def _dispatch(self, batch, rung, split=None):
        """The batch's host rows through the engine at ``rung`` -> the
        output block on the host (the batch's one host sync) and the
        host time the copy back returned (the end of the device
        segment).  ``split``: a list for the engine's readings at the
        ends of its copy in and of its launch
        (:meth:`~veles_tpu_torch.serve.engine.AOTEngine.run_host`)."""
        if chaos.plan is not None:
            fault = chaos.plan.fire("serve.device.stall")
            if fault is not None:
                time.sleep(fault.param if fault.param else 0.05)
            fault = chaos.plan.fire("serve.oom")
            if fault is not None:
                raise MemoryError(
                    "out of memory: chaos serve.oom (rung %d)" % rung)
        engine = self.engine
        # the two-argument call unless a span asks for the readings
        args = (batch, rung) if split is None else (batch, rung, split)
        if engine.device.torch_device.type != "cuda":
            out = engine.run_host(*args)
            return out.numpy(), time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(engine.device.torch_device)
        # copied into the rung's static input before run_host returns,
        # so the staging buffer is free on return
        with graphs.shared(), torch.cuda.stream(self._stream):
            out = engine.run_host(*args).cpu()
        return out.numpy(), time.perf_counter()

    @staticmethod
    def _note_dispatch(began, t_dev, split, t_d2h):
        """The dispatch's spans: ``serve.assemble`` from ``began``,
        ``serve.h2d`` and ``serve.launch`` to the engine's two readings
        in ``split``, ``serve.d2h`` to ``t_d2h``."""
        staged, launched = split
        for name, lo, hi in (("serve.assemble", began, t_dev),
                             ("serve.h2d", t_dev, staged),
                             ("serve.launch", staged, launched),
                             ("serve.d2h", launched, t_d2h)):
            _tracer.complete(name, lo, hi - lo, cat="serve")

    def _run_batch(self, batch, since=None):
        """Dispatch ``batch`` and answer its requests; ``since``: where
        its ``serve.batch`` span begins (the end of its collect)."""
        if chaos.plan is not None:
            fault = chaos.plan.fire("serve.stall")
            if fault is not None:
                time.sleep(fault.param if fault.param else 0.05)
        batch = [req for req in batch if not req.cancelled]
        if not batch:
            return
        n = sum(req.rows for req in batch)
        rung = self.engine.rung_for(n, cap=self._rung_cap)
        if n > rung:  # capped ladder (after an OOM): chunk by rows
            self._run_chunked(batch, rung)
            return
        start = time.perf_counter()
        args = {"n": n, "rung": rung}
        if self.replica is not None:
            args["replica"] = self.replica
        # flight-only while only the ring is on, null while both are off
        span = _tracer.open("serve.batch", start if since is None
                            else since, cat="serve", args=args,
                            seq=self._batch_seq)
        try:
            self._serve(batch, n, rung, start, span)
        finally:
            span.close()

    def _serve(self, batch, n, rung, start, span):
        """The rest of :meth:`_run_batch` from ``start``, inside the
        batch's open ``span``."""
        if len(batch) == 1 and batch[0].block and batch[0].rows == rung:
            rows = batch[0].sample  # fills the rung: no staging copy
        else:
            rows = self._staging(rung)
            off = 0
            for req in batch:
                if req.block:
                    rows[off:off + req.rows] = req.sample
                else:
                    rows[off] = req.sample
                off += req.rows
            if n < rung:
                # deterministic padding: the bit-equality contract
                rows[n:] = 0
                self._m_padded.inc(rung - n)
                self.stats["padded_rows"] += rung - n
        t_dev = time.perf_counter()
        split = [] if span.live else None
        try:
            host, t_d2h = self._dispatch(rows, rung, split)
        except Exception as exc:
            self._degrade_or_fail(batch, rung, exc)
            return
        done = time.perf_counter()
        self._m_batches.inc()
        self.stats["batches"] += 1
        self.rungs.append(rung)
        # served accounting excludes shadow (canary-mirror) rows
        served = sum(req.rows for req in batch if not req.shadow)
        if served:
            self._m_requests.inc(served)
            self.stats["requests"] += served
        self._m_batch.observe(n)
        stamps = reqtrace.enabled
        if stamps:
            # per-batch segment histograms (serve_snapshot "segments");
            # queue is per request, observed in _note_request
            self._h_seg["assemble"].observe(t_dev - start)
            self._h_seg["h2d"].observe(0.0)
            self._h_seg["device"].observe(t_d2h - t_dev)
            self._h_seg["d2h"].observe(done - t_d2h)
        seq = self._batch_seq if span.live else None
        off = 0
        for req in batch:
            # views of the batch's one host block: nothing overwrites it
            req.result = host[off:off + req.rows] if req.block \
                else host[off]
            off += req.rows
            req.latency = done - req.enqueued
            if stamps:
                # the marks land before done.set(): a transport waiter
                # echoes them over the wire when it wakes
                self._note_request(req, start, t_dev, t_dev, t_d2h, done,
                                   rung, seq)
            if not req.shadow:
                self._m_latency.observe(req.latency)
                qos.note_request(req.slo_class, req.rows)
                qos.note_latency(req.slo_class, req.latency)
            req.done.set()
        if split:
            self._note_dispatch(span.start, t_dev, split, t_d2h)
        self._batches_since_check += 1
        if self._batches_since_check >= self.slo_check_every:
            self._batches_since_check = 0
            self._check_slo()
        if span.live:
            end = time.perf_counter()
            _tracer.complete("serve.answer", t_d2h, end - t_d2h,
                             cat="serve")
            span.close(end)

    def _note_request(self, req, start, t_h2d, t_dev, t_d2h, done,
                      rung, seq=None):
        """Stamp one completed request's segment timeline (observe/
        requests.py taxonomy), feed the tail-exemplar ring, and emit
        request-track spans when the request is sampled."""
        queue_wait = start - req.enqueued
        marks = [("queue", req.enqueued, queue_wait),
                 ("assemble", start, t_h2d - start),
                 ("h2d", t_h2d, t_dev - t_h2d),
                 ("device", t_dev, t_d2h - t_dev),
                 ("d2h", t_d2h, done - t_d2h)]
        if req.marks:
            # a front (HTTP admit, transport wire_rx) stamped marks
            # before the queue segment began: keep them at the head
            marks = list(req.marks) + marks
        req.marks = marks
        if req.child:
            return  # the sliced parent reports for the whole request
        self._h_seg["queue"].observe(queue_wait)
        self._emit_request(req, done, rung=rung, seq=seq)

    def _emit_request(self, req, done, rung=None, seq=None):
        reqtrace.exemplars.note(
            req.trace, req.latency, marks=req.marks or (),
            t0=req.enqueued, slo_class=req.slo_class,
            budget_s=qos.slo_budget_s(req.slo_class), kind="host",
            shadow=req.shadow)
        if req.trace and _tracer.active and reqtrace.sampled(req.trace):
            args = {"slo_class": req.slo_class, "tier": "host",
                    "rows": req.rows}
            if rung is not None:
                args["rung"] = rung
            if self.host_tag:
                args["host"] = self.host_tag
            if self.replica is not None:
                args["replica"] = self.replica
            if req.shadow:
                args["shadow"] = True
            if seq is not None:
                args["seq"] = seq  # the batch that served it
            reqtrace.emit_spans(_tracer, req.trace, req.enqueued,
                                done, req.marks or (), args=args)

    def _run_chunked(self, batch, rung):
        """Replay a too-large batch within a capped rung: requests are
        regrouped by rows; a block wider than the cap is sliced into
        view sub-requests and its result reassembled."""
        chunk, rows = [], 0
        for req in batch:
            if req.rows > rung:
                if chunk:
                    self._run_batch(chunk)
                    chunk, rows = [], 0
                self._run_block_sliced(req, rung)
                continue
            if rows + req.rows > rung:
                self._run_batch(chunk)
                chunk, rows = [], 0
            chunk.append(req)
            rows += req.rows
        if chunk:
            self._run_batch(chunk)

    def _run_block_sliced(self, req, cap):
        children = []
        for i in range(0, req.rows, cap):
            child = _Request(req.sample[i:i + cap], block=True,
                             shadow=req.shadow, slo_class=req.slo_class,
                             trace=req.trace)
            child.enqueued = req.enqueued
            child.child = True
            children.append(child)
        for child in children:
            self._run_batch([child])
        errors = [c.error for c in children if c.error is not None]
        if errors:
            req.error = errors[0]
        else:
            req.result = numpy.concatenate([c.result for c in children])
        done = time.perf_counter()
        req.latency = done - req.enqueued
        if reqtrace.enabled and not errors:
            # the parent's timeline is the chunk sequence: only the first
            # chunk's queue mark (later ones would overlap the earlier
            # chunks on the request track)
            marks = []
            for index, child in enumerate(children):
                for mark in (child.marks or ()):
                    if index and mark[0] == "queue":
                        continue
                    marks.append(mark)
            req.marks = marks
            self._emit_request(req, done)
        req.done.set()

    def _degrade_or_fail(self, batch, rung, exc):
        self._m_errors.inc()
        self.stats["errors"] += 1
        if _oom_shaped(exc) and rung > self.engine.ladder[0]:
            # a permanent cap below the failing rung, the batch replayed
            # in chunks: slower beats dead
            smaller = [r for r in self.engine.ladder if r < rung]
            self._rung_cap = smaller[-1]
            self._g_rung_cap.set(self._rung_cap)
            self.warning(
                "engine out of memory at rung %d (%s); capping the "
                "ladder at %d and replaying", rung, exc, self._rung_cap)
            if _tracer.active:
                _tracer.instant("serve.degrade", cat="serve",
                                rung=rung, cap=self._rung_cap)
            self._run_batch(batch)
            return
        self.error("engine failure at rung %d: %s", rung, exc)
        for req in batch:
            req.error = exc
            req.done.set()

    def _check_slo(self):
        if self.slo_p50_ms is None and self.slo_p99_ms is None:
            return
        window = self._m_latency.window_values()
        if not window:
            return
        ps = percentiles(window, ps=(50, 99))
        p50_ms = ps["p50"] * 1e3
        p99_ms = ps["p99"] * 1e3
        breaches = []
        if self.slo_p50_ms is not None and p50_ms > self.slo_p50_ms:
            breaches.append(("p50", p50_ms, self.slo_p50_ms))
        if self.slo_p99_ms is not None and p99_ms > self.slo_p99_ms:
            breaches.append(("p99", p99_ms, self.slo_p99_ms))
        for which, measured, budget in breaches:
            self._m_slo.inc()
            # the instant goes to the trace and the always-on flight
            # ring, so a dump carries the breach beside its batches
            _tracer.instant(
                "serve.slo_violation", cat="serve", slo=which,
                measured_ms=round(measured, 3),
                budget_ms=round(budget, 3))
        if breaches and not self._slo_breached:
            # log the entering edge only: a sustained breach must not
            # flood the log at batch rate
            self.warning("SLO violation began: %s", "; ".join(
                "%s %.2fms > %.2fms budget" % b for b in breaches))
            if reqtrace.enabled:
                # the flight dump of this violation carries the tail
                # exemplars: the offending requests' whole timelines
                reqtrace.exemplars.dump("serve.slo_violation")
        elif self._slo_breached and not breaches:
            self.info("SLO recovered (window p50 %.2fms p99 %.2fms)",
                      p50_ms, p99_ms)
        self._slo_breached = bool(breaches)


#: (registry name, short name) of the serve health block
_SNAPSHOT_KEYS = (
    ("serve.queue_depth", "queue_depth"),
    ("serve.slo_violations", "slo_violations"),
    ("serve.requests", "requests"),
    ("serve.shed", "shed"),
    ("serve.errors", "errors"),
    ("serve.reloads", "reloads"),
    ("serve.rung_cap", "rung_cap"),
    ("serve.quantized", "quantized"),
    ("serve.quant.clip_fraction", "quant_clip_fraction"),
    ("serve.freshness.published", "freshness_published"),
    ("serve.freshness.candidates", "freshness_candidates"),
    ("serve.freshness.promotions", "promotions"),
    ("serve.freshness.rollbacks", "rollbacks"),
    ("serve.freshness.poisoned_rejected", "poisoned_rejected"),
    # the multi-host tier: membership and hedging beside load
    ("serve.fleet.hosts_live", "hosts_live"),
    ("serve.fleet.membership_epoch", "fleet_membership_epoch"),
    ("serve.fleet.requeues", "fleet_requeues"),
    ("serve.hedge.fired", "hedges_fired"),
    ("serve.hedge.wins", "hedge_wins"),
    ("serve.hedge.duplicates_dropped", "hedge_duplicates_dropped"),
    ("serve.hedge.budget_exhausted", "hedge_budget_exhausted"),
    ("serve.fleet.canary.mirrors", "fleet_canary_mirrors"),
    ("serve.fleet.canary.promotions", "fleet_canary_promotions"),
    ("serve.fleet.canary.rollbacks", "fleet_canary_rollbacks"),
    # request tracing: sampled-span and tail-exemplar volume (the
    # per-segment breakdown is the "segments" block)
    ("serve.reqtrace.sampled", "reqtrace_sampled"),
    ("serve.reqtrace.exemplars", "reqtrace_exemplars"),
    # the telemetry plane: alert firings and what burns right now
    ("alerts.fired", "alerts_fired"),
    ("alerts.active", "alerts_active"),
    ("telemetry.buckets", "telemetry_buckets"),
    ("telemetry.chunks_shipped", "telemetry_chunks_shipped"))


def serve_snapshot(reg=None):
    """The serving health block as a flat plain-data dict: queue depth,
    SLO violations, shed and error counts, latency percentiles (ms) and
    mean batch size; empty when nothing ever served.  With a replica
    pool (the ``serve.replicas`` gauge) it also carries the replica
    count and the per-replica queue depths, ``queue_depth`` being their
    sum; counters and histograms are shared by the replicas, so they
    aggregate by construction."""
    reg = reg if reg is not None else _registry
    out = {}
    for name, short in _SNAPSHOT_KEYS:
        metric = reg.peek(name)
        if metric is not None and metric.value is not None:
            out[short] = metric.value
    replicas = reg.peek("serve.replicas")
    if replicas is not None and replicas.value:
        out["replicas"] = replicas.value
        depths = []
        for i in range(int(replicas.value)):
            gauge = reg.peek("serve.replica.%d.queue_depth" % i)
            depths.append(
                gauge.value if gauge is not None and
                gauge.value is not None else 0)
        out["replica_queue_depths"] = depths
        out["queue_depth"] = sum(depths)
    hist = reg.peek("serve.latency_s")
    if hist is not None and hist.count:
        snap = hist.snapshot()
        for p in ("p50", "p95", "p99"):
            if snap.get(p) is not None:
                out["%s_ms" % p] = round(snap[p] * 1e3, 3)
    batch = reg.peek("serve.batch_size")
    if batch is not None and batch.count:
        out["batch_mean"] = round(batch.snapshot()["mean"], 2)
    # per-segment latency breakdown (observe/requests.py taxonomy): where
    # the time goes, beside the end-to-end percentiles; populated while
    # request tracing is on
    segments = {}
    for name in reqtrace.SEGMENTS:
        hist = reg.peek("serve.segment.%s_s" % name)
        if hist is not None and hist.count:
            snap = hist.snapshot()
            segments[name] = {
                "count": snap["count"],
                "p50_ms": round((snap.get("p50") or 0.0) * 1e3, 3),
                "p99_ms": round((snap.get("p99") or 0.0) * 1e3, 3),
            }
    if segments:
        out["segments"] = segments
    tenants = qos.tenant_snapshot(reg)
    if tenants:
        out["tenants"] = tenants
    return out
