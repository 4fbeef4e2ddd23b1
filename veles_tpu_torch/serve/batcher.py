"""Continuous-batching request queue over the engine.

Counterpart of the core of ``veles_tpu/serve/batcher.py``.  One worker
thread drains pending requests into the largest fitting ladder rung:
the first request of a batch waits at most ``max_delay_s`` for company,
the tail is zero-padded up to the rung, and the output rows go back to
their requests.  Past ``max_queue`` pending requests :meth:`submit`
raises :class:`ServeOverload` with a ``retry_after`` estimate instead
of growing the queue.  Engine failures fail only that batch's requests
and keep the worker alive.

Not ported yet: QoS classes, shadow traffic, the OOM degrade path,
engine hot-swap, chaos points, request tracing and the SLO watch.
"""

import queue
import threading
import time

import numpy

from veles_tpu_torch.logger import Logger

__all__ = ["ContinuousBatcher", "ServeOverload"]


class ServeOverload(Exception):
    """Load shed: the queue is full or the batcher is not running.
    ``retry_after`` (seconds) marks the rejection transient."""

    def __init__(self, message, retry_after=0.1):
        super(ServeOverload, self).__init__(message)
        self.retry_after = float(retry_after)


class _Request(object):
    __slots__ = ("sample", "block", "enqueued", "done", "result",
                 "error", "latency")

    def __init__(self, sample, block=False):
        self.sample = sample
        #: True when ``sample`` is a whole (n,) + sample_shape batch
        #: submitted with :meth:`ContinuousBatcher.submit_block`
        self.block = block
        self.enqueued = time.perf_counter()
        self.done = threading.Event()
        self.result = None
        self.error = None
        #: end-to-end seconds, stamped by the worker at completion
        self.latency = None

    @property
    def rows(self):
        return self.sample.shape[0] if self.block else 1


class ContinuousBatcher(Logger):
    """Worker thread turning a request stream into padded-rung batches.

    ``max_delay_s`` bounds how long the oldest request of a forming
    batch waits for more arrivals; ``max_queue`` bounds the pending
    requests before :meth:`submit` sheds."""

    def __init__(self, engine, max_delay_s=0.002, max_queue=256,
                 **kwargs):
        super(ContinuousBatcher, self).__init__(**kwargs)
        self.engine = engine
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)
        self._q = queue.Queue()
        self._thread = None
        self._stop_ = False
        self._stage = {}      # rung -> host staging buffer
        self._carry = None    # popped request that overflowed a batch
        #: served rows, batches, padded rows, shed requests, errors
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                      "shed": 0, "errors": 0}
        #: rung of every batch run, in order
        self.rungs = []

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

    # -- submit side --------------------------------------------------------

    def _retry_after(self):
        """Seconds until the queue has likely drained: batches ahead
        times a nominal 50 ms per batch, bounded to [0.05, 5]."""
        depth = self._q.qsize()
        return min(5.0, max(0.05, 0.05 * (
            1 + depth / float(self.engine.max_batch))))

    def _admit(self):
        if self._thread is None or self._stop_:
            raise ServeOverload("batcher not running", retry_after=1.0)
        if self._q.qsize() >= self.max_queue:
            self.stats["shed"] += 1
            raise ServeOverload("queue full (%d pending)" %
                                self._q.qsize(),
                                retry_after=self._retry_after())

    def _enqueue(self, req):
        self._q.put(req)
        if self._stop_:
            # lost the race with stop(): its drain may have run already
            req.error = ServeOverload("server shutting down",
                                      retry_after=1.0)
            req.done.set()
            raise req.error
        return req

    def submit(self, sample):
        """Enqueue one sample; returns the pending request.  Raises
        :class:`ServeOverload` when shedding."""
        self._admit()
        sample = numpy.ascontiguousarray(sample, self.engine.dtype)
        if sample.shape != self.engine.sample_shape:
            raise ValueError("expected sample shape %s, got %s" %
                             (self.engine.sample_shape, sample.shape))
        return self._enqueue(_Request(sample))

    def submit_block(self, block):
        """Enqueue a (n,) + sample_shape batch as one request whose
        result is the (n, ...) output block."""
        self._admit()
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
        return self._enqueue(_Request(block, block=True))

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
            first, self._carry = self._carry, None
            if first is None:
                try:
                    first = self._q.get(timeout=0.2)
                except queue.Empty:
                    continue
            batch = self._collect(first)
            try:
                self._run_batch(batch)
            except Exception as exc:  # never kill the worker
                self.stats["errors"] += 1
                self.exception("serve batch failed")
                for req in batch:
                    if not req.done.is_set():
                        req.error = exc
                        req.done.set()

    def _collect(self, first):
        """Grow a batch around the oldest pending request, in rows, up
        to the largest rung, waiting out what is left of
        ``max_delay_s``; a request that would overflow becomes the
        head of the next batch."""
        batch = [first]
        rows = first.rows
        limit = self.engine.max_batch
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
            if rows + req.rows > limit:
                self._carry = req
                break
            batch.append(req)
            rows += req.rows
        return batch

    def _run_batch(self, batch):
        n = sum(req.rows for req in batch)
        rung = self.engine.rung_for(n)
        mem = self._stage.get(rung)
        if mem is None:
            mem = self._stage[rung] = numpy.zeros(
                (rung,) + self.engine.sample_shape, self.engine.dtype)
        off = 0
        for req in batch:
            if req.block:
                mem[off:off + req.rows] = req.sample
            else:
                mem[off] = req.sample
            off += req.rows
        # deterministic padding: the bit-equality contract
        mem[n:] = 0
        # copied into the rung's input (its static input on the card),
        # so the staging buffer is free on return
        out = self.engine.run_host(mem, rung)
        host = out.cpu().numpy()   # the one host sync of the batch
        done = time.perf_counter()
        self.stats["batches"] += 1
        self.stats["requests"] += n
        self.stats["padded_rows"] += rung - n
        self.rungs.append(rung)
        off = 0
        for req in batch:
            if req.block:
                req.result = host[off:off + req.rows]
            else:
                req.result = host[off]
            off += req.rows
            req.latency = done - req.enqueued
            req.done.set()
