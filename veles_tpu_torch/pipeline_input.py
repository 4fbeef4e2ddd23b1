"""The input pipeline: minibatches served ahead of the train step.

Counterpart of ``veles_tpu/pipeline_input.py``.  Without it each fused
step pays its loader's serve strictly in sequence: the gather
(``gather_minibatch``, the kernel on the card) or the host fill and its
upload, then the step.  A :class:`Prefetcher` serves ``depth``
minibatches ahead on one worker thread while the graph thread runs the
step, so a step's time tends to the larger of the two instead of their
sum.

Correctness, as in the JAX package:

- the worker runs the loader's own serve (``serve_next_minibatch``), so
  shuffling, class order, short tails and epoch accounting are those of
  the synchronous run;
- the public serving fields downstream units read (minibatch class,
  size, offset, the end-of-class flags) go to the worker's
  ``loader.ServeShadow``; each :class:`PrefetchItem` carries their
  snapshot, which :meth:`Prefetcher.step` applies on the graph thread
  when it consumes the minibatch, and the samples are counted then;
- consumers read the minibatch through the item's tensors, never
  through the loader's Arrays, which belong to the worker;
- every served and not yet consumed minibatch keeps its record in
  ``loader.pending_minibatches_``: :meth:`Prefetcher.shutdown` and a
  pickle taken mid-run requeue them through ``failed_minibatches``, so
  serving ahead never drops one;
- a failure on the worker (a serve that raises, the ``pipeline.serve``
  chaos point, a kernel that does not build at its first launch there)
  raises on the graph thread at its next step.

On the card the worker serves under ``torch.cuda.stream(side)``, its own
stream: the gather kernel launches on the thread's current stream, so
it runs there, and a host fill is uploaded there from pinned slots
(``memory.Array.stage_put``).  Each item carries a ready event that the
graph thread's stream waits on before the step reads the item; the graph
thread records a consumed event when it moves past an item, and the
worker's stream waits on it before it rewrites that item's slot (the
device loader's gather buffers, one set a slot:
``FullBatchLoader.fill_indices``).  Tensors handed across are marked
with ``record_stream``.  A worker serve and a CUDA graph capture never
overlap (``graphs.exclusive``): a capture forbids other threads' copies
and synchronizations, and counts the launches made while it runs.  On
the CPU device (asked for explicitly) there are no streams or events
and the copies are plain.

Stage times: ``stats`` (``serves``, ``applied``, ``wait_s``, ``fill_s``,
``h2d_s``), the loader's ``pipeline_fill`` / ``pipeline_h2d`` /
``pipeline_wait`` timers, which ``Workflow.print_stats`` prints, the
registry's ``pipeline.wait_s`` / ``fill_s`` / ``h2d_s`` histograms and
``pipeline.depth`` gauge, and, while the tracer records, the
``pipeline.inflight`` counter track and the ``pipeline.wait`` /
``fill`` / ``h2d`` spans (the worker's on its own track).  All are
host time.  On the card a worker serve's fill includes its launches'
wait for the stream to accept them behind the consumed event (the
previous step's end).
"""

import contextlib
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from veles_tpu_torch import chaos, graphs
from veles_tpu_torch.loader.base import ServeShadow
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer

__all__ = ["Prefetcher", "PrefetchItem"]


class _Worker(Logger):
    """One thread that runs submitted calls in order and keeps the first
    failure (the JAX package's one-thread ``ThreadPool``)."""

    def __init__(self, name):
        super(_Worker, self).__init__()
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix=name)
        self.failure = None

    def submit(self, fn, *args):
        self._executor.submit(self._run, fn, args)

    def _run(self, fn, args):
        try:
            fn(*args)
        except BaseException:
            # kept for the graph thread, which raises it at its next step
            if self.failure is None:
                self.failure = sys.exc_info()
                self.error("input pipeline worker failed: %s",
                           self.failure[1])
            raise

    def shutdown(self):
        """Drop the calls not started and join the thread."""
        self._executor.shutdown(wait=True, cancel_futures=True)


class PrefetchItem(object):
    """One served minibatch: its tensors, the snapshot of the loader's
    serving fields, its slot and, on the card, its ready event."""

    __slots__ = ("serial", "slot", "data", "labels", "targets", "values",
                 "ready")

    def __init__(self, serial, slot):
        self.serial = serial
        self.slot = slot
        self.data = None
        self.labels = None
        self.targets = None
        self.values = None
        self.ready = None


class Prefetcher(Logger):
    """Serves a loader's minibatches ``depth`` steps ahead on a worker
    thread.  ``attach()`` routes ``loader.run()`` through :meth:`step`;
    the worker starts at the first step and again after
    :meth:`shutdown`, so one Prefetcher spans any number of runs."""

    def __init__(self, loader, device, depth=1, **kwargs):
        super(Prefetcher, self).__init__(**kwargs)
        self.loader = loader
        self.device = device
        self.depth = max(1, int(depth))
        self.nslots = self.depth + 1
        self.current = None
        self._cuda = device.torch_device.type == "cuda"
        self._side = None
        self._worker = None
        self._results = queue.Queue()
        self._inflight = 0
        self._serial = 0
        self._shutdown = False
        self._consumed = [None] * self.nslots
        # held around each worker serve; quiescent() takes it so a
        # mid-run pickle never sees a half-applied serve
        self._serve_mutex = threading.Lock()
        self.stats = self._fresh_stats()
        self._m_wait = _registry.histogram("pipeline.wait_s")
        self._m_fill = _registry.histogram("pipeline.fill_s")
        self._m_h2d = _registry.histogram("pipeline.h2d_s")
        _registry.gauge("pipeline.depth").set(self.depth)

    def _fresh_stats(self):
        return {"depth": self.depth, "serves": 0, "applied": 0,
                "wait_s": 0.0, "fill_s": 0.0, "h2d_s": 0.0}

    @property
    def side_stream(self):
        """The worker's CUDA stream (None on the CPU or before the first
        step)."""
        return self._side

    # -- lifecycle ---------------------------------------------------------

    def attach(self):
        self.loader._pipeline_ = self
        return self

    def _start(self):
        self._shutdown = False
        self._inflight = 0
        self._results = queue.Queue()
        self.current = None
        self._consumed = [None] * self.nslots
        self.stats = self._fresh_stats()
        if self._cuda and self._side is None:
            self._side = torch.cuda.Stream(self.device.torch_device)
        self._worker = _Worker("prefetch")

    def shutdown(self):
        """Stop serving ahead and join the worker; idempotent.  The
        records of minibatches served and never consumed go back
        through ``failed_minibatches``, newest first, so a later serve
        replays them in their order."""
        self._shutdown = True
        worker, self._worker = self._worker, None
        if worker is not None:
            worker.shutdown()
        while True:
            try:
                self._results.get_nowait()
            except queue.Empty:
                break
        loader = self.loader
        pending = loader.pending_minibatches_.pop(None, None)
        if pending:
            loader.failed_minibatches.extend(reversed(pending))
            self.debug("requeued %d minibatch(es) served ahead",
                       len(pending))
        if self._side is not None:
            torch.cuda.current_stream(self.device.torch_device).wait_stream(
                self._side)
        self._inflight = 0
        self.current = None
        loader._serve_shadow_ = None

    @contextlib.contextmanager
    def quiescent(self):
        """No serve runs while this is held (``Loader.__getstate__``)."""
        with self._serve_mutex:
            yield

    def _staged_arrays(self):
        loader = self.loader
        arrays = [loader.minibatch_data, loader.minibatch_indices,
                  loader.minibatch_labels,
                  getattr(loader, "minibatch_targets", None)]
        return [a for a in arrays if a is not None and bool(a)]

    def _raise_failure(self):
        failure = self._worker.failure
        self.shutdown()
        raise failure[1].with_traceback(failure[2])

    # -- the graph thread --------------------------------------------------

    def step(self):
        """Take the oldest served minibatch, apply its snapshot to the
        loader's serving fields and keep the worker ``depth`` serves
        ahead: ``Loader.run`` with a pipeline attached."""
        if self._worker is None:
            self._start()
        if self._worker.failure is not None:
            # fail at once: the worker goes on with the serves queued
            # behind the one that failed
            self._raise_failure()
        self._release(self.current)
        while self._inflight < self.depth + 1 and not self._shutdown:
            self._submit()
        if _tracer.enabled:
            _tracer.counter("pipeline.inflight", self._inflight)
        item = self._take()
        if item is None:  # shut down while waiting (Workflow.stop)
            return
        self._inflight -= 1
        self._adopt(item)
        self._apply(item)
        self.current = item
        self.stats["applied"] += 1

    def _release(self, item):
        """The graph's stream is past ``item``: the worker may rewrite
        its slot once the stream reaches this event."""
        if item is None or not self._cuda:
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device.torch_device))
        self._consumed[item.slot] = event

    def _submit(self):
        worker = self._worker
        if worker is None:
            return
        serial = self._serial
        self._serial += 1
        self._inflight += 1
        worker.submit(self._serve_one, serial, serial % self.nslots)

    def _take(self):
        start = time.perf_counter()
        while True:
            try:
                item = self._results.get(timeout=0.2)
                break
            except queue.Empty:
                if self._shutdown or self._worker is None:
                    return None
                if self._worker.failure is not None:
                    self._raise_failure()
        waited = time.perf_counter() - start
        self.stats["wait_s"] += waited
        self._m_wait.observe(waited)
        if _tracer.enabled:
            _tracer.complete("pipeline.wait", start, waited,
                             cat="pipeline")
        timers = self.loader.timers
        timers["pipeline_wait"] = timers.get("pipeline_wait", 0.0) + waited
        return item

    def _adopt(self, item):
        """Order the graph's stream after the item's serve."""
        if item.ready is None:
            return
        stream = torch.cuda.current_stream(self.device.torch_device)
        stream.wait_event(item.ready)
        for tensor in (item.data, item.labels, item.targets):
            if tensor is not None:
                tensor.record_stream(stream)

    def _apply(self, item):
        """Write the item's snapshot into the loader's fields (their
        backing attributes: the setters would derive the flags again
        from the worker's offset) and count its samples."""
        loader = self.loader
        values = item.values
        with self._serve_mutex:
            # the oldest pending record is this item's: consuming it
            # retires the record
            pending = loader.pending_minibatches_.get(None)
            if pending:
                pending.pop(0)
        loader._minibatch_class = values["minibatch_class"]
        loader._minibatch_size_ = values["minibatch_size"]
        loader._minibatch_offset_ = values["minibatch_offset"]
        for name in ServeShadow.FLAGS:
            flag = getattr(loader, name)
            flag <<= values[name]
        loader._on_successful_serve()

    # -- the worker --------------------------------------------------------

    def _serve_one(self, serial, slot):
        with self._serve_mutex, graphs.exclusive():
            if self._side is None:
                self._serve_one_locked(serial, slot)
                return
            with torch.cuda.stream(self._side):
                self._serve_one_locked(serial, slot)

    def _serve_one_locked(self, serial, slot):
        if chaos.plan is not None:
            fault = chaos.plan.fire("pipeline.serve")
            if fault is not None and fault.action == "exc":
                raise RuntimeError(
                    "chaos: injected serve failure (serial %d)" % serial)
        loader = self.loader
        shadow = loader._serve_shadow_
        if shadow is None or shadow.thread is not threading.current_thread():
            # this worker's first serve: start from the applied fields
            shadow = ServeShadow(loader, threading.current_thread())
            loader._serve_shadow_ = shadow
        if self._side is not None and self._consumed[slot] is not None:
            # the graph's stream has read what the slot held
            self._side.wait_event(self._consumed[slot])
        t0 = time.perf_counter()
        for arr in self._staged_arrays():
            if not arr.staged:
                arr.stage_init(self.nslots, pin=self._cuda)
            arr.stage_begin(slot)
        # unlike Loader.run: the previous record stays pending until
        # its minibatch is consumed, and the samples are counted then
        # (_apply), so a requeued serve is never counted twice
        loader.serve_next_minibatch(None)
        t1 = time.perf_counter()

        item = PrefetchItem(serial, slot)
        item.values = dict(shadow.values)
        item.data = loader.minibatch_data.staged_capture(self.device)
        if loader.minibatch_labels:
            item.labels = loader.minibatch_labels.staged_capture(
                self.device)
        targets = getattr(loader, "minibatch_targets", None)
        if targets is not None and bool(targets):
            item.targets = targets.staged_capture(self.device)
        if self._side is not None:
            item.ready = torch.cuda.Event()
            item.ready.record(self._side)
        t2 = time.perf_counter()

        self.stats["serves"] += 1
        self.stats["fill_s"] += t1 - t0
        self.stats["h2d_s"] += t2 - t1
        self._m_fill.observe(t1 - t0)
        self._m_h2d.observe(t2 - t1)
        if _tracer.enabled:
            # the worker's spans land on its own track, beside the
            # graph thread's steps, so the overlap shows directly
            _tracer.complete("pipeline.fill", t0, t1 - t0,
                             cat="pipeline", args={"serial": serial})
            _tracer.complete("pipeline.h2d", t1, t2 - t1,
                             cat="pipeline", args={"serial": serial})
        timers = loader.timers
        timers["pipeline_fill"] = timers.get("pipeline_fill", 0.0) + \
            (t1 - t0)
        timers["pipeline_h2d"] = timers.get("pipeline_h2d", 0.0) + \
            (t2 - t1)
        self._results.put(item)
