"""The compile step: captured CUDA graphs, replayed.

Counterpart of ``jax.jit(...).lower(...).compile()`` as the JAX package
uses it (``veles_tpu/compiler.py``'s jitted train step,
``veles_tpu/serve/engine.py``'s executable per rung).  On the card one
compiled XLA program becomes one captured CUDA graph: the Python body
runs once, at capture, and every later call is one ``replay``.

:class:`GraphOwner` holds the graphs of one owner (a trainer's train and
eval steps, an engine's rungs), keyed by signature: the input shapes,
dtypes, device and each Python scalar the body bakes in.  Its graphs
share one memory pool (they never run at the same time) and one side
stream.  A capture:

- refuses while ``VELES_DEBUG_NONFINITE`` is on: the guard's host sync
  cannot be captured (the trainer routes around it, see
  ``models/fused.py``);
- warms the body up first, on the side stream, on clones of its
  arguments, and discards the results: the kernel library is built,
  ``cudaFuncSetAttribute`` and the attention forward's occupancy query
  run, cuBLAS and cuDNN set up and autograd primes, and the caller's
  state, dropout keys and launch counters do not move;
- captures the body on the side stream into the owner's pool, the
  cyclic garbage collector paused (see :class:`Graph`);
- raises :class:`GraphCaptureError` naming the operation that broke it.
  Nothing carries on eagerly.

Launch counters.  Each kernel wrapper counts its Python calls
(``wrapper.launches``, and ``wrapper.paths`` by design).  A graph calls
each wrapper once, at capture, and never again, so each wrapper
registers with :func:`register_counters`: a capture records every
counter's delta and restores the counters, and each :meth:`Graph.replay`
adds the delta.  A counter then reads as the kernel's launches on the
device, captured or not.  The parallel layer's collective counters
(``parallel/collectives.py``) register the same way.  The warm-up's
launches go to the receipt (``warmup_launches``), not to the
counters.  A capture holds
:func:`exclusive`, and so does each serve of the input pipeline's
worker (``veles_tpu_torch/pipeline_input.py``): no launch of another
thread lands in a capture's count, and no copy or synchronization of
another thread breaks it.  The other threads that work on the card hold
:func:`shared` around that work instead: the serve tier's (each
replica's batcher worker, a reload swapping weights), and, while
several trainings share one card from threads of one process (a job
farm with in-process workers, ``veles_tpu_torch/jobfarm.py``, between
:func:`begin_sharing` and :func:`end_sharing`), a workflow's around each
unit's run and its initialize; a training alone takes no hold.  Any number of holds run at
once; a capture waits until every other thread's hold has ended and
keeps new ones waiting until it is done, so serving and the other
trainings pause for the length of a capture.  A thread that captures
while it holds :func:`shared` gives its hold up until the capture has
the card, and a holder gives it up while it waits on another thread
(:func:`released`: the input pipeline's graph thread waiting on its
worker), so two trainings that capture at once, or one that waits on a
worker that waits on another's capture, never deadlock.

Per-stream caches (``ops/reduce.py``'s tickets) register with
:func:`register_stream_cache` and are created for the side stream
before a capture: made inside it they would live in the pool and
outlive the graph.

:class:`HostScalars` is a static device input the host writes before
each replay (a dropout key, a chaos poison) through a ring of pinned
host slots: a copy from pageable memory would wait for the stream.

The receipt (:attr:`GraphOwner.receipt`) is the counterpart of the
engine's ``compile_receipt``: ``graphs`` (held now), ``captures``
(since the owner was made), ``capture_s``, ``warmup_launches``,
``pool_bytes`` (reserved by the pool), ``replays`` and ``eager_steps``
(runs an owner made without its graphs, e.g. under
``VELES_DEBUG_NONFINITE``).  Each capture is also a compile of the
process (``observe.introspect.note_capture``: ``compile.count``,
``compile.captures``), counted by its signature's first item in
:attr:`GraphOwner.captures_by_kind` ("step", "eval", ...).
"""

import contextlib
import gc
import os
import threading
import time
import traceback

import torch

from veles_tpu_torch.observe import introspect

__all__ = ["GraphOwner", "Graph", "GraphCaptureError", "CudaGraphs",
           "HostScalars", "register_counters", "register_stream_cache",
           "counters", "exclusive", "capturing", "shared", "released",
           "begin_sharing", "end_sharing", "card_shared"]

#: the kernel wrappers, each with ``launches`` and maybe ``paths``
_COUNTERS = []
#: fn(device, stream) that creates a per-stream cache ahead of a capture
_STREAM_CACHES = []
#: the modules whose wrappers register at import
_OPS = ("attention", "conv_vjp", "gather", "join", "matmul",
        "matmul_int8", "normalize", "pool_bwd", "random", "reduce")
_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
#: held through a capture and through each input pipeline serve
_EXCLUSIVE = threading.RLock()
#: the holds of shared(): the count over all threads, the thread whose
#: capture has the card (None: no capture), and this thread's depth
_SHARED = threading.Condition(threading.Lock())
_SHARED_COUNT = [0]
_CAPTURING = [None]
_SHARED_LOCAL = threading.local()
#: the job farms whose in-process workers train at once (card_shared())
_SHARERS = [0]
#: held while a replay advances the counters
_ADVANCE = threading.Lock()


class GraphCaptureError(RuntimeError):
    """A capture failed; the message names the graph and the operation
    that broke it."""


def register_counters(*wrappers):
    """Register kernel wrappers whose ``launches`` (and ``paths``) a
    capture records and a replay advances."""
    for wrapper in wrappers:
        if wrapper not in _COUNTERS:
            _COUNTERS.append(wrapper)


def register_stream_cache(fn):
    """Register ``fn(device, stream_handle)``, which creates a per-stream
    cache for a stream before a capture on it."""
    if fn not in _STREAM_CACHES:
        _STREAM_CACHES.append(fn)


def exclusive():
    """The lock a capture holds from its warm-up to its end; another
    thread that launches kernels or copies (the input pipeline's
    worker) holds it around that work."""
    return _EXCLUSIVE


def _enter_shared():
    """Count this thread's hold once no other thread's capture has the
    card."""
    me = threading.get_ident()
    with _SHARED:
        while _CAPTURING[0] not in (None, me):
            _SHARED.wait()
        _SHARED_COUNT[0] += 1


def _leave_shared():
    with _SHARED:
        _SHARED_COUNT[0] -= 1
        _SHARED.notify_all()


@contextlib.contextmanager
def shared():
    """A hold that any number of threads take at once around work on
    the card; a capture (:func:`capturing`) waits for every other
    thread's hold to end and keeps new holds waiting until it is
    done.  A thread's nested holds count once."""
    depth = getattr(_SHARED_LOCAL, "depth", 0)
    if not depth:
        _enter_shared()
    _SHARED_LOCAL.depth = depth + 1
    try:
        yield
    finally:
        _SHARED_LOCAL.depth = depth
        if not depth:
            _leave_shared()


def begin_sharing():
    """Trainings in several threads of this process from now on (a job
    farm's in-process workers): workflows hold :func:`shared` around
    each unit until the matching :func:`end_sharing`."""
    with _SHARED:
        _SHARERS[0] += 1


def end_sharing():
    with _SHARED:
        _SHARERS[0] -= 1


def card_shared():
    """Whether trainings in threads of this process share the card."""
    return _SHARERS[0] > 0


@contextlib.contextmanager
def released():
    """This thread's hold of :func:`shared` given up for the block (a
    wait on another thread that may need :func:`exclusive`), and taken
    again after it; nothing when the thread holds none."""
    depth = getattr(_SHARED_LOCAL, "depth", 0)
    if not depth:
        yield
        return
    _SHARED_LOCAL.depth = 0
    _leave_shared()
    try:
        yield
    finally:
        _enter_shared()
        _SHARED_LOCAL.depth = depth


@contextlib.contextmanager
def capturing():
    """:func:`exclusive`, entered only once no other thread holds
    :func:`shared`: what a capture holds, and what a serve engine's
    whole compile holds on the card (its uploads, captures and warm-up
    dispatches).  This thread's own hold is given up until the capture
    has the card and taken back before the next capture can start."""
    depth = getattr(_SHARED_LOCAL, "depth", 0)
    if depth:
        _SHARED_LOCAL.depth = 0
        _leave_shared()
    try:
        with _EXCLUSIVE:
            with _SHARED:
                outer = _CAPTURING[0]
                _CAPTURING[0] = threading.get_ident()
            try:
                with _SHARED:
                    while _SHARED_COUNT[0] > 0:
                        _SHARED.wait()
                yield
            finally:
                with _SHARED:
                    _CAPTURING[0] = outer
                    if depth:
                        _SHARED_COUNT[0] += 1
                    _SHARED.notify_all()
    finally:
        _SHARED_LOCAL.depth = depth


def counters():
    """The registered wrappers, every ops module imported first."""
    import importlib
    for name in _OPS:
        importlib.import_module("veles_tpu_torch.ops." + name)
    return list(_COUNTERS)


def _snapshot():
    return [(w, w.launches, dict(getattr(w, "paths", None) or {}))
            for w in counters()]


def _delta(before):
    """(wrapper, launches, {path: launches}) moved since ``before``."""
    out = []
    for wrapper, launches, paths in before:
        now = dict(getattr(wrapper, "paths", None) or {})
        moved = {key: value - paths.get(key, 0)
                 for key, value in now.items()
                 if value != paths.get(key, 0)}
        if wrapper.launches != launches or moved:
            out.append((wrapper, wrapper.launches - launches, moved))
    return out


def _restore(before):
    for wrapper, launches, paths in before:
        wrapper.launches = launches
        held = getattr(wrapper, "paths", None)
        if held is not None:
            held.clear()
            held.update(paths)


def _advance(delta):
    # replicas replay on several threads: no count may be lost
    with _ADVANCE:
        for wrapper, launches, paths in delta:
            wrapper.launches += launches
            for key, value in paths.items():
                wrapper.paths[key] = wrapper.paths.get(key, 0) + value


def _launch_total(delta):
    """Kernel launches in a recorded delta (a counter that is not a
    kernel's, ``counts_launches = False``, is left out)."""
    return sum(launches for wrapper, launches, _ in delta
               if getattr(wrapper, "counts_launches", True))


def _operation(exc):
    """file:line, function and source line of the innermost frame in
    ``exc``'s traceback that is neither this module nor PyTorch's: the
    operation that broke a capture."""
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    where = "an unknown frame"
    for frame in traceback.extract_tb(exc.__traceback__):
        path = os.path.abspath(frame.filename)
        if path.startswith(torch_dir) or path == os.path.abspath(__file__):
            continue
        if path.startswith(_PACKAGE_DIR):
            path = os.path.relpath(path, os.path.dirname(_PACKAGE_DIR))
        where = "%s:%d in %s: %s" % (path, frame.lineno, frame.name,
                                     (frame.line or "").strip())
    return where


def _clone(value):
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    return value


class CudaGraphs(object):
    """``torch.cuda``'s graphs on one card: the backend of
    :class:`GraphOwner`.  (The tests hand an owner a stand-in with the
    same methods to check the bookkeeping on the CPU.)"""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device, got %s"
                             % self.device)

    def pool(self):
        return torch.cuda.graph_pool_handle()

    def stream(self):
        return torch.cuda.Stream(self.device)

    def warm_up(self, stream, fn):
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            fn()
        current.wait_stream(stream)

    def capture(self, body, args, pool, stream):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            outputs = body(*args)
        return graph, outputs

    def stream_handle(self, stream):
        return stream.cuda_stream

    def pool_bytes(self, pool):
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class Graph(object):
    """One captured body: its static outputs and the counters' delta a
    replay adds.  It holds its owner's receipt, not the owner: no
    reference cycle keeps a dead owner's graphs for the cyclic
    collector, which could free them in the middle of a later capture."""

    def __init__(self, receipt, signature, graph, outputs, delta):
        self.receipt = receipt
        self.signature = signature
        self.outputs = outputs
        self.delta = delta
        self._graph = graph

    @property
    def launches(self):
        """Kernel launches of the port's wrappers a replay makes."""
        return _launch_total(self.delta)

    def replay(self):
        """Run the graph on the current stream; the outputs hold this
        replay's values until the next replay."""
        self._graph.replay()
        _advance(self.delta)
        self.receipt["replays"] += 1
        return self.outputs


class GraphOwner(object):
    """The graphs of one owner, keyed by signature: one memory pool, one
    side stream, one receipt."""

    def __init__(self, name, device, backend=None):
        self.name = name
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = backend or CudaGraphs(self.device)
        self._pool = self.backend.pool()
        self._stream = self.backend.stream()
        self._graphs = {}
        self.receipt = {"graphs": 0, "captures": 0, "capture_s": 0.0,
                        "warmup_launches": 0, "pool_bytes": 0,
                        "replays": 0, "eager_steps": 0}
        #: captures by a signature's first item (e.g. "step", "eval")
        self.captures_by_kind = {}

    def graph(self, signature, body, args):
        """The graph of ``signature``, captured from ``body(*args)`` on
        first sight.  ``body`` returns a tuple of tensors (the static
        outputs); ``args`` are its static inputs."""
        graph = self._graphs.get(signature)
        if graph is None:
            graph = self._capture(signature, body, args)
            self._graphs[signature] = graph
            self.receipt["graphs"] = len(self._graphs)
        return graph

    def clear(self):
        """Drop every graph (their memory goes back to the pool); the
        receipt keeps counting."""
        self._graphs.clear()
        self.receipt["graphs"] = 0

    def _capture(self, signature, body, args):
        from veles_tpu_torch.ops import common
        what = "%s %r" % (self.name, signature)
        if common.DEBUG_NONFINITE:
            raise GraphCaptureError(
                "%s: VELES_DEBUG_NONFINITE is on, and its guard syncs the "
                "host inside the kernel wrappers, which a capture cannot "
                "hold: run the raw step instead" % what)
        if self.device.type == "cuda":
            handle = self.backend.stream_handle(self._stream)
            for create in _STREAM_CACHES:
                create(self.device, handle)
        with capturing():
            return self._capture_exclusive(signature, body, args, what)

    def _capture_exclusive(self, signature, body, args, what):
        start = time.perf_counter()
        before = _snapshot()
        stage = "warming up"
        try:
            clones = [_clone(a) for a in args]
            self.backend.warm_up(self._stream, lambda: body(*clones))
            del clones
            warm = _launch_total(_delta(before))
            _restore(before)
            stage = "capturing"
            # a graph the cyclic collector frees during a capture (a dead
            # workflow's) resets its CUDA graph there, which a capture
            # does not permit: it would fail this one
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph, outputs = self.backend.capture(body, args, self._pool,
                                                      self._stream)
            finally:
                if collecting:
                    gc.enable()
            delta = _delta(before)
        except Exception as exc:
            raise GraphCaptureError("%s %s failed at %s: %s" % (
                stage, what, _operation(exc), exc)) from exc
        finally:
            _restore(before)
        seconds = time.perf_counter() - start
        receipt = self.receipt
        receipt["captures"] += 1
        receipt["capture_s"] += seconds
        receipt["warmup_launches"] += warm
        receipt["pool_bytes"] = self.backend.pool_bytes(self._pool)
        kind = signature[0] if isinstance(signature, tuple) and \
            signature and isinstance(signature[0], str) else None
        self.captures_by_kind[kind] = self.captures_by_kind.get(kind, 0) + 1
        introspect.note_capture(self.name, seconds)
        return Graph(self.receipt, signature, graph, tuple(outputs),
                     delta)


class HostScalars(object):
    """A small static device tensor that the host writes before each
    replay, through a ring of pinned host slots (each reused only after
    its last copy has run).  On the CPU it is a plain tensor."""

    SLOTS = 4

    def __init__(self, shape, dtype, device):
        self.device = torch.device(device)
        self.tensor = torch.zeros(shape, dtype=dtype, device=self.device)
        self._pinned = None
        if self.device.type == "cuda":
            self._pinned = torch.empty((self.SLOTS,) + tuple(shape),
                                       dtype=dtype, pin_memory=True)
            self._events = [None] * self.SLOTS
            self._next = 0

    def write(self, values):
        values = torch.as_tensor(values, dtype=self.tensor.dtype)
        if self._pinned is None:
            self.tensor.copy_(values)
            return self.tensor
        slot = self._next
        self._next = (slot + 1) % self.SLOTS
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        self._pinned[slot].copy_(values)
        self.tensor.copy_(self._pinned[slot], non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[slot] = event
        return self.tensor
