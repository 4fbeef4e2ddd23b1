"""Compile, memory and MFU introspection on the card.

Counterpart of ``veles_tpu/observe/xla_introspect.py``, under the same
public names and the same registry names (``compile.*``, ``xla.mem.*``,
``xla.step_flops``, ``xla.fwd_flops``, ``xla.mfu_pct``, ``bwd.*``), so a
heartbeat from either package validates and summarizes with either
package's tools.  What each name measures here:

- **compiles.**  The port has no compiler to listen to: its compiles
  are the kernel library's build (``ops/common.load_kernels``) and each
  CUDA-graph capture (``graphs.GraphOwner``).  Both report here as they
  happen (:func:`note_kernel_library`, :func:`note_capture`), so
  ``compile.count`` is the process's kernel-library builds plus its
  captures, ``compile.seconds`` their time, ``compile.captures`` and
  ``compile.kernel_builds`` the two parts.  ``compile.capture_seconds``
  is the captures' time alone, warm-ups included, less a library load
  that fell inside one (the set-up's capture share).  A library another process
  built and this one only loaded is the counterpart of a persistent
  cache hit (``compile.cache_hits``; a build is a ``cache_misses``).
  Unlike JAX's, ``compile.count`` leaves the hits out: it is already
  the number of things this process built.  :func:`watch` takes a
  :class:`~veles_tpu_torch.graphs.GraphOwner` (optionally one kind of
  its signatures, e.g. ``"step"`` or ``"eval"``), and :func:`poll_recompiles`
  counts the captures a watched owner made past its first
  (``compile.recompiles``) and warns once when it holds more than
  ``warn_after`` signatures: a shape that varies every step recaptures
  every step;
- **device memory.**  :func:`device_memory_gauges` publishes
  ``xla.mem.bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit``
  (and ``bytes_reserved``) per card from ``torch.cuda.memory_stats()``
  and the card's total memory; the caching allocator serves the graph
  pools too, so they are counted.  It reads only cards this process
  already uses (it never creates a CUDA context).  Without one it
  falls back to a live census as the JAX package does: the bytes of
  the device tensors the Arrays hold (``memory.Watcher``;
  ``xla.mem.live_bytes``);
- **MFU.**  :func:`set_step_flops` / :func:`set_fwd_flops` record the
  analytic FLOP count of one train step and of its forward
  (``compiler.step_flops``), and :func:`mfu_snapshot` /
  :func:`bwd_snapshot` divide them by the median step times of the
  ``step.train_s`` / ``step.eval_s`` histograms and the card's peak, as
  the JAX package does.  The fused trainer times a step on the card by
  CUDA events (``models/fused.py``), never by the host's enqueue.

:func:`peak_flops` rates an H100 at its dense tensor-core peaks (bf16
989 TFLOP/s, int8 1,979 TOP/s), keyed by ``torch.cuda.get_device_name``;
the TPU rows stay beside them.  ``VELES_PEAK_TFLOPS`` overrides the
table; with no card in use the peak is a measured ``torch.matmul``
ceiling, as the JAX package measures its CPU one.

Everything here runs off the step path (compile time, the heartbeat
thread, the decision's class end) and imports torch lazily: a
heartbeat of a run that compiled nothing never touches CUDA.
"""

import logging
import os
import threading
import weakref

from veles_tpu_torch.observe.metrics import percentiles
from veles_tpu_torch.observe.metrics import registry as _registry

__all__ = ["CompileWatcher", "watcher", "ensure_installed", "watch",
           "poll_recompiles", "device_memory_gauges", "set_step_flops",
           "set_fwd_flops", "set_step_dtype", "step_dtype",
           "peak_flops", "mfu_snapshot", "bwd_snapshot",
           "compile_snapshot", "compile_delta", "note_capture",
           "note_kernel_library", "PEAK_BF16_TFLOPS", "PEAK_INT8_TFLOPS"]

#: dense peak TFLOP/s at bf16 by device-name substring: the H100's
#: tensor cores (SXM spec sheet) before the TPU rows of the JAX package
PEAK_BF16_TFLOPS = (
    ("h100", 989.0),
    ("v6", 918.0), ("v5p", 459.0), ("v5", 197.0), ("v4", 275.0),
    ("v3", 123.0), ("v2", 45.0),
)

#: dense peak TOP/s at int8, as above: an int8 step rates against it
PEAK_INT8_TFLOPS = (
    ("h100", 1979.0),
    ("v6", 1836.0), ("v5p", 918.0), ("v5", 394.0), ("v4", 275.0),
    ("v3", 123.0), ("v2", 45.0),
)

_PEAK_TABLES = {"bf16": PEAK_BF16_TFLOPS, "int8": PEAK_INT8_TFLOPS}


def _tracer():
    from veles_tpu_torch.observe.trace import tracer
    return tracer


def note_capture(owner, seconds, reg=None, library_s=0.0):
    """One CUDA-graph capture of ``owner`` took ``seconds``, of which
    ``library_s`` loaded the kernel library (called by
    ``graphs.GraphOwner`` as the capture ends)."""
    reg = reg if reg is not None else _registry
    reg.counter("compile.count").inc()
    reg.counter("compile.seconds").inc(float(seconds))
    reg.counter("compile.captures").inc()
    reg.counter("compile.capture_seconds").inc(
        max(0.0, float(seconds) - float(library_s)))
    tracer = _tracer()
    if tracer.active:
        tracer.instant("xla.compile", cat="xla", kind="capture",
                       owner=owner, seconds=round(float(seconds), 4))


def note_kernel_library(built, seconds, reg=None):
    """The kernel library was loaded: ``built`` when this process ran
    nvcc (a compile), else it loaded what another process built (a
    cache hit)."""
    reg = reg if reg is not None else _registry
    if not built:
        reg.counter("compile.cache_hits").inc()
        return
    reg.counter("compile.count").inc()
    reg.counter("compile.seconds").inc(float(seconds))
    reg.counter("compile.kernel_builds").inc()
    reg.counter("compile.cache_misses").inc()
    tracer = _tracer()
    if tracer.active:
        tracer.instant("xla.compile", cat="xla", kind="kernel_library",
                       seconds=round(float(seconds), 4))


class CompileWatcher(object):
    """Count each watched graph owner's captures and warn on growth."""

    def __init__(self, registry=None, warn_after=2):
        self.registry = registry if registry is not None else _registry
        #: signatures a watched owner may hold before the warning
        self.warn_after = warn_after
        self.installed = True
        self._lock = threading.Lock()
        # name -> [weakref to the owner, kind, base, last, warned]
        self._watched = {}

    def install(self):
        """Compiles report from their sources; nothing to install."""
        return True

    @staticmethod
    def _captures(owner, kind):
        if kind is None:
            return int(owner.receipt["captures"])
        return int(owner.captures_by_kind.get(kind, 0))

    def watch(self, owner, name, kind=None):
        """Track ``owner``'s captures (of signatures whose first item is
        ``kind``, when given) from now on; an object that is not a graph
        owner is ignored.  The watcher holds the owner weakly: a dropped
        trainer's graphs and their memory pool go as they would."""
        if owner is None or not hasattr(owner, "receipt"):
            return False
        with self._lock:
            self._watched[name] = [weakref.ref(owner), kind,
                                   self._captures(owner, kind), 0, False]
        return True

    def _live(self):
        """(name, entry, owner) of the watched owners still alive; the
        dead ones are forgotten."""
        out = []
        with self._lock:
            for name, entry in list(self._watched.items()):
                owner = entry[0]()
                if owner is None:
                    del self._watched[name]
                else:
                    out.append((name, entry, owner))
        return out

    def unwatch(self, name):
        with self._lock:
            self._watched.pop(name, None)

    def poll(self, warn=None):
        """Refresh the watched owners' capture counts; returns {name:
        captures since watched}.  Growth past the first poll's count
        bumps ``compile.recompiles``; the first count past
        ``warn_after`` logs the recompile warning once."""
        sizes = {}
        for name, entry, owner in self._live():
            _, kind, base, last, warned = entry
            size = self._captures(owner, kind) - base
            sizes[name] = size
            if size > last:
                if last:
                    self.registry.counter(
                        "compile.recompiles").inc(size - last)
                entry[3] = size
            if size > self.warn_after and not warned:
                entry[4] = True
                logging.getLogger("xla").warning(
                    "recompile storm suspected: %s has captured %d "
                    "signatures (expected <= %d) - check for varying "
                    "shapes/dtypes or Python scalars baked into the step",
                    name, size, self.warn_after)
                if warn is not None:
                    warn(name, size)
        return sizes


#: the process-wide watcher (the fused trainer registers its owner)
watcher = CompileWatcher()


def ensure_installed():
    return watcher.install()


def watch(owner, name, kind=None):
    return watcher.watch(owner, name, kind)


def poll_recompiles():
    return watcher.poll()


def compile_snapshot(reg=None):
    """{"count", "seconds", "recompiles", "cache_hits", "cache_misses",
    "captures", "kernel_builds"} from the registry: always the whole
    dict, zeros before the first compile."""
    reg = reg if reg is not None else _registry
    out = {}
    for key, name, cast in (
            ("count", "compile.count", int),
            ("seconds", "compile.seconds",
             lambda v: round(float(v), 4)),
            ("recompiles", "compile.recompiles", int),
            ("cache_hits", "compile.cache_hits", int),
            ("cache_misses", "compile.cache_misses", int),
            ("captures", "compile.captures", int),
            ("kernel_builds", "compile.kernel_builds", int)):
        metric = reg.peek(name)
        out[key] = cast(metric.value) if metric is not None else cast(0)
    return out


class compile_delta(object):
    """``with compile_delta() as d: ...`` then ``d.receipt`` is
    ``{"backend_compiles", "cache_hits", "new_compiles", "captures",
    "kernel_builds"}`` for the block: the JAX package's receipt, where
    ``backend_compiles`` counts the requests (library loads included)
    and ``new_compiles`` what was built (captures and library builds)."""

    def __init__(self, reg=None):
        self._reg = reg
        self.receipt = None

    def __enter__(self):
        self._before = compile_snapshot(self._reg)
        return self

    def __exit__(self, *exc_info):
        after = compile_snapshot(self._reg)

        def moved(key):
            return after[key] - self._before[key]
        hits = moved("cache_hits")
        self.receipt = {"backend_compiles": moved("count") + hits,
                        "cache_hits": hits,
                        "new_compiles": moved("count"),
                        "captures": moved("captures"),
                        "kernel_builds": moved("kernel_builds")}
        return False


# -- device memory -----------------------------------------------------------


def _cards_in_use():
    """Indices of the cards this process has a context on; () without
    one (a CPU run never initializes CUDA here)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None:
        return ()
    try:
        if not torch.cuda.is_available() or \
                not torch.cuda.is_initialized():
            return ()
        return tuple(range(torch.cuda.device_count()))
    except Exception:
        return ()


def _live_bytes():
    """The bytes of the device tensors the Arrays hold
    (``memory.Watcher``): the framework's own census, as the JAX
    package's over ``jax.live_arrays()``.  A walk of
    ``gc.get_objects()`` would also see loose tensors, but it holds a
    reference to every object while it runs, and another thread's
    tuple resize then fails."""
    import sys
    memory = sys.modules.get("veles_tpu_torch.memory")
    return 0 if memory is None else int(memory.Watcher.bytes_on_device)


def device_memory_gauges(reg=None):
    """Publish the memory gauges; returns the flat dict."""
    reg = reg if reg is not None else _registry
    out = {}
    cards = _cards_in_use()
    if cards:
        import torch
        for index in cards:
            try:
                stats = torch.cuda.memory_stats(index)
                limit = torch.cuda.get_device_properties(index).total_memory
            except Exception:
                continue
            for key, value in (
                    ("bytes_in_use",
                     stats.get("allocated_bytes.all.current", 0)),
                    ("peak_bytes_in_use",
                     stats.get("allocated_bytes.all.peak", 0)),
                    ("bytes_reserved",
                     stats.get("reserved_bytes.all.current", 0)),
                    ("bytes_limit", limit)):
                name = "xla.mem.%s.d%d" % (key, index)
                reg.gauge(name).set(int(value))
                out[name] = int(value)
        if out:
            return out
    live = _live_bytes()
    reg.gauge("xla.mem.live_bytes").set(live)
    out["xla.mem.live_bytes"] = live
    return out


# -- FLOPs / MFU -------------------------------------------------------------


def set_step_flops(flops, reg=None):
    """Record the FLOP count of ONE train step (the fused trainer
    publishes it at its first train step)."""
    reg = reg if reg is not None else _registry
    reg.gauge("xla.step_flops").set(float(flops))


def set_fwd_flops(flops, reg=None):
    """Record the FLOP count of the forward-only program (the fused
    trainer's evaluation step): with ``xla.step_flops`` it splits the
    step between forward and backward (:func:`bwd_snapshot`)."""
    reg = reg if reg is not None else _registry
    reg.gauge("xla.fwd_flops").set(float(flops))


_peak_cache = {}
_peak_lock = threading.Lock()
_step_dtype = ["bf16"]


def set_step_dtype(name, reg=None):
    """Record the dominant arithmetic dtype of the measured step
    ("bf16" for the float ladder, "int8" for the quantized level), so
    :func:`mfu_snapshot` divides by the matching peak."""
    if name not in _PEAK_TABLES:
        raise ValueError("unknown step dtype %r (have %s)" %
                         (name, sorted(_PEAK_TABLES)))
    with _peak_lock:
        _step_dtype[0] = name
    reg = reg if reg is not None else _registry
    reg.gauge("xla.step_dtype_int8").set(1 if name == "int8" else 0)


def step_dtype():
    """The recorded dominant step dtype ("bf16" default)."""
    with _peak_lock:
        return _step_dtype[0]


def _measured_peak():
    """The achieved FLOP/s of a small f32 ``torch.matmul`` on the CPU,
    the best of 3: the ceiling a CPU run's MFU is read against."""
    import time

    import numpy
    import torch
    n = 384
    a = torch.from_numpy(numpy.random.RandomState(7)
                         .rand(n, n).astype(numpy.float32))
    torch.matmul(a, a)
    best = None
    for _ in range(3):
        start = time.perf_counter()
        torch.matmul(a, a)
        elapsed = time.perf_counter() - start
        if best is None or elapsed < best:
            best = elapsed
    return 2.0 * n * n * n / max(best, 1e-9)


def _device_name():
    cards = _cards_in_use()
    if not cards:
        return None
    import torch
    return torch.cuda.get_device_name(torch.cuda.current_device())


def peak_flops(dtype=None):
    """This process's peak FLOP/s for MFU, resolved once per dtype:
    ``VELES_PEAK_TFLOPS`` -> the device-name table for ``dtype`` (None
    -> :func:`step_dtype`) -> a measured matmul ceiling (one for every
    dtype).  None when nothing could be measured."""
    if dtype is None:
        dtype = step_dtype()
    table = _PEAK_TABLES.get(dtype, PEAK_BF16_TFLOPS)
    key = ("peak", dtype)
    with _peak_lock:
        if key in _peak_cache:
            return _peak_cache[key]
        peak = None
        env = os.environ.get("VELES_PEAK_TFLOPS", "")
        if env:
            try:
                peak = float(env) * 1e12
            except ValueError:
                peak = None
        if peak is None:
            try:
                kind = (_device_name() or "").lower()
                for kind_key, tflops in table:
                    if kind and kind_key in kind:
                        peak = tflops * 1e12
                        break
            except Exception:
                pass
        if peak is None:
            try:
                peak = _peak_cache.get(("measured",))
                if peak is None:
                    peak = _measured_peak()
                    _peak_cache[("measured",)] = peak
            except Exception:
                peak = None
        _peak_cache[key] = peak
        return peak


def _p50(hist):
    if hist is None:
        return None
    window = hist.window_values()
    if not window:
        return None
    return percentiles(window, ps=(50,)).get("p50")


def mfu_snapshot(reg=None):
    """The live achieved MFU in percent, or None while its inputs are
    missing; publishes ``xla.mfu_pct``.  The step time is the median of
    the ``step.train_s`` window.  Refreshes :func:`bwd_snapshot`
    first, so the split never lags the whole."""
    reg = reg if reg is not None else _registry
    bwd_snapshot(reg)
    flops_gauge = reg.peek("xla.step_flops")
    if flops_gauge is None or flops_gauge.value is None:
        return None
    step_s = _p50(reg.peek("step.train_s"))
    if not step_s or step_s <= 0:
        return None
    peak = peak_flops()
    if not peak:
        return None
    mfu = round(100.0 * float(flops_gauge.value) / step_s / peak, 3)
    reg.gauge("xla.mfu_pct").set(mfu)
    return mfu


def bwd_snapshot(reg=None):
    """Backward+update attribution: ``bwd.step_ms`` = p50(train step) -
    p50(eval step) and ``bwd.mfu_pct`` = (step FLOPs - forward FLOPs) /
    that time / peak.  Returns {"bwd_step_ms", "bwd_mfu_pct"} or None
    while an input is missing.  The evaluation step skips dropout and
    the loss's tail, so those few percent count as backward."""
    reg = reg if reg is not None else _registry
    train_s = _p50(reg.peek("step.train_s"))
    eval_s = _p50(reg.peek("step.eval_s"))
    if not train_s or not eval_s or train_s <= eval_s:
        return None
    bwd_s = train_s - eval_s
    out = {"bwd_step_ms": round(bwd_s * 1e3, 3)}
    reg.gauge("bwd.step_ms").set(out["bwd_step_ms"])
    step_gauge = reg.peek("xla.step_flops")
    fwd_gauge = reg.peek("xla.fwd_flops")
    peak = peak_flops()
    if (peak and step_gauge is not None and fwd_gauge is not None
            and step_gauge.value and fwd_gauge.value
            and step_gauge.value > fwd_gauge.value):
        bwd_flops = float(step_gauge.value) - float(fwd_gauge.value)
        out["bwd_mfu_pct"] = round(100.0 * bwd_flops / bwd_s / peak, 3)
        reg.gauge("bwd.mfu_pct").set(out["bwd_mfu_pct"])
    return out
