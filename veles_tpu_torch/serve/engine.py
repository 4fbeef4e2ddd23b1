"""Inference engine over a ladder of padded batch shapes.

Counterpart of ``veles_tpu/serve/engine.py``'s ``AOTEngine``.  A
request batch is padded up to the smallest fitting *rung* of the
ladder (default 1/8/32/128) and dispatched to the forward.  On the card
:meth:`AOTEngine.compile` captures one CUDA graph per rung
(``veles_tpu_torch/graphs.py``; all rungs in one memory pool), the
counterpart of the reference's executable per rung, and replays each
once; :meth:`AOTEngine.run` copies the batch into the rung's static
input, replays, and returns a copy of the output that no later run
overwrites.  The parameters are the graphs' static inputs:
:meth:`AOTEngine.swap_params` copies new weights into them, and the next
replay sees them.  On the CPU the forward runs as it is.  The receipt
is ``{"rungs", "seconds", "quantized", "warmups"}`` plus the graphs'
``graphs``, ``captures``, ``capture_s``, ``warmup_launches``,
``pool_bytes``, ``replays`` and ``eager_steps`` (all 0 on the CPU).
Under ``VELES_DEBUG_NONFINITE`` :meth:`AOTEngine.compile` raises on the
card: the guard's host sync cannot be captured, and the engine has no
eager route.  A CUDA graph does not outlive its process, so the
reference's persistent compile cache has no counterpart: the receipt's
``kernel_builds`` (1 when this process built the kernel library, 0 when
it loaded a built one from ``veles_tpu_torch/build/``) and ``captures``
say what a start paid, and ``new_compiles`` is what this compile built
of them, as ``observe.introspect.compile_delta`` counted it (the
``compile.*`` counters every capture and build feeds).

Spans: :meth:`AOTEngine.run_host` reads the clock where its copy in
ends (on the card: after the wait on the previous dispatch's event,
which the copy must follow, and the copy into the rung's static input;
on the CPU the upload) and where its launch ends (the replay's
enqueue; on the CPU the forward), into a list its caller passes; the
batcher records them as its ``serve.h2d`` and ``serve.launch`` spans.

Several threads on one card (the replicas of a ``ReplicaPool``, a
reload): a dispatch and a weight swap hold ``graphs.shared()``, and the
whole of :meth:`AOTEngine.compile` holds ``graphs.capturing()``, so no
other thread's copy or synchronization lands inside a capture.  Each
dispatch first waits on the event of the engine's previous one, so two
callers on different streams never overlap on the rungs' static
buffers, and a weight swap is ordered between two replays.

An int8-quantized spec (``quant.quantize_model_spec``) is detected by
its ``weights_scale`` entries and served through
``quant.forward.build_quantized_forward``, whose conv and all2all
layers run the ``matmul_int8`` kernel.

Numerics: padding rows never leak into real rows (no cross-row
reduction except the per-row softmax).  Whether a row's bits depend on
the rung is the backend's business: on the CPU rungs >= 8 agree bit
for bit while rung 1 may differ by an ulp (another matrix-vector
kernel), as on the JAX side; on the card the f32 convolutions may pick
other cuDNN algorithms per rung, while the int8 path computes each row
independently of the batch.
"""

import contextlib
import hashlib
import threading
import time
import warnings

import numpy
import torch

from veles_tpu_torch import graphs
from veles_tpu_torch.graphs import GraphOwner
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.observe import introspect
from veles_tpu_torch.observe.metrics import registry as _registry

__all__ = ["AOTEngine", "model_digest", "engine_digest_extra",
           "value_digest", "publish_quantized_state", "DEFAULT_LADDER"]

#: default batch-shape ladder
DEFAULT_LADDER = (1, 8, 32, 128)


def publish_quantized_state(quantized):
    """Publish the served arithmetic level: the ``serve.quantized``
    gauge (``serve_snapshot``, ``/healthz``) and the MFU's peak
    (``observe.introspect.set_step_dtype``: an int8 engine's steps rate
    against the int8 peak).  Process-global, so every transition that
    changes what the fleet serves republishes it."""
    _registry.gauge("serve.quantized").set(1 if quantized else 0)
    introspect.set_step_dtype("int8" if quantized else "bf16")


# a wire buffer (``transport.decode_tensor``) is a read-only view: a
# dispatch only reads it, so it is wrapped as it is, without the copy
# torch's warning asks for
warnings.filterwarnings("ignore", message="The given NumPy array is not "
                        "writable", category=UserWarning, module=__name__)


def _kernel_builds():
    from veles_tpu_torch.ops import common
    return 1 if common.build_info.get("built") else 0


def _leaf_meta(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), numpy.dtype(
            str(leaf.dtype).replace("torch.", "")).str
    return tuple(numpy.shape(leaf)), numpy.asarray(leaf).dtype.str


def model_digest(plans, params, sample_shape, extra=None):
    """Architecture fingerprint: layer classes, static configs,
    parameter shapes and dtypes, the sample shape and the torch version
    — not the weight values, so retraining keeps the digest."""
    digest = hashlib.sha256()
    digest.update(("torch:%s" % torch.__version__).encode())
    digest.update(repr(tuple(sample_shape)).encode())
    if extra:
        digest.update(repr(extra).encode())
    for plan, entry in zip(plans, params):
        digest.update(plan.forward_cls.__name__.encode())
        digest.update(repr(sorted(plan.static.items())).encode())
        for key in sorted(entry):
            leaf = entry[key]
            if leaf is None:
                digest.update(("%s:none" % key).encode())
            else:
                shape, dtype = _leaf_meta(leaf)
                digest.update(("%s:%s:%s" % (key, shape, dtype)).encode())
    return digest.hexdigest()[:16]


def engine_digest_extra(dtype):
    """The ``extra`` an engine mixes into :func:`model_digest`: the
    input dtype, which the params do not carry."""
    return {"input_dtype": numpy.dtype(dtype).str}


def value_digest(params):
    """Fingerprint of the parameter values, the complement of
    :func:`model_digest`."""
    digest = hashlib.sha256()
    for entry in params:
        for key in sorted(entry):
            leaf = entry[key]
            digest.update(key.encode())
            if leaf is None:
                digest.update(b"none")
            else:
                if isinstance(leaf, torch.Tensor):
                    leaf = leaf.detach().cpu().numpy()
                arr = numpy.ascontiguousarray(numpy.asarray(leaf))
                digest.update(arr.dtype.str.encode())
                digest.update(repr(arr.shape).encode())
                digest.update(arr.tobytes())
    return digest.hexdigest()[:16]


class AOTEngine(Logger):
    """Per-rung forward dispatch with padded runs.

    ``plans``/``params`` are the :mod:`veles_tpu_torch.compiler` plan
    list and the ``[{"weights", "bias", ...}]`` parameter list of host
    numpy arrays in the JAX layouts (f32, or the quantization pass's
    int8 entries); ``sample_shape`` the per-sample input shape;
    ``device`` a :class:`~veles_tpu_torch.backends.Device` (default the
    card).  After :meth:`compile`, :meth:`run` dispatches a device batch
    on an exact rung and :meth:`infer` is the host path: chunk, pad,
    run, slice.
    """

    def __init__(self, plans, params, sample_shape,
                 ladder=DEFAULT_LADDER, device=None,
                 dtype=numpy.float32, **kwargs):
        super(AOTEngine, self).__init__(**kwargs)
        if not plans:
            raise ValueError("AOTEngine needs a non-empty plan list")
        self.plans = list(plans)
        self.params = [dict(entry) for entry in params]
        self.sample_shape = tuple(int(s) for s in sample_shape)
        self.ladder = tuple(sorted({int(b) for b in ladder}))
        if not self.ladder or self.ladder[0] < 1:
            raise ValueError("ladder must hold positive batch sizes")
        if device is None:
            from veles_tpu_torch.backends import Device
            device = Device()
        self.device = device
        self.dtype = numpy.dtype(dtype)
        self._torch_dtype = torch.from_numpy(numpy.zeros(0, self.dtype)).dtype
        from veles_tpu_torch.quant.forward import is_quantized_params
        self.quantized = is_quantized_params(self.params)
        self.digest = model_digest(plans, self.params, self.sample_shape,
                                   extra=engine_digest_extra(self.dtype))
        self.compile_receipt = None
        self.graphs = None
        self._forward = None
        self._params_dev = None
        self._inputs = {}
        # one dispatch at a time: a rung's static input and output are
        # shared by its callers (the batcher's thread, infer)
        self._lock = threading.Lock()
        #: recorded after each dispatch and weight swap on the card; the
        #: next one waits on it, whatever stream it runs on
        self._done = None

    @classmethod
    def from_workflow(cls, sw, **kwargs):
        """Build from a trained StandardWorkflow: its forward plans,
        a host copy of its weights taken now (a later training step
        leaves what the engine serves alone), the loader's sample shape
        (or ``sample_shape=``) and, unless ``device=`` is given, the
        workflow's device."""
        from veles_tpu_torch.serve.router import ReplicaPool
        if kwargs.get("device") is None:
            # resolved first: no card raises before anything is read
            from veles_tpu_torch.backends import Device
            kwargs["device"] = getattr(sw.forwards[0], "device",
                                       None) or Device()
        plans, params, sample_shape = ReplicaPool._workflow_spec(
            sw, kwargs.pop("sample_shape", None))
        return cls(plans, params, sample_shape, **kwargs)

    @property
    def max_batch(self):
        return self.ladder[-1]

    def compile(self):
        """Upload the params, capture every rung's graph on the card and
        dispatch each rung once; returns the receipt."""
        start = time.perf_counter()
        on_card = self.device.torch_device.type == "cuda"
        with introspect.compile_delta() as delta, \
                graphs.capturing() if on_card else contextlib.nullcontext():
            self._params_dev = self._put_params(self.params)
            if on_card:
                self.graphs = GraphOwner("engine", self.device.torch_device)
            if self.quantized:
                from veles_tpu_torch.quant.forward import \
                    build_quantized_forward
                self._forward = build_quantized_forward(self.plans)
            else:
                from veles_tpu_torch.compiler import build_forward
                self._forward = build_forward(self.plans)
            for rung in self.ladder:
                self.run_host(numpy.zeros((rung,) + self.sample_shape,
                                          self.dtype), rung)
            self.device.sync()
        elapsed = time.perf_counter() - start
        self.compile_receipt = {"rungs": list(self.ladder),
                                "seconds": round(elapsed, 4),
                                "quantized": self.quantized,
                                "warmups": len(self.ladder)}
        self.compile_receipt.update(
            self.graphs.receipt if self.graphs is not None else
            {"graphs": 0, "captures": 0, "capture_s": 0.0,
             "warmup_launches": 0, "pool_bytes": 0, "replays": 0,
             "eager_steps": 0})
        # the process's build (the library builds once, at the first
        # launch); new_compiles counts it only where this compile ran it,
        # as the introspection counters saw the captures and the build
        self.compile_receipt["kernel_builds"] = _kernel_builds()
        self.compile_receipt["new_compiles"] = delta.receipt["new_compiles"]
        try:
            # the tuned-schedule provenance of this warm-up: the
            # kernels' consult counters and the cache's population
            from veles_tpu_torch.tune.cache import tune_counters
            self.compile_receipt["tune"] = tune_counters()
        except Exception:
            pass  # a broken schedule cache must never fail a warm-up
        publish_quantized_state(self.quantized)
        self.info("ladder %s warmed in %.2fs on %s%s", list(self.ladder),
                  elapsed, self.device.backend_name,
                  " (int8)" if self.quantized else "")
        return self.compile_receipt

    def _put_params(self, params):
        put = self.device.put
        params_dev = [{key: (None if leaf is None else put(leaf))
                       for key, leaf in entry.items()}
                      for entry in params]
        if self.quantized:
            from veles_tpu_torch.quant.forward import with_kmajor_weights
            params_dev = with_kmajor_weights(params_dev)
        return params_dev

    def swap_params(self, params):
        """Swap the weights under the same architecture.  A digest
        mismatch raises.  On the card the new weights (the int8 K-major
        copies included) are copied into the graphs' parameter buffers
        on the stream, after every dispatch enqueued before and before
        every one after; nothing is captured again.  On the CPU the new
        list is assigned in one step, so an in-flight :meth:`run` keeps
        the list it started with."""
        params = [dict(entry) for entry in params]
        digest = model_digest(self.plans, params, self.sample_shape,
                              extra=engine_digest_extra(self.dtype))
        if digest != self.digest:
            raise ValueError(
                "swap_params digest mismatch (%s != %s): architecture "
                "or shapes changed — build a new engine" %
                (digest, self.digest))
        if self._params_dev is None:
            raise RuntimeError("AOTEngine.compile() not called")
        if self.graphs is None:
            params_dev = self._put_params(params)
            with self._lock:
                self._params_dev = params_dev
                self.params = params
            return digest
        with graphs.shared(), torch.inference_mode(), self._lock:
            self._after_previous()
            params_dev = self._put_params(params)
            for held, entry in zip(self._params_dev, params_dev):
                for key, leaf in entry.items():
                    if leaf is not None:
                        held[key].copy_(leaf)
            self._record_done()
            self.params = params
        return digest

    def _after_previous(self):
        """Order the current stream after the previous dispatch or swap
        (on the card, with the engine's lock held)."""
        if self._done is not None:
            torch.cuda.current_stream(self.device.torch_device).wait_event(
                self._done)

    def _record_done(self):
        if self.device.torch_device.type != "cuda":
            return  # stand-in graphs on the CPU: one stream
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device.torch_device))
        self._done = event

    def rung_for(self, n, cap=None):
        """Smallest ladder rung holding ``n`` samples (the largest rung
        when ``n`` overflows it — callers chunk); ``cap`` bounds it."""
        top = self.ladder[-1] if cap is None else cap
        for rung in self.ladder:
            if rung > top:
                break
            if rung >= n:
                return rung
        return min(top, self.ladder[-1])

    def run(self, x_dev, rung):
        """Dispatch the forward on an exact-rung device batch; returns
        the device output without waiting for it.  On the card: copy
        ``x_dev`` into the rung's static input, replay its graph, and
        return a copy of the output."""
        if tuple(x_dev.shape) != (rung,) + self.sample_shape:
            raise ValueError("rung %d expects %s, got %s" % (
                rung, (rung,) + self.sample_shape, tuple(x_dev.shape)))
        with torch.inference_mode():
            if self.graphs is None:
                return self._forward(self._params_dev, x_dev)
            with graphs.shared(), self._lock:
                self._after_previous()
                self._input(rung).copy_(x_dev)
                return self._replay(rung)

    def run_host(self, batch, rung, split=None):
        """:meth:`run` on a host array of the rung's shape, copied
        straight into the rung's static input on the card (one copy
        fewer); the caller may reuse ``batch`` on return.  ``split``: a
        list to which the ``perf_counter`` readings at the end of the
        copy in and at the end of the launch are appended."""
        batch = torch.from_numpy(numpy.ascontiguousarray(batch, self.dtype))
        if self.graphs is None:
            x_dev = self.device.put(batch)
            if split is not None:
                split.append(time.perf_counter())
            out = self.run(x_dev, rung)
        else:
            if tuple(batch.shape) != (rung,) + self.sample_shape:
                raise ValueError("rung %d expects %s, got %s" % (
                    rung, (rung,) + self.sample_shape, tuple(batch.shape)))
            with graphs.shared(), torch.inference_mode(), self._lock:
                self._after_previous()
                self._input(rung).copy_(batch)
                if split is not None:
                    split.append(time.perf_counter())
                out = self._replay(rung)
        if split is not None:
            split.append(time.perf_counter())
        return out

    def _input(self, rung):
        static = self._inputs.get(rung)
        if static is None:
            static = self._inputs[rung] = torch.zeros(
                (rung,) + self.sample_shape, dtype=self._torch_dtype,
                device=self.device.torch_device)
        return static

    def _replay(self, rung):
        params = self._params_dev
        forward = self._forward

        def body(x):
            return (forward(params, x),)

        out, = self.graphs.graph(("rung", rung), body,
                                 [self._inputs[rung]]).replay()
        out = out.clone()
        self._record_done()
        return out

    def infer(self, x):
        """Host path: pad/chunk ``x`` through the ladder and return the
        output rows as one numpy array."""
        x = numpy.ascontiguousarray(x, self.dtype)
        if x.shape == self.sample_shape:
            x = x[None]
        if x.shape[1:] != self.sample_shape:
            raise ValueError("expected sample shape %s, got %s" %
                             (self.sample_shape, x.shape[1:]))
        if self._params_dev is None:
            raise RuntimeError("AOTEngine.compile() not called")
        out, i, n = [], 0, x.shape[0]
        with graphs.shared():
            while i < n:
                take = min(self.max_batch, n - i)
                rung = self.rung_for(take)
                if take == rung:
                    chunk = x[i:i + rung]
                else:
                    chunk = numpy.zeros((rung,) + self.sample_shape,
                                        self.dtype)
                    chunk[:take] = x[i:i + take]
                result = self.run_host(chunk, rung)
                out.append(result[:take].cpu().numpy())
                i += take
        return numpy.concatenate(out) if len(out) > 1 else out[0]
