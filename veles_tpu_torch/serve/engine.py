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
eager route.  A persistent cache of compiled graphs is later work.

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

import hashlib
import threading
import time

import numpy
import torch

from veles_tpu_torch.graphs import GraphOwner
from veles_tpu_torch.logger import Logger

__all__ = ["AOTEngine", "model_digest", "engine_digest_extra",
           "value_digest", "DEFAULT_LADDER"]

#: default batch-shape ladder
DEFAULT_LADDER = (1, 8, 32, 128)


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

    @property
    def max_batch(self):
        return self.ladder[-1]

    def compile(self):
        """Upload the params, capture every rung's graph on the card and
        dispatch each rung once; returns the receipt."""
        start = time.perf_counter()
        self._params_dev = self._put_params(self.params)
        if self.device.torch_device.type == "cuda":
            self.graphs = GraphOwner("engine", self.device.torch_device)
        if self.quantized:
            from veles_tpu_torch.quant.forward import \
                build_quantized_forward
            self._forward = build_quantized_forward(self.plans)
        else:
            from veles_tpu_torch.compiler import build_forward
            self._forward = build_forward(self.plans)
        warmups = 0
        for rung in self.ladder:
            x = numpy.zeros((rung,) + self.sample_shape, self.dtype)
            self.run_host(x, rung)
            warmups += 1
        self.device.sync()
        elapsed = time.perf_counter() - start
        self.compile_receipt = {"rungs": list(self.ladder),
                                "seconds": round(elapsed, 4),
                                "quantized": self.quantized,
                                "warmups": warmups}
        self.compile_receipt.update(
            self.graphs.receipt if self.graphs is not None else
            {"graphs": 0, "captures": 0, "capture_s": 0.0,
             "warmup_launches": 0, "pool_bytes": 0, "replays": 0,
             "eager_steps": 0})
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
        params_dev = self._put_params(params)
        with self._lock:
            if self.graphs is None:
                self._params_dev = params_dev
            else:
                for held, entry in zip(self._params_dev, params_dev):
                    for key, leaf in entry.items():
                        if leaf is not None:
                            held[key].copy_(leaf)
            self.params = params
        return digest

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
            with self._lock:
                self._input(rung).copy_(x_dev)
                return self._replay(rung)

    def run_host(self, batch, rung):
        """:meth:`run` on a host array of the rung's shape, copied
        straight into the rung's static input on the card (one copy
        fewer); the caller may reuse ``batch`` on return."""
        if self.graphs is None:
            return self.run(self.device.put(batch), rung)
        batch = torch.from_numpy(numpy.ascontiguousarray(batch,
                                                         self.dtype))
        if tuple(batch.shape) != (rung,) + self.sample_shape:
            raise ValueError("rung %d expects %s, got %s" % (
                rung, (rung,) + self.sample_shape, tuple(batch.shape)))
        with torch.inference_mode(), self._lock:
            self._input(rung).copy_(batch)
            return self._replay(rung)

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
        return out.clone()

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
