"""Devices: where the port's tensors live.

Counterpart of ``veles_tpu/backends.py``.  ``Device(backend="cuda")``,
the default, places tensors on the first CUDA card and raises when
there is none: the port never carries on quietly on the CPU.  Only
``Device(backend="cpu")`` asks for the CPU, as the tests do; there the
kernel wrappers take their plain PyTorch versions.

Precision: constructing a device turns TF32 off for float32 matrix
products (``torch.backends.cuda.matmul.allow_tf32``) and for cuDNN
convolutions (``torch.backends.cudnn.allow_tf32``, which PyTorch leaves
on by default), so the f32 forward on the card is true float32, as the
CPU reference is.
"""

import time

import numpy
import torch

__all__ = ["Device", "DeviceInfo"]

BACKENDS = ("cuda", "cpu")


class Device(object):
    """A torch device plus the host-to-device copy the engine uses."""

    def __init__(self, backend="cuda"):
        if backend not in BACKENDS:
            raise ValueError("unknown backend %r (known: %s)" %
                             (backend, ", ".join(BACKENDS)))
        if backend == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Device(backend='cuda'): no CUDA device is available; "
                "pass backend='cpu' to run on the CPU")
        self.backend = backend
        self._computing_power = None
        self.torch_device = torch.device("cuda", 0) \
            if backend == "cuda" else torch.device("cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @property
    def backend_name(self):
        return self.backend

    #: units and Arrays test this before attaching (the JAX package's
    #: devices without hardware answer False; every port device exists)
    exists = True

    def put(self, array):
        """numpy array (or tensor) -> a contiguous tensor on this
        device that owns its memory: the caller may reuse or free
        ``array`` right after (the batcher's staging buffers rely on
        it)."""
        if not isinstance(array, torch.Tensor):
            array = torch.from_numpy(numpy.ascontiguousarray(array))
        return array.to(self.torch_device, copy=True).contiguous()

    def sync(self):
        if self.backend == "cuda":
            torch.cuda.synchronize(self.torch_device)

    @property
    def computing_power(self):
        """Benchmark-derived rating used for job load balancing: 1000 /
        seconds per 1024-cubed float32 product, measured once."""
        if self._computing_power is None:
            self._computing_power = self._measure_power()
        return self._computing_power

    def _measure_power(self):
        size = 1024
        a = numpy.random.RandomState(13).rand(size, size).astype(
            numpy.float32)
        fn = self.matmul_fn()
        fn(a, a)  # warm-up
        # perf_counter: a wall-clock step here would misweight the slave
        # for as long as it serves
        start = time.perf_counter()
        for _ in range(3):
            result = fn(a, a)
        self.sync_result(result)
        elapsed = (time.perf_counter() - start) / 3
        return 1000.0 / max(elapsed, 1e-9)

    def matmul_fn(self):
        """(a, b) host arrays -> their float32 product on this device,
        through ``torch.matmul`` (TF32 off), as the JAX device rates
        itself through ``jnp.dot``."""
        def run(a, b):
            return torch.matmul(self.put(a), self.put(b))
        return run

    def sync_result(self, result):
        """Wait until ``result`` is computed."""
        if result.is_cuda:
            torch.cuda.synchronize(result.device)

    def __repr__(self):
        return "<Device backend=%s>" % self.backend


class DeviceInfo(object):
    """Per-card table of kernel settings, keyed by the card's name
    (``torch.cuda.get_device_name()``).  Counterpart of the JAX
    package's per-chip tile table; held in memory only — the port's
    one kernel uses one fixed tile and persists nothing."""

    def __init__(self, device_kind=None):
        if device_kind is None:
            device_kind = torch.cuda.get_device_name() \
                if torch.cuda.is_available() else "cpu"
        self.device_kind = device_kind
        self.table = {}

    def get(self, op_key, default=None):
        return self.table.get(op_key, default)

    def put(self, op_key, value):
        self.table[op_key] = value
