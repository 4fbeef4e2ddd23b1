"""Devices: where the port's tensors live.

Counterpart of ``veles_tpu/backends.py``.  ``Device(backend="cuda")``,
the default, places tensors on a CUDA card (``device_index``, default
0, the first) and raises when there is none: the port never carries on
quietly on the CPU.  Two host devices run only when asked for:

- ``Device(backend="cpu")`` puts the tensors on the CPU, as the tests
  do; there the kernel wrappers take their plain PyTorch versions;
- ``Device(backend="numpy")`` returns a :class:`NumpyDevice`, the JAX
  package's numpy pseudo-device: it does not exist (``exists`` is
  False), so the Arrays stay host-only and every unit runs on its host
  buffers (``mem``), its math on CPU tensors copied from them
  (``models/nn_units.py``).  It rates itself with ``numpy.dot``.

Nothing picks a host device in place of a missing card, and the JAX
package's ``auto`` ladder is not ported: ``auto`` is refused.

Precision: constructing a device turns TF32 off for float32 matrix
products (``torch.backends.cuda.matmul.allow_tf32``) and for cuDNN
convolutions (``torch.backends.cudnn.allow_tf32``, which PyTorch leaves
on by default), so the f32 forward on the card is true float32, as the
CPU reference is.
"""

import time

import numpy
import torch

__all__ = ["Device", "NumpyDevice", "DeviceInfo"]

BACKENDS = ("cuda", "cpu", "numpy")


class Device(object):
    """A torch device plus the host-to-device copy the engine uses."""

    #: the backend a subclass always has (None: the one asked for)
    BACKEND = None

    def __new__(cls, backend="cuda", device_index=0):
        if cls is Device and backend == "numpy":
            cls = NumpyDevice
        return super(Device, cls).__new__(cls)

    def __init__(self, backend="cuda", device_index=0):
        if backend not in BACKENDS:
            raise ValueError("unknown backend %r (known: %s)" %
                             (backend, ", ".join(BACKENDS)))
        if backend == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Device(backend='cuda'): no CUDA device is available; "
                "pass backend='cpu' to run on the CPU")
        self.backend = backend
        self.device_index = int(device_index)
        self._computing_power = None
        self.torch_device = self._torch_device()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _torch_device(self):
        if self.backend == "cuda":
            return torch.device("cuda", self.device_index)
        return torch.device("cpu")

    @property
    def backend_name(self):
        return self.backend

    #: units and Arrays test this before attaching: False only for the
    #: host pseudo-device (:class:`NumpyDevice`)
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
        return "<%s backend=%s index=%d>" % (
            type(self).__name__, self.backend, self.device_index)

    # -- pickling: a snapshot holds the backend's name, no torch object --

    def __getstate__(self):
        return {"backend": self.backend, "device_index": self.device_index}

    def __setstate__(self, state):
        # a JAX package device (CPUDevice, TPUDevice) arrives without a
        # "backend": it becomes a CPU placeholder, and the restored unit
        # takes the launcher's device at initialize; its NumpyDevice
        # stays one
        backend = state.get("backend")
        self.backend = self.BACKEND or (backend if backend in BACKENDS
                                        else "cpu")
        self.device_index = int(state.get("device_index", 0) or 0) \
            if self.backend == "cuda" else 0
        self._computing_power = None
        self.torch_device = self._torch_device()


class NumpyDevice(Device):
    """The host pseudo-device (``Device(backend="numpy")``, ``-d
    numpy``): counterpart of the JAX package's ``NumpyDevice``.  It
    does not exist, so no Array attaches to it and each unit takes its
    host run; a unit's math still runs on CPU tensors (``put`` copies
    to the CPU, as the CPU device's does).  Its power rating is the
    JAX base device's, ``numpy.dot``."""

    BACKEND = "numpy"
    exists = False

    def __init__(self, backend=BACKEND, device_index=0):
        super(NumpyDevice, self).__init__(self.BACKEND)

    def matmul_fn(self):
        return numpy.dot

    def sync_result(self, result):
        pass


class DeviceInfo(object):
    """Per-card table of kernel settings, keyed by the card's name
    (``torch.cuda.get_device_name()``).  Counterpart of the JAX
    package's per-chip tile table, held in memory only: the port's
    tuned launch parameters persist in the schedule cache
    (``veles_tpu_torch.tune``), and ``ops.matmul.autotune_matmul``
    migrates a hit of this table (``matmul:v<port kernel version>:
    <dtype>:pl<level>:s<size>`` -> ``{"bk", "splits"}``) into it, as the
    JAX package migrates its shipped table.  The JAX package's
    ``devices/device_infos.json`` holds TPU tiles only: the port reads
    nothing from it."""

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
