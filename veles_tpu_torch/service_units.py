"""Utility units over the ops layer.

Counterpart of ``veles_tpu/service_units.py``: ``InputJoiner`` (N input
Arrays side by side, ``ops.join``), ``MeanDispNormalizer``
(``(x - mean) * rdisp``, ``ops.normalize.mean_disp_normalize``),
``Avatar`` (mirrors of other units' Arrays) and ``Shell`` (an
interactive prompt mid-workflow).  The first two launch the ``join`` and
``mean_disp_normalize`` kernels on the card; on a CPU device they run
the kernels' plain versions.
"""

import numpy
import torch

from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_units import _require_device
from veles_tpu_torch.ops.join import join
from veles_tpu_torch.ops.normalize import mean_disp_normalize
from veles_tpu_torch.units import Unit

__all__ = ["InputJoiner", "MeanDispNormalizer", "Avatar", "Shell"]


class InputJoiner(Unit):
    """Concatenates N input Arrays along axis 1 (``ops.join``) into
    ``output``, in the first input's dtype.  Unlike the JAX unit,
    initialize sizes ``output`` (and re-queues itself while an input is
    still empty), so a forward unit after it can create its weights at
    initialize."""

    def __init__(self, workflow, **kwargs):
        super(InputJoiner, self).__init__(workflow, **kwargs)
        self.inputs = list(kwargs.get("inputs", ()))
        self.output = Array()
        self.device = None

    def link_inputs(self, *pairs):
        """pairs: (unit, attr_name) whose Arrays join in order."""
        for unit, attr in pairs:
            self.inputs.append(getattr(unit, attr))
        return self

    def initialize(self, device=None, **kwargs):
        self.device = device
        super(InputJoiner, self).initialize(**kwargs)
        if not self.inputs:
            raise ValueError("InputJoiner needs at least one input")
        if not all(self.inputs):
            # an input's shape is not known yet -> the workflow re-queues
            raise AttributeError(
                "%s: input shapes unknown at initialize" % self.name)
        # sized now, so the unit after this one can size its parameters
        # at initialize
        self.output.mem = numpy.zeros(
            (len(self.inputs[0]), sum(a.sample_size for a in self.inputs)),
            self.inputs[0].dtype)
        return True

    def run(self):
        device = _require_device(self)
        parts = [arr.device_array(device) for arr in self.inputs]
        self.output.set_device_array(join(*parts), device)


class MeanDispNormalizer(Unit):
    """output = (input - mean) * rdisp elementwise over samples.

    ``mean`` and ``rdisp`` are Arrays or host arrays of the input's
    sample size, in any float dtype (a ``MeanDispersionNormalizer``'s
    are float64).  Each run casts them to float32, as the JAX package's
    ``device.put`` does with x64 off, and copies them to the device
    without blocking the host, as that ``put`` does.

    Unlike the JAX unit, initialize sizes ``output`` from the input (and
    re-queues itself while the input is still empty), so the forward
    unit linked after it can create its weights at initialize: with the
    JAX unit in front of ``forwards[0]``, a workflow's initialize
    deadlocks."""

    def __init__(self, workflow, **kwargs):
        super(MeanDispNormalizer, self).__init__(workflow, **kwargs)
        self.input = None   # linked Array
        self.mean = None    # linked Array or ndarray
        self.rdisp = None
        self.output = Array()
        self.device = None
        self.demand("input", "mean", "rdisp")

    def initialize(self, device=None, **kwargs):
        self.device = device
        super(MeanDispNormalizer, self).initialize(**kwargs)
        if not self.input:
            # input shape not known yet -> the workflow re-queues us
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        # sized now, so the unit after this one can size its parameters
        # at initialize
        self.output.mem = numpy.zeros(self.input.shape, numpy.float32)
        return True

    @staticmethod
    def _as_host(value):
        if hasattr(value, "map_read"):
            value.map_read()
            return value.mem
        return numpy.asarray(value)

    def run(self):
        device = _require_device(self)
        mean, rdisp = (
            torch.from_numpy(self._as_host(v).astype(numpy.float32).ravel())
            .to(device.torch_device, non_blocking=True)
            for v in (self.mean, self.rdisp))
        x = self.input.device_array(device)
        self.output.set_device_array(mean_disp_normalize(x, mean, rdisp),
                                     device)


class Avatar(Unit):
    """Mirrors a set of source Arrays into its own Arrays each run.  A
    device mirror shares the source's tensor: no unit updates a tensor
    in place, so the two cannot diverge by a write to either (a host
    write to the mirror goes to the mirror's own copy)."""

    def __init__(self, workflow, **kwargs):
        super(Avatar, self).__init__(workflow, **kwargs)
        self._pairs = []  # (source Array, mirror Array)
        self.device = None

    def clone(self, unit, *attrs):
        """Mirror unit.<attr> into self.<attr>; returns self."""
        for attr in attrs:
            source = getattr(unit, attr)
            mirror = Array()
            setattr(self, attr, mirror)
            self._pairs.append((source, mirror))
        return self

    def initialize(self, device=None, **kwargs):
        self.device = device
        return super(Avatar, self).initialize(**kwargs)

    def run(self):
        for source, mirror in self._pairs:
            if self.device is not None and source.device is not None:
                mirror.set_device_array(source.devmem, self.device)
            else:
                source.map_read()
                mirror.map_invalidate()
                mirror.mem = numpy.array(source.mem)


class Shell(Unit):
    """Drops into an interactive shell mid-workflow (``code.interact``
    with the workflow in scope); a no-op unless stdin is a tty or
    ``force=True``, so unattended runs never block."""

    def __init__(self, workflow, **kwargs):
        super(Shell, self).__init__(workflow, **kwargs)
        self.force = kwargs.get("force", False)
        self.banner = kwargs.get(
            "banner", "veles_tpu_torch shell: `workflow` is live; ^D "
                      "resumes")

    def run(self):
        import sys
        if not self.force and not sys.stdin.isatty():
            return
        import code
        code.interact(banner=self.banner,
                      local={"workflow": self.workflow, "unit": self,
                             "torch": torch})
