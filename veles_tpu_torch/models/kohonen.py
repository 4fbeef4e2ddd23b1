"""Kohonen self-organising map units.

Counterpart of ``veles_tpu/models/kohonen.py``.  :class:`KohonenForward`
computes the winner neuron per sample; :class:`KohonenTrainer` applies
the SOM update ``w += alpha * neigh(dist_to_winner) * (x - w)`` with a
time-decayed learning rate and a gaussian neighbourhood over the (rows,
cols) grid, with JAX's decays, its ``|w|^2 - 2 x.w`` winner search and
its (B, N, F) einsum for the update, so the sums run in the same shape.

The units run on their device (the card unless the CPU is asked for):
the weights stay a device tensor in their Array, each run hands the
Array a new one, and nothing returns to the host until a caller reads
``output`` or ``weights``.  The JAX units pin themselves to the host and
copy back to numpy on every run; the port's do so on the host
pseudo-device (``NumpyDevice``), where each run computes on CPU tensors
copied from the host buffers and writes its result back into ``mem``.
The initial weights are drawn on the
host from the unit's numpy PRNG, as in the JAX package, so one seed
gives the same bits in both.
"""

import numpy
import torch

from veles_tpu_torch import prng as prng_module
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_units import adopt, operand
from veles_tpu_torch.units import Unit

__all__ = ["KohonenForward", "KohonenTrainer"]


def _grid_coords(rows, cols, device="cpu"):
    """(rows * cols, 2) float32 grid coordinates, row-major."""
    rr, cc = torch.meshgrid(torch.arange(rows, device=device),
                            torch.arange(cols, device=device),
                            indexing="ij")
    return torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=1).to(
        torch.float32)


class KohonenBase(Unit):
    def __init__(self, workflow, **kwargs):
        super(KohonenBase, self).__init__(workflow, **kwargs)
        self.shape = tuple(kwargs.get("shape", (8, 8)))  # (rows, cols)
        self.input = None
        self.weights = Array()
        self.prng = kwargs.get("prng", prng_module.get())
        self.device = None
        self.demand("input")

    @property
    def neurons_number(self):
        return self.shape[0] * self.shape[1]

    def initialize(self, device=None, **kwargs):
        self.device = device
        super(KohonenBase, self).initialize(**kwargs)
        if not self.input or self.input.sample_size == 0:
            raise AttributeError("%s: input shape unknown" % self.name)
        if not self.weights:
            w = numpy.zeros(
                (self.neurons_number, self.input.sample_size),
                numpy.float32)
            self.prng.fill(w, -0.5, 0.5)
            self.weights.mem = w
        self.weights.initialize(device)
        return True

    def _operands(self):
        """(weights, input) as tensors on the unit's device (on the
        host run, CPU copies of the host buffers)."""
        return operand(self, self.weights), operand(self, self.input)


class KohonenForward(KohonenBase):
    """output = winner index per sample (argmin distance)."""

    def __init__(self, workflow, **kwargs):
        super(KohonenForward, self).__init__(workflow, **kwargs)
        self.output = Array()

    @staticmethod
    def winners(weights, x):
        """int32 index of the nearest neuron for each row of ``x``."""
        x2 = x.reshape(x.shape[0], -1).to(torch.float32)
        # |x-w|^2 = |x|^2 - 2 x.w + |w|^2 ; |x|^2 constant per row
        cross = x2 @ weights.T
        w_norm = torch.sum(weights * weights, dim=1)
        return torch.argmin(w_norm - 2.0 * cross, dim=1).to(torch.int32)

    def run(self):
        weights, x = self._operands()
        adopt(self, self.output, KohonenForward.winners(weights, x))


class KohonenTrainer(KohonenBase):
    """SOM update with gaussian neighbourhood + decaying radius/alpha."""

    def __init__(self, workflow, **kwargs):
        super(KohonenTrainer, self).__init__(workflow, **kwargs)
        self.alpha = kwargs.get("alpha", 0.3)
        self.alpha_decay = kwargs.get("alpha_decay", 0.995)
        self.radius = kwargs.get("radius", max(self.shape) / 2.0)
        self.radius_decay = kwargs.get("radius_decay", 0.995)
        self.time = 0

    def init_unpickled(self):
        super(KohonenTrainer, self).init_unpickled()
        self._coords_ = None

    @staticmethod
    def update(weights, x, coords, alpha, radius):
        """The weights after one SOM step over the rows of ``x``;
        ``alpha`` and ``radius`` are float32 scalars (numpy), as the JAX
        step takes them."""
        alpha, radius = numpy.float32(alpha), numpy.float32(radius)
        x2 = x.reshape(x.shape[0], -1).to(torch.float32)
        winners = KohonenForward.winners(weights, x2)
        win_coords = coords[winners.long()]                 # (B, 2)
        d2 = torch.sum(
            (coords[None, :, :] - win_coords[:, None, :]) ** 2, dim=2)
        width = float(numpy.float32(2.0) * radius * radius)
        neigh = torch.exp(-d2 / width)                      # (B, N)
        diff = x2[:, None, :] - weights[None, :, :]         # (B, N, F)
        delta = float(alpha) * torch.einsum("bn,bnf->nf", neigh, diff) / \
            x2.shape[0]
        return weights + delta.to(weights.dtype)

    def run(self):
        weights, x = self._operands()
        if self._coords_ is None or self._coords_.device != weights.device:
            self._coords_ = _grid_coords(*self.shape, device=weights.device)
        self.time += 1
        alpha = self.alpha * (self.alpha_decay ** self.time)
        radius = max(self.radius * (self.radius_decay ** self.time), 0.5)
        adopt(self, self.weights,
              KohonenTrainer.update(weights, x, self._coords_, alpha,
                                    radius))
