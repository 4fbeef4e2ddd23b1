"""Dropout forward and backward units.

Counterpart of ``veles_tpu/models/dropout.py``.  The dropout is
inverted: kept activations are scaled by 1/(1-p) at training time, so
at inference it is the identity and the compiler walk skips it.  The
training mask is ``bernoulli(key, 1 - ratio)`` over the threefry2x32
key stream of ``veles_tpu_torch.threefry``, JAX's own: one key gives
the JAX package's mask bit for bit.

Per unit, :class:`DropoutForward` counts its runs in ``_step`` (the
evaluation minibatches too, as the JAX unit does) and keys a train
minibatch's mask with ``fold_in(key(seed), _step)``, ``seed`` the
unit's numpy generator's seed: the masks depend only on the seed and
the step, so two runs from one state draw the same ones.  On an
evaluation minibatch it passes the input through and resets ``mask``;
:class:`DropoutBackward` then passes err_output through.  On the host
pseudo-device (``NumpyDevice``) both take their host runs, as the JAX
units do: the mask is drawn on the CPU from the same key (the JAX host
mask bit for bit) and every result is copied into the host buffers.
The fused step draws its own masks (``compiler._forward_for_loss``)."""

import numpy
import torch

from veles_tpu_torch import threefry
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_units import (ForwardBase, GradientDescentBase,
                                             adopt, operand)

__all__ = ["DropoutForward", "DropoutBackward"]


class DropoutForward(ForwardBase):
    """kwargs: dropout_ratio (the probability of DROPPING a unit)."""

    MAPPING = "dropout"

    def __init__(self, workflow, **kwargs):
        super(DropoutForward, self).__init__(workflow, **kwargs)
        self.dropout_ratio = kwargs.get("dropout_ratio", 0.5)
        self.minibatch_class = None  # linked from loader
        self.mask = Array()
        self.demand("minibatch_class")
        self._step = 0

    def static_config(self):
        return {"dropout_ratio": self.dropout_ratio}

    def param_arrays(self):
        return []

    def create_params(self):
        if not self.input or self.input.sample_size == 0:
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        if not self.output:
            self.output.mem = numpy.zeros(self.input.shape, numpy.float32)

    def run(self):
        self._step += 1
        x = operand(self, self.input)
        if self.minibatch_class != TRAIN:
            adopt(self, self.output, x)
            self.mask.reset()
            return
        key = threefry.fold_in(
            threefry.key((self.prng.seed_value or 0) & 0xffffffff),
            self._step & 0xffffffff)
        mask = DropoutForward.make_mask(key, x.shape, self.dropout_ratio,
                                        x.dtype, x.device)
        adopt(self, self.output, x * mask)
        adopt(self, self.mask, mask)

    @classmethod
    def apply(cls, params, x, *, dropout_ratio=0.5):
        return x

    @staticmethod
    def make_mask(key, shape, ratio, dtype, device):
        """Bernoulli(1 - ratio) keep mask scaled by 1 / (1 - ratio),
        drawn on ``device`` from the threefry ``key`` (a pair of ints),
        as ``jax.random.bernoulli`` draws it."""
        keep = 1.0 - ratio
        return threefry.bernoulli(key, keep, shape, device).to(dtype) / keep


class DropoutBackward(GradientDescentBase):
    """err_input = err_output * mask (the identity where the forward
    reset its mask)."""

    MAPPING = "dropout"

    def __init__(self, workflow, **kwargs):
        super(DropoutBackward, self).__init__(workflow, **kwargs)
        self.mask = None  # linked from DropoutForward
        self._demanded -= {"weights", "output", "input"}
        self.demand("mask")

    def _init_solver_state(self):
        pass

    def run(self):
        err = operand(self, self.err_output)
        if self.mask:
            with torch.no_grad():
                err = err * operand(self, self.mask)
        adopt(self, self.err_input, err)
