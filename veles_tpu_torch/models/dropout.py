"""Dropout forward layer.

Counterpart of ``veles_tpu/models/dropout.py``'s ``DropoutForward``.
The dropout is inverted: kept activations are scaled by 1/(1-p) at
training time, so at inference it is the identity and the compiler walk
skips it.  The training mask is ``bernoulli(key, 1 - ratio)`` over the
threefry2x32 key stream of ``veles_tpu_torch.threefry``, JAX's own: one
key gives the JAX package's mask bit for bit."""

import numpy

from veles_tpu_torch import threefry
from veles_tpu_torch.models.nn_units import ForwardBase

__all__ = ["DropoutForward"]


class DropoutForward(ForwardBase):
    """kwargs: dropout_ratio (the probability of DROPPING a unit).  Its
    unit half sizes the output; a per-unit run is not ported (the
    fused step draws the masks)."""

    MAPPING = "dropout"

    def __init__(self, workflow, **kwargs):
        super(DropoutForward, self).__init__(workflow, **kwargs)
        self.dropout_ratio = kwargs.get("dropout_ratio", 0.5)
        self.minibatch_class = None  # linked from loader
        self.demand("minibatch_class")

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
        raise NotImplementedError(
            "the per-unit dropout is not ported (ROADMAP.md Queue 1 item "
            "3): fuse the workflow")

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
