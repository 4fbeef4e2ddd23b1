"""Dropout forward layer.

Counterpart of ``veles_tpu/models/dropout.py``'s ``DropoutForward``.
The dropout is inverted: kept activations are scaled by 1/(1-p) at
training time, so at inference it is the identity and the compiler walk
skips it.  The training mask comes from an explicit ``torch.Generator``
where the JAX package uses a threefry key: one seed gives other bits in
the two packages, so a test compares the keep rate and the scale, or
runs keyless steps, where dropout is the identity on both sides."""

import torch

from veles_tpu_torch.models.nn_units import ForwardBase

__all__ = ["DropoutForward"]


class DropoutForward(ForwardBase):
    MAPPING = "dropout"

    @classmethod
    def apply(cls, params, x, *, dropout_ratio=0.5):
        return x

    @staticmethod
    def make_mask(generator, shape, ratio, dtype, device):
        """Bernoulli(1 - ratio) keep mask scaled by 1 / (1 - ratio),
        drawn from ``generator`` (which lives on ``device``)."""
        keep = 1.0 - ratio
        draw = torch.rand(shape, generator=generator, device=device)
        return (draw < keep).to(dtype) / keep
