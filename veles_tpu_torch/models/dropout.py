"""Dropout forward layer, inference only.

Counterpart of ``veles_tpu/models/dropout.py``'s ``DropoutForward``.
The JAX dropout is inverted (kept activations are scaled at training
time), so at inference it is the identity; the compiler walk skips it.
The training mask is not ported yet."""

from veles_tpu_torch.models.nn_units import ForwardBase

__all__ = ["DropoutForward"]


class DropoutForward(ForwardBase):
    MAPPING = "dropout"

    @classmethod
    def apply(cls, params, x, *, dropout_ratio=0.5):
        return x
