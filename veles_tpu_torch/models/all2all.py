"""Fully-connected ("all-to-all") forward layers.

Counterpart of ``veles_tpu/models/all2all.py``: linear, scaled tanh,
RELU (the softplus form), StrictRELU, sigmoid and softmax.  Weights are
(fan_in, fan_out), so ``x @ W`` needs no transpose, as on the JAX side.
"""

import torch

from veles_tpu_torch.models.nn_units import ForwardBase

__all__ = ["All2All", "All2AllTanh", "All2AllRELU", "All2AllStrictRELU",
           "All2AllSigmoid", "All2AllSoftmax"]


class All2All(ForwardBase):
    """y = activation(x @ W + b); the base class is linear."""

    MAPPING = "all2all"

    @staticmethod
    def _activate(z):
        return z

    @classmethod
    def apply(cls, params, x):
        x2 = x.reshape(x.shape[0], -1)
        z = x2.to(torch.float32) @ params["weights"]
        if params.get("bias") is not None:
            z = z + params["bias"]
        return cls._activate(z).to(x2.dtype)


class All2AllTanh(All2All):
    """Scaled tanh y = 1.7159 * tanh(0.6666 * x)."""

    MAPPING = "all2all_tanh"
    A = 1.7159
    B = 0.6666

    @staticmethod
    def _activate(z):
        return All2AllTanh.A * torch.tanh(All2AllTanh.B * z)


class All2AllRELU(All2All):
    """Znicz 'RELU': y = log(1 + exp(x)) (softplus), passed through
    where x > 15."""

    MAPPING = "all2all_relu"

    @staticmethod
    def _activate(z):
        return torch.where(z > 15, z,
                           torch.log1p(torch.exp(torch.clamp(z, max=15))))


class All2AllStrictRELU(All2All):
    """y = max(x, 0)."""

    MAPPING = "all2all_str"

    @staticmethod
    def _activate(z):
        return torch.clamp(z, min=0)


class All2AllSigmoid(All2All):
    """y = 1 / (1 + exp(-x))."""

    MAPPING = "all2all_sigmoid"

    @staticmethod
    def _activate(z):
        return torch.sigmoid(z)


class All2AllSoftmax(All2All):
    """Softmax output layer.  The compiler walk keeps its logits and
    applies the softmax once at the tail."""

    MAPPING = "softmax"

    @staticmethod
    def _activate(z):
        return torch.softmax(z, dim=-1)
