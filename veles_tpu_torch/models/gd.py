"""Gradient-descent units for the fully-connected family.

Counterpart of ``veles_tpu/models/gd.py``: the whole backward of a
layer — activation derivative, err_input, weight and bias gradients
with L1/L2 regularization, the skip-step guard and the solver update —
in one ``backward`` over tensors.  Activation derivatives are expressed
through the forward OUTPUT y, as in the JAX package; the fused step
differentiates with autograd instead, so the two paths agree to
rounding, not bit for bit.
"""

import torch

from veles_tpu_torch.models.all2all import All2AllTanh
from veles_tpu_torch.models.nn_units import GradientDescentBase

__all__ = ["GradientDescent", "GDTanh", "GDRELU", "GDStrictRELU",
           "GDSigmoid", "GDSoftmax"]


class GradientDescent(GradientDescentBase):
    """Backward for linear All2All."""

    MAPPING = "all2all"

    @staticmethod
    def _activation_grad(y, err):
        return err

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input):
        W = state["weights"]
        x2 = x.reshape(x.shape[0], -1)
        err = cls._activation_grad(y, err_output).to(torch.float32)

        err_input = None
        if need_err_input:
            err_input = (err @ W.t()).to(x.dtype).reshape(x.shape)

        grad_w = x2.t().to(torch.float32) @ err
        grad_b = err.sum(dim=0) if include_bias else None
        new_state = GradientDescentBase.descend(state, hyper, solver,
                                                grad_w, grad_b)
        return err_input, new_state


class GDSoftmax(GradientDescent):
    """The evaluator already produced d(CE + softmax)/dz; pass through."""

    MAPPING = "softmax"


class GDTanh(GradientDescent):
    """y = 1.7159 * tanh(0.6666 x)  =>  dy/dx = (B/A) * (A^2 - y^2)."""

    MAPPING = "all2all_tanh"

    @staticmethod
    def _activation_grad(y, err):
        a, b = All2AllTanh.A, All2AllTanh.B
        return err * ((b / a) * (a * a - y * y))


class GDRELU(GradientDescent):
    """y = log(1 + exp(x))  =>  dy/dx = 1 - exp(-y)."""

    MAPPING = "all2all_relu"

    @staticmethod
    def _activation_grad(y, err):
        return err * (1.0 - torch.exp(-y))


class GDStrictRELU(GradientDescent):
    """y = max(x, 0)  =>  dy/dx = [y > 0]."""

    MAPPING = "all2all_str"

    @staticmethod
    def _activation_grad(y, err):
        return err * (y > 0)


class GDSigmoid(GradientDescent):
    """y = sigmoid(x)  =>  dy/dx = y * (1 - y)."""

    MAPPING = "all2all_sigmoid"

    @staticmethod
    def _activation_grad(y, err):
        return err * (y * (1.0 - y))
