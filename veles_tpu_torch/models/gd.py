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
        grad_w = GradientDescentBase.regularized(
            grad_w, W, hyper["weights_decay"], hyper["l1_vs_l2"])
        new_w, acc_w, acc2_w = GradientDescentBase.solver_update(
            solver, W, grad_w.to(W.dtype), state["accum_weights"],
            state["accum2_weights"], hyper["learning_rate"],
            hyper["gradient_moment"], hyper["adadelta_rho"],
            hyper["solver_epsilon"])
        new_state = {"weights": new_w, "accum_weights": acc_w,
                     "accum2_weights": acc2_w}

        grad_b = None
        if include_bias:
            b = state["bias"]
            grad_b = err.sum(dim=0)
            grad_b = GradientDescentBase.regularized(
                grad_b, b, hyper["weights_decay_bias"], hyper["l1_vs_l2"])
            new_b, acc_b, acc2_b = GradientDescentBase.solver_update(
                solver, b, grad_b.to(b.dtype), state["accum_bias"],
                state["accum2_bias"], hyper["learning_rate_bias"],
                hyper["gradient_moment_bias"], hyper["adadelta_rho"],
                hyper["solver_epsilon"])
            new_state.update({"bias": new_b, "accum_bias": acc_b,
                              "accum2_bias": acc2_b})
        # a non-finite gradient SKIPS the update; the "skipped" flag
        # rides the returned dict
        new_state = GradientDescentBase.finite_guard(
            state, new_state, grad_w, grad_b)
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
