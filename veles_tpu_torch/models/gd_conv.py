"""Gradient-descent units for conv layers.

Counterpart of ``veles_tpu/models/gd_conv.py``.  The backward is
``ops/conv_vjp.py``'s ``fused_conv_vjp`` on the stored forward output
y: the activation's derivative, grad_w and grad_b in the ``conv_wgrad``
kernel on a CUDA tensor (its plain version on a CPU one), then the dgrad
(a transposed conv) unless the layer is the first.  Then the shared
regularization, solver step and skip-step guard
(:meth:`GradientDescentBase.descend`).  The wrapper is looked up in its
module at each call, so a swap of ``conv_vjp.conv_wgrad`` reaches it.
"""

import torch

from veles_tpu_torch.models.conv import _norm_padding
from veles_tpu_torch.models.gd import GradientDescent
from veles_tpu_torch.models.nn_units import GradientDescentBase
from veles_tpu_torch.ops import conv_vjp

__all__ = ["GDConv", "GDConvTanh", "GDConvRELU", "GDConvStrictRELU",
           "GDConvSigmoid"]


class GDConv(GradientDescent):
    """kwargs: the conv layer's sliding and padding, plus the solver
    kwargs of :class:`GradientDescentBase`."""

    MAPPING = "conv"
    #: the backward epilogue's name (the forward class's ACTIVATION)
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super(GDConv, self).__init__(workflow, **kwargs)
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.padding = _norm_padding(kwargs.get("padding", 0))

    def backward_static(self):
        return {"padding": self.padding, "sliding": self.sliding}

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, padding=(0, 0, 0, 0),
                 sliding=(1, 1)):
        x4 = x[..., None] if x.ndim == 3 else x
        err_input, grad_w, grad_b = conv_vjp.fused_conv_vjp(
            x4, state["weights"], y, err_output, activation=cls.ACTIVATION,
            padding=padding, sliding=sliding, include_bias=include_bias,
            need_err_input=need_err_input)
        if err_input is not None:
            err_input = err_input.reshape(x.shape)
        new_state = GradientDescentBase.descend(
            state, hyper, solver, grad_w.to(torch.float32), grad_b)
        return err_input, new_state


class GDConvTanh(GDConv):
    MAPPING = "conv_tanh"
    ACTIVATION = "tanh"


class GDConvRELU(GDConv):
    MAPPING = "conv_relu"
    ACTIVATION = "relu_log"


class GDConvStrictRELU(GDConv):
    MAPPING = "conv_str"
    ACTIVATION = "strict_relu"


class GDConvSigmoid(GDConv):
    MAPPING = "conv_sigmoid"
    ACTIVATION = "sigmoid"
