"""Convolutional layers.

Counterpart of ``veles_tpu/models/conv.py``.  The public layout is the
JAX package's: NHWC activations and HWIO weights, ``padding`` =
(left, top, right, bottom) and ``sliding`` = (sx, sy).  Inside, the
NHWC tensor is viewed as NCHW in channels-last memory (a permute, no
copy) for ``F.conv2d``, and the result is viewed back.  Asymmetric
padding is applied with ``F.pad`` before the conv.

``Conv.apply`` always goes through ``ops/conv_vjp.py``'s ``conv_act``,
on the card and on the CPU alike: the forward is the composition
below, and a gradient taken through it runs the fused backward (the
``conv_wgrad`` kernel on the card).  ``ACTIVATION`` names the
activation's backward epilogue.
"""

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch.models.all2all import (
    All2All, All2AllRELU, All2AllSigmoid, All2AllStrictRELU, All2AllTanh)
from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.ops.conv_vjp import conv_act

__all__ = ["Conv", "ConvTanh", "ConvRELU", "ConvStrictRELU",
           "ConvSigmoid", "forward_activation"]


def _norm_padding(padding):
    if isinstance(padding, int):
        return (padding, padding, padding, padding)
    if len(padding) == 2:
        return (padding[0], padding[1], padding[0], padding[1])
    return tuple(padding)


def conv2d(x, w, padding, sliding):
    """NHWC x, HWIO w -> NHWC conv output (no bias)."""
    left, top, right, bottom = padding
    sx, sy = sliding
    xc = x.permute(0, 3, 1, 2)
    if left == right and top == bottom:
        pad = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        pad = (0, 0)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    z = F.conv2d(xc.contiguous(memory_format=torch.channels_last), wc,
                 stride=(sy, sx), padding=pad)
    return z.permute(0, 2, 3, 1)


def forward_activation(activation):
    """The forward activation by epilogue name: the all2all classes'
    own ``_activate``, so the conv and all2all forwards cannot drift."""
    return {
        "linear": All2All,
        "strict_relu": All2AllStrictRELU,
        "relu_log": All2AllRELU,
        "tanh": All2AllTanh,
        "sigmoid": All2AllSigmoid,
    }[activation]._activate


class Conv(ForwardBase):
    """y = activation(conv2d(x, W) + b).

    kwargs: n_kernels, kx, ky (kernel width/height), sliding=(sx, sy),
    padding=(left, top, right, bottom) or int, plus the ForwardBase
    weight-init kwargs (fan_in = kx * ky * input channels)."""

    MAPPING = "conv"
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super(Conv, self).__init__(workflow, **kwargs)
        self.n_kernels = kwargs["n_kernels"]
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.padding = _norm_padding(kwargs.get("padding", 0))

    def static_config(self):
        return {"padding": self.padding, "sliding": self.sliding}

    def output_spatial(self, in_h, in_w):
        left, top, right, bottom = self.padding
        sx, sy = self.sliding
        return ((in_h + top + bottom - self.ky) // sy + 1,
                (in_w + left + right - self.kx) // sx + 1)

    def create_params(self):
        if not self.input or self.input.sample_size == 0:
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        shape = self.input.shape
        batch, in_h, in_w, in_ch = shape + (1,) if len(shape) == 3 \
            else shape
        fan_in = self.kx * self.ky * in_ch
        if not self.output:
            out_h, out_w = self.output_spatial(in_h, in_w)
            self.output.mem = numpy.zeros(
                (batch, out_h, out_w, self.n_kernels), numpy.float32)
        if self.weights:
            return
        weights = numpy.zeros(
            (self.ky, self.kx, in_ch, self.n_kernels), numpy.float32)
        self.fill_array(weights, self.weights_filling, self.weights_stddev,
                        fan_in)
        self.weights.mem = weights
        if self.include_bias:
            bias = numpy.zeros((self.n_kernels,), numpy.float32)
            self.fill_array(bias, self.bias_filling, self.bias_stddev,
                            fan_in)
            self.bias.mem = bias

    @staticmethod
    def _activate(z):
        return z

    @classmethod
    def apply(cls, params, x, *, padding=(0, 0, 0, 0), sliding=(1, 1)):
        if x.ndim == 3:
            x = x[..., None]
        return conv_act(x, params["weights"], params.get("bias"),
                        activation=cls.ACTIVATION, padding=padding,
                        sliding=sliding)


class ConvTanh(Conv):
    ACTIVATION = "tanh"
    MAPPING = "conv_tanh"
    _activate = staticmethod(All2AllTanh._activate)


class ConvRELU(Conv):
    ACTIVATION = "relu_log"
    MAPPING = "conv_relu"
    _activate = staticmethod(All2AllRELU._activate)


class ConvStrictRELU(Conv):
    ACTIVATION = "strict_relu"
    MAPPING = "conv_str"
    _activate = staticmethod(All2AllStrictRELU._activate)


class ConvSigmoid(Conv):
    ACTIVATION = "sigmoid"
    MAPPING = "conv_sigmoid"
    _activate = staticmethod(All2AllSigmoid._activate)
