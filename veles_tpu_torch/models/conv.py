"""Convolutional forward layers (the f32 forward only).

Counterpart of ``veles_tpu/models/conv.py``.  The public layout is the
JAX package's: NHWC activations and HWIO weights, ``padding`` =
(left, top, right, bottom) and ``sliding`` = (sx, sy).  Inside, the
NHWC tensor is viewed as NCHW in channels-last memory (a permute, no
copy) for ``F.conv2d``, and the result is viewed back.  Asymmetric
padding is applied with ``F.pad`` before the conv.
"""

import torch
import torch.nn.functional as F

from veles_tpu_torch.models.all2all import (
    All2AllRELU, All2AllSigmoid, All2AllStrictRELU, All2AllTanh)
from veles_tpu_torch.models.nn_units import ForwardBase

__all__ = ["Conv", "ConvTanh", "ConvRELU", "ConvStrictRELU",
           "ConvSigmoid"]


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


class Conv(ForwardBase):
    """y = activation(conv2d(x, W) + b)."""

    MAPPING = "conv"

    @staticmethod
    def _activate(z):
        return z

    @classmethod
    def apply(cls, params, x, *, padding=(0, 0, 0, 0), sliding=(1, 1)):
        if x.ndim == 3:
            x = x[..., None]
        z = conv2d(x.to(torch.float32), params["weights"], padding,
                   sliding)
        if params.get("bias") is not None:
            z = z + params["bias"]
        return cls._activate(z).to(x.dtype)


class ConvTanh(Conv):
    MAPPING = "conv_tanh"
    _activate = staticmethod(All2AllTanh._activate)


class ConvRELU(Conv):
    MAPPING = "conv_relu"
    _activate = staticmethod(All2AllRELU._activate)


class ConvStrictRELU(Conv):
    MAPPING = "conv_str"
    _activate = staticmethod(All2AllStrictRELU._activate)


class ConvSigmoid(Conv):
    MAPPING = "conv_sigmoid"
    _activate = staticmethod(All2AllSigmoid._activate)
