"""Pooling layers.

Counterpart of ``veles_tpu/models/pooling.py``: ceil-mode windows,
where a partial window at the bottom or right edge counts.  The input
is padded on the bottom and right only (with -inf for max, 0 for the
average, whose divisor stays the full window) and then pooled without
further padding.  ``window`` is (ky, kx) but ``sliding`` is (sx, sy).

``MaxPooling.apply`` always goes through ``ops/pool_bwd.py``'s
``max_pool``: a gradient taken through it runs the select-and-scatter
backward (the ``max_pool_bwd`` kernel on the card).  The other pools
take PyTorch's own autograd, as the JAX package takes autodiff.
"""

import numpy
import torch.nn.functional as F

from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.ops.pool_bwd import max_pool

__all__ = ["MaxPooling", "AvgPooling", "MaxAbsPooling"]


def _out_len(in_len, k, stride):
    """Ceil-mode output length: partial windows at the edge count."""
    if in_len <= k:
        return 1
    return -(-(in_len - k) // stride) + 1


def _pool(x, window, sliding, fill, pool_fn):
    """NHWC x -> NHWC pooled, padded bottom/right with ``fill``."""
    ky, kx = window
    sx, sy = sliding
    pad_h = max(0, (_out_len(x.shape[1], ky, sy) - 1) * sy + ky -
                x.shape[1])
    pad_w = max(0, (_out_len(x.shape[2], kx, sx) - 1) * sx + kx -
                x.shape[2])
    xc = x.permute(0, 3, 1, 2)
    if pad_h or pad_w:
        xc = F.pad(xc, (0, pad_w, 0, pad_h), value=fill)
    return pool_fn(xc, (ky, kx), (sy, sx)).permute(0, 2, 3, 1)


class PoolingBase(ForwardBase):
    """kwargs: kx, ky (window), sliding=(sx, sy), default the window.
    Parameter-less: its output shape is sized at initialize."""

    def __init__(self, workflow, **kwargs):
        super(PoolingBase, self).__init__(workflow, **kwargs)
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.sliding = tuple(kwargs.get("sliding", (self.kx, self.ky)))
        self.include_bias = False

    def static_config(self):
        return {"window": (self.ky, self.kx), "sliding": self.sliding}

    def param_arrays(self):
        return []

    def params_dict(self):
        return {}

    def create_params(self):
        if not self.input or self.input.sample_size == 0:
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        shape = self.input.shape
        batch, in_h, in_w, ch = shape + (1,) if len(shape) == 3 else shape
        if not self.output:
            self.output.mem = numpy.zeros(
                (batch, _out_len(in_h, self.ky, self.sliding[1]),
                 _out_len(in_w, self.kx, self.sliding[0]), ch),
                numpy.float32)


class MaxPooling(PoolingBase):
    MAPPING = "max_pooling"

    @classmethod
    def apply(cls, params, x, *, window, sliding):
        if x.ndim == 3:
            x = x[..., None]
        return max_pool(x, window=window, sliding=sliding)


class MaxAbsPooling(PoolingBase):
    """The element with the largest |value|, sign kept."""

    MAPPING = "maxabs_pooling"

    @classmethod
    def apply(cls, params, x, *, window, sliding):
        if x.ndim == 3:
            x = x[..., None]
        pos = _pool(x, window, sliding, float("-inf"), F.max_pool2d)
        neg = _pool(-x, window, sliding, float("-inf"), F.max_pool2d)
        return pos.where(pos >= neg, -neg)


class AvgPooling(PoolingBase):
    MAPPING = "avg_pooling"

    @classmethod
    def apply(cls, params, x, *, window, sliding):
        if x.ndim == 3:
            x = x[..., None]
        return _pool(x, window, sliding, 0.0, F.avg_pool2d)
