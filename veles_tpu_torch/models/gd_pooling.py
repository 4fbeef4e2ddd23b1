"""Backward units for pooling layers.

Counterpart of ``veles_tpu/models/gd_pooling.py``.  No trainable state.
Max pooling sends err_output to each window's first maximum through
``ops/pool_bwd.py``'s ``max_pool_bwd`` on the STORED forward output y,
no pooling recompute (the ``max_pool_bwd`` kernel on a CUDA tensor, its
plain version on a CPU one; looked up in its module at each call, so a
swap of ``pool_bwd.max_pool_bwd`` reaches it).  Average and max-abs
pooling take ``torch.autograd.grad`` of the forward class's ``apply``,
where the JAX package takes ``jax.vjp``: the ceil-mode windows and the
full-window divisor of ``models/pooling.py`` come with it.
"""

import torch

from veles_tpu_torch.models.nn_units import GradientDescentBase
from veles_tpu_torch.models.pooling import (AvgPooling, MaxAbsPooling,
                                            MaxPooling)
from veles_tpu_torch.ops import pool_bwd

__all__ = ["GDMaxPooling", "GDAvgPooling", "GDMaxAbsPooling"]


class GDPoolingBase(GradientDescentBase):
    """kwargs: kx, ky (the window), sliding=(sx, sy), default the
    window."""

    FORWARD_CLS = None

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("include_bias", False)
        super(GDPoolingBase, self).__init__(workflow, **kwargs)
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.sliding = tuple(kwargs.get("sliding", (self.kx, self.ky)))
        # pooling has no params
        self._demanded.discard("weights")

    def backward_static(self):
        return {"window": (self.ky, self.kx), "sliding": self.sliding}

    def _init_solver_state(self):
        pass

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, window=None, sliding=None):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = cls.FORWARD_CLS.apply({}, x, window=window,
                                        sliding=sliding)
            (err_input,) = torch.autograd.grad(
                out, x, err_output.to(out.dtype).reshape(out.shape))
        return err_input, {}


class GDMaxPooling(GDPoolingBase):
    MAPPING = "max_pooling"
    FORWARD_CLS = MaxPooling

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, window=None, sliding=None):
        x4 = x[..., None] if x.ndim == 3 else x
        err_input = pool_bwd.max_pool_bwd(x4, y, err_output, window=window,
                                          sliding=sliding)
        return err_input.reshape(x.shape), {}


class GDMaxAbsPooling(GDPoolingBase):
    MAPPING = "maxabs_pooling"
    FORWARD_CLS = MaxAbsPooling


class GDAvgPooling(GDPoolingBase):
    MAPPING = "avg_pooling"
    FORWARD_CLS = AvgPooling
