"""Deconvolution (transposed conv) and depooling units with their GD
counterparts: the convolutional autoencoder's building blocks.

Counterpart of ``veles_tpu/models/deconv.py``.  The weights are (ky,
kx, out_ch, in_ch), as there, so a (conv, deconv) pair can share them
and one snapshot serves both packages.  The forward is the JAX
package's ``lax.conv_transpose`` (no kernel flip, ``padding`` in the
forward conv's convention): ``F.conv_transpose2d`` over the spatially
flipped weights, the full output cropped by the padding.  Depooling
repeats each pixel over the pooling window.  Both backwards are
autograd over ``apply``; no kernel of the port is involved.
"""

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch.models.conv import _norm_padding
from veles_tpu_torch.models.gd import GradientDescent
from veles_tpu_torch.models.nn_units import ForwardBase, GradientDescentBase

__all__ = ["Deconv", "GDDeconv", "Depooling", "GDDepooling"]


class Deconv(ForwardBase):
    """y = conv_transpose(x, W) (+ b); kwargs: n_output_channels, kx,
    ky, sliding=(sx, sy), padding (the paired conv's), include_bias
    (default False)."""

    MAPPING = "deconv"

    def __init__(self, workflow, **kwargs):
        super(Deconv, self).__init__(workflow, **kwargs)
        self.n_output_channels = kwargs["n_output_channels"]
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.padding = _norm_padding(kwargs.get("padding", 0))
        self.include_bias = kwargs.get("include_bias", False)

    @classmethod
    def apply(cls, params, x, *, padding=(0, 0, 0, 0), sliding=(1, 1)):
        w = params["weights"]  # (ky, kx, out_ch, in_ch)
        if x.ndim == 3:
            x = x[..., None]
        left, top, right, bottom = padding
        sx, sy = sliding
        z = F.conv_transpose2d(
            x.to(torch.float32).permute(0, 3, 1, 2),
            w.permute(3, 2, 0, 1).flip(2, 3), stride=(sy, sx))
        z = z[:, :, top:z.shape[2] - bottom, left:z.shape[3] - right]
        z = z.permute(0, 2, 3, 1)
        if params.get("bias") is not None:
            z = z + params["bias"]
        return z.to(x.dtype)

    def static_config(self):
        return {"padding": self.padding, "sliding": self.sliding}

    def output_spatial(self, in_h, in_w):
        left, top, right, bottom = self.padding
        sx, sy = self.sliding
        return ((in_h - 1) * sy + self.ky - top - bottom,
                (in_w - 1) * sx + self.kx - left - right)

    def create_params(self):
        if not self.input or self.input.sample_size == 0:
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        shape = self.input.shape
        batch, in_h, in_w, in_ch = shape if len(shape) == 4 \
            else shape + (1,)
        if not self.output:
            out_h, out_w = self.output_spatial(in_h, in_w)
            self.output.mem = numpy.zeros(
                (batch, out_h, out_w, self.n_output_channels),
                numpy.float32)
        if self.weights:
            return
        weights = numpy.zeros(
            (self.ky, self.kx, self.n_output_channels, in_ch),
            numpy.float32)
        self.fill_array(weights, self.weights_filling, self.weights_stddev,
                        self.kx * self.ky * in_ch)
        self.weights.mem = weights
        if self.include_bias:
            self.bias.mem = numpy.zeros((self.n_output_channels,),
                                        numpy.float32)


class GDDeconv(GradientDescent):
    MAPPING = "deconv"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("include_bias", False)
        super(GDDeconv, self).__init__(workflow, **kwargs)
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.padding = _norm_padding(kwargs.get("padding", 0))

    def backward_static(self):
        return {"padding": self.padding, "sliding": self.sliding}

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, padding=(0, 0, 0, 0),
                 sliding=(1, 1)):
        w = state["weights"].detach().requires_grad_(True)
        x = x.detach().requires_grad_(need_err_input)
        err = err_output.to(x.dtype)
        with torch.enable_grad():
            out = Deconv.apply({"weights": w, "bias": None}, x,
                               padding=padding, sliding=sliding)
            grads = torch.autograd.grad(
                out, [w, x] if need_err_input else [w], err)
        err_input = grads[1] if need_err_input else None
        grad_b = err.to(torch.float32).sum(dim=(0, 1, 2)) \
            if include_bias else None
        new_state = GradientDescentBase.descend(
            state, hyper, solver, grads[0], grad_b, regularize_bias=False)
        return err_input, new_state


class Depooling(ForwardBase):
    """Nearest-neighbour upsample by the pooling window (kwargs: kx,
    ky): the avg-depooling inverse of conv autoencoders."""

    MAPPING = "depooling"

    def __init__(self, workflow, **kwargs):
        super(Depooling, self).__init__(workflow, **kwargs)
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.include_bias = False

    def static_config(self):
        return {"window": (self.ky, self.kx)}

    def param_arrays(self):
        return []

    def params_dict(self):
        return {}

    @classmethod
    def apply(cls, params, x, *, window):
        if x.ndim == 3:
            x = x[..., None]
        ky, kx = window
        return x.repeat_interleave(ky, dim=1).repeat_interleave(kx, dim=2)

    def create_params(self):
        if not self.input or self.input.sample_size == 0:
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        if not self.output:
            b, h, w, c = self.input.shape
            self.output.mem = numpy.zeros(
                (b, h * self.ky, w * self.kx, c), numpy.float32)


class GDDepooling(GradientDescentBase):
    MAPPING = "depooling"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("include_bias", False)
        super(GDDepooling, self).__init__(workflow, **kwargs)
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self._demanded.discard("weights")

    def _init_solver_state(self):
        pass

    def backward_static(self):
        return {"window": (self.ky, self.kx)}

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, window):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = Depooling.apply({}, x, window=window)
            (err_input,) = torch.autograd.grad(
                out, x, err_output.to(x.dtype))
        return err_input, {}
