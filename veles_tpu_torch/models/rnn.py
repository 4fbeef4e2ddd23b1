"""Recurrent layers: vanilla RNN and LSTM.

Counterpart of ``veles_tpu/models/rnn.py``.  Input is (B, T, F); the
output is (B, T, H) (``return_sequences=True``) or the final state
(B, H).  The weights pack as on the JAX side, (F + H, G * H): the input
kernel first, then the recurrent kernel, the LSTM's gates ordered i, f,
g, o, so one snapshot serves both packages.

The input projection of every timestep is one product
(``torch.matmul`` over (B, T, F)); the time loop is a Python loop over
the static T where the JAX package runs ``lax.scan``, and the state is
cast to the input's dtype at every step, as there.  Inside a captured
CUDA graph (``graphs.py``) the loop unrolls into the capture: T steps
of one recurrent product and the gate elementwise each.  No TPU kernel
runs here, on either side.

The GD units' backward is autograd through ``apply`` (the JAX package
takes ``jax.vjp`` through the scan), followed by the shared solver
step and the skip-step guard; the bias is not regularized, as there.
"""

import numpy
import torch

from veles_tpu_torch.models.nn_units import ForwardBase
from veles_tpu_torch.models.transformer import _GDAutodiff

__all__ = ["RNN", "LSTM", "GDRNN", "GDLSTM"]


class RecurrentBase(ForwardBase):
    #: gates per hidden unit (1 for RNN, 4 for LSTM)
    GATES = 1

    def __init__(self, workflow, **kwargs):
        super(RecurrentBase, self).__init__(workflow, **kwargs)
        self.hidden_size = kwargs["hidden_size"]
        self.return_sequences = kwargs.get("return_sequences", True)

    def static_config(self):
        return {"return_sequences": self.return_sequences}

    def create_params(self):
        if not self.input or self.input.sample_size == 0:
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        batch, seq, features = self.input.shape
        h = self.hidden_size
        if not self.output:
            out_shape = (batch, seq, h) if self.return_sequences \
                else (batch, h)
            self.output.mem = numpy.zeros(out_shape, numpy.float32)
        if self.weights:
            return
        g = self.GATES
        # packed: input kernel (F, G*H) then recurrent kernel (H, G*H)
        weights = numpy.zeros((features + h, g * h), numpy.float32)
        self.fill_array(weights, self.weights_filling,
                        self.weights_stddev, features + h)
        self.weights.mem = weights
        if self.include_bias:
            self.bias.mem = numpy.zeros((g * h,), numpy.float32)

    @staticmethod
    def _project(params, x):
        """(input projection of every timestep + bias, recurrent
        kernel): xw is (B, T, G*H) in f32."""
        w = params["weights"]
        features = x.shape[-1]
        xw = torch.matmul(x.to(torch.float32), w[:features])
        b = params.get("bias")
        if b is not None:
            xw = xw + b
        return xw, w[features:]

    @staticmethod
    def _collect(hs, h_last, x, return_sequences):
        out = torch.stack(hs, dim=1) if return_sequences else h_last
        return out.to(x.dtype)


class RNN(RecurrentBase):
    """h_t = tanh(x_t Wx + h_{t-1} Wh + b)."""

    MAPPING = "rnn"
    GATES = 1

    @classmethod
    def apply(cls, params, x, *, return_sequences=True):
        xw, wh = cls._project(params, x)
        h = torch.zeros((x.shape[0], wh.shape[0]), dtype=x.dtype,
                        device=x.device)
        hs = []
        for t in range(x.shape[1]):
            h = torch.tanh(xw[:, t] + h.to(torch.float32) @ wh).to(x.dtype)
            hs.append(h)
        return cls._collect(hs, h, x, return_sequences)


class LSTM(RecurrentBase):
    """Standard LSTM (gates i, f, g, o packed on the last axis)."""

    MAPPING = "lstm"
    GATES = 4

    @classmethod
    def apply(cls, params, x, *, return_sequences=True):
        xw, wh = cls._project(params, x)
        h = torch.zeros((x.shape[0], wh.shape[0]), dtype=x.dtype,
                        device=x.device)
        c = h
        hs = []
        for t in range(x.shape[1]):
            z = xw[:, t] + h.to(torch.float32) @ wh
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
            c = c.to(x.dtype)
            hs.append(h)
        return cls._collect(hs, h, x, return_sequences)


class _GDRecurrent(_GDAutodiff):
    MAPPING = None  # abstract

    def __init__(self, workflow, **kwargs):
        super(_GDRecurrent, self).__init__(workflow, **kwargs)
        self.return_sequences = kwargs.get("return_sequences", True)

    def backward_static(self):
        return {"return_sequences": self.return_sequences}


class GDRNN(_GDRecurrent):
    MAPPING = "rnn"
    FORWARD_CLS = RNN


class GDLSTM(_GDRecurrent):
    MAPPING = "lstm"
    FORWARD_CLS = LSTM
