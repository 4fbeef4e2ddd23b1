"""Fully-connected ("all-to-all") forward units.

Counterpart of ``veles_tpu/models/all2all.py``: linear, scaled tanh,
RELU (the softplus form), StrictRELU, sigmoid and softmax.  Weights are
(fan_in, fan_out), so ``x @ W`` needs no transpose, as on the JAX side,
and are drawn from the unit's numpy PRNG in the JAX package's order, so
one seed gives the same bits in both packages.  ``apply`` is the math
the unit runs and the fused step calls.
"""

import numpy
import torch

from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_units import ForwardBase, _require_device

__all__ = ["All2All", "All2AllTanh", "All2AllRELU", "All2AllStrictRELU",
           "All2AllSigmoid", "All2AllSoftmax"]


class All2All(ForwardBase):
    """y = activation(x @ W + b); the base class is linear."""

    MAPPING = "all2all"

    def __init__(self, workflow, **kwargs):
        super(All2All, self).__init__(workflow, **kwargs)
        shape = kwargs.get("output_sample_shape", kwargs.get("output_shape"))
        if shape is None:
            raise ValueError("output_sample_shape is required")
        self.output_sample_shape = (
            (int(shape),) if isinstance(shape, (int, numpy.integer))
            else tuple(shape))

    @property
    def output_size(self):
        return int(numpy.prod(self.output_sample_shape))

    def create_params(self):
        if not self.input or self.input.sample_size == 0:
            # input shape not known yet -> the workflow re-queues us
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        fan_in = self.input.sample_size
        if not self.output:
            self.output.mem = numpy.zeros(
                (self.input.shape[0], self.output_size), numpy.float32)
        if self.weights:
            return  # already created (a re-initialize)
        weights = numpy.zeros((fan_in, self.output_size), numpy.float32)
        self.fill_array(weights, self.weights_filling, self.weights_stddev,
                        fan_in)
        self.weights.mem = weights
        if self.include_bias:
            bias = numpy.zeros((self.output_size,), numpy.float32)
            self.fill_array(bias, self.bias_filling, self.bias_stddev,
                            fan_in)
            self.bias.mem = bias

    # -- pure math ----------------------------------------------------------

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
    """Softmax output layer; also exposes ``max_idx`` (argmax per
    sample).  The compiler walk keeps its logits and applies the softmax
    once at the tail."""

    MAPPING = "softmax"

    def __init__(self, workflow, **kwargs):
        super(All2AllSoftmax, self).__init__(workflow, **kwargs)
        self.max_idx = Array()

    @staticmethod
    def _activate(z):
        return torch.softmax(z, dim=-1)

    def run(self):
        super(All2AllSoftmax, self).run()
        out = self.output.devmem
        self.max_idx.set_device_array(
            torch.argmax(out, dim=-1).to(torch.int32),
            _require_device(self))
