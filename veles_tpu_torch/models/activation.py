"""Standalone activation units: forward and backward pairs insertable
between any two layers.

Counterpart of ``veles_tpu/models/activation.py``.  Each pair shares
its math with the all2all and conv variants (``models/all2all.py``'s
``_activate``, ``models/gd.py``'s ``_activation_grad``); the
derivatives are expressed through the forward OUTPUT y.  No parameters.
"""

import numpy
import torch

from veles_tpu_torch.models.all2all import (
    All2AllRELU, All2AllSigmoid, All2AllStrictRELU, All2AllTanh)
from veles_tpu_torch.models.gd import GDRELU, GDSigmoid, GDStrictRELU, GDTanh
from veles_tpu_torch.models.nn_units import ForwardBase, GradientDescentBase

__all__ = [
    "ActivationForward", "ActivationBackward",
    "ForwardTanh", "BackwardTanh", "ForwardRELU", "BackwardRELU",
    "ForwardStrictRELU", "BackwardStrictRELU", "ForwardSigmoid",
    "BackwardSigmoid", "ForwardLog", "BackwardLog", "ForwardMul",
    "BackwardMul",
]


class ActivationForward(ForwardBase):
    """Elementwise y = f(x)."""

    def create_params(self):
        if not self.input or self.input.sample_size == 0:
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        if not self.output:
            self.output.mem = numpy.zeros(self.input.shape, numpy.float32)

    def param_arrays(self):
        return []

    def params_dict(self):
        return {}

    @classmethod
    def apply(cls, params, x, **static):
        return cls._activate(x)


class ActivationBackward(GradientDescentBase):
    """err_input = f'(y) * err_output."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("include_bias", False)
        super(ActivationBackward, self).__init__(workflow, **kwargs)
        self._demanded.discard("weights")
        self._demanded.discard("input")

    def _init_solver_state(self):
        pass

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, **static):
        return cls._activation_grad(y, err_output), {}

    def run(self):
        # x is unused; y stands in for it in the generic signature
        if self.input is None:
            self.input = self.output
        super(ActivationBackward, self).run()


class ForwardTanh(ActivationForward):
    MAPPING = "activation_tanh"
    _activate = staticmethod(All2AllTanh._activate)


class BackwardTanh(ActivationBackward):
    MAPPING = "activation_tanh"
    _activation_grad = staticmethod(GDTanh._activation_grad)


class ForwardRELU(ActivationForward):
    MAPPING = "activation_relu"
    _activate = staticmethod(All2AllRELU._activate)


class BackwardRELU(ActivationBackward):
    MAPPING = "activation_relu"
    _activation_grad = staticmethod(GDRELU._activation_grad)


class ForwardStrictRELU(ActivationForward):
    MAPPING = "activation_str"
    _activate = staticmethod(All2AllStrictRELU._activate)


class BackwardStrictRELU(ActivationBackward):
    MAPPING = "activation_str"
    _activation_grad = staticmethod(GDStrictRELU._activation_grad)


class ForwardSigmoid(ActivationForward):
    MAPPING = "activation_sigmoid"
    _activate = staticmethod(All2AllSigmoid._activate)


class BackwardSigmoid(ActivationBackward):
    MAPPING = "activation_sigmoid"
    _activation_grad = staticmethod(GDSigmoid._activation_grad)


class ForwardLog(ActivationForward):
    """y = log(x + sqrt(x^2 + 1)) (asinh)."""

    MAPPING = "activation_log"

    @staticmethod
    def _activate(z):
        return torch.asinh(z)


class BackwardLog(ActivationBackward):
    MAPPING = "activation_log"

    @staticmethod
    def _activation_grad(y, err):
        # x = sinh(y); dy/dx = 1/sqrt(x^2+1) = 1/cosh(y)
        return err / torch.cosh(y)


class ForwardMul(ActivationForward):
    """y = k * x; kwargs: factor (k, default 1)."""

    MAPPING = "activation_mul"

    def __init__(self, workflow, **kwargs):
        super(ForwardMul, self).__init__(workflow, **kwargs)
        self.factor = kwargs.get("factor", 1.0)

    def static_config(self):
        return {"factor": self.factor}

    @classmethod
    def apply(cls, params, x, *, factor=1.0):
        return x * factor


class BackwardMul(ActivationBackward):
    MAPPING = "activation_mul"

    def __init__(self, workflow, **kwargs):
        super(BackwardMul, self).__init__(workflow, **kwargs)
        self.factor = kwargs.get("factor", 1.0)

    def backward_static(self):
        return {"factor": self.factor}

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, factor=1.0):
        return err_output * factor, {}
