"""Base classes of the forward and gradient-descent units.

Counterpart of ``veles_tpu/models/nn_units.py``.  Parameters (weights,
bias and the solver state) are Arrays shared BY OBJECT between a forward
unit and its GD unit, so an update one adopts is the tensor the other
reads next.  The math lives in pure class methods over tensors, so one
definition serves two paths: a unit's own ``run`` (the per-unit graph)
and the fused train step (``veles_tpu_torch/compiler.py``), which calls
the forward classes' ``apply`` and the static solver formulas of
:class:`GradientDescentBase` without any unit instance.

A unit runs its math on its ``Device`` (CUDA, or the CPU when asked)
and never updates a tensor in place: each run hands its Arrays new
tensors (``Array.set_device_array``).  The JAX package's numpy host
path has no counterpart yet: a unit needs a device to run.
"""

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import Unit

__all__ = ["ForwardBase", "GradientDescentBase"]


def _require_device(unit):
    if unit.device is None or not unit.device.exists:
        raise RuntimeError(
            "%s has no device: initialize it with a "
            "veles_tpu_torch.backends.Device" % unit)
    return unit.device


class ForwardBase(Unit):
    """Forward propagation unit: input -> output with trainable params.

    kwargs (per-layer hyperparameters):
      weights_filling: "uniform" | "gaussian" | "constant"
      weights_stddev: spread; default 1/sqrt(fan_in) for uniform
      bias_filling / bias_stddev: likewise for bias
      include_bias: bool (default True)

    The class-level ``apply(params, x, **static)`` is the layer's math;
    the fused step calls it on the class, a unit's ``run`` on its own
    Arrays.
    """

    MAPPING = None

    def __init__(self, workflow, **kwargs):
        super(ForwardBase, self).__init__(workflow, **kwargs)
        self.input = None  # linked from loader/previous unit (Array)
        self.output = Array()
        self.weights = Array()
        self.bias = Array()
        self.include_bias = kwargs.get("include_bias", True)
        self.weights_filling = kwargs.get("weights_filling", "uniform")
        self.weights_stddev = kwargs.get("weights_stddev", None)
        self.bias_filling = kwargs.get("bias_filling", "uniform")
        self.bias_stddev = kwargs.get("bias_stddev", None)
        self.prng = kwargs.get("prng", prng.get())
        self.device = None
        self.demand("input")

    # -- parameter creation -------------------------------------------------

    def fill_array(self, arr, filling, stddev, fan_in):
        """The weight-init schemes, drawn from the unit's numpy PRNG in
        the JAX package's order."""
        if stddev is None:
            stddev = 1.0 / numpy.sqrt(fan_in) if fan_in else 0.01
        if filling == "uniform":
            self.prng.fill(arr, -stddev, stddev)
        elif filling == "gaussian":
            self.prng.fill_normal(arr, 0.0, stddev)
        elif filling == "constant":
            arr[:] = stddev
        else:
            raise ValueError("unknown filling %r" % filling)

    def initialize(self, device=None, **kwargs):
        self.device = device
        super(ForwardBase, self).initialize(**kwargs)
        self.create_params()
        for arr in self.param_arrays():
            if arr:
                arr.initialize(self.device)
        return True

    def create_params(self):
        """Allocate weights/bias from the input shape; raise
        AttributeError while the input shape is unknown (the workflow
        re-queues the unit)."""
        raise NotImplementedError

    def param_arrays(self):
        return [self.weights, self.bias]

    # -- the pure functions -------------------------------------------------

    @staticmethod
    def apply(params, x, **static):
        """params dict, x tensor -> output tensor.  ``static`` holds the
        layer's fixed config (strides, padding, ...)."""
        raise NotImplementedError

    def static_config(self):
        """The fixed kwargs ``apply`` takes."""
        return {}

    def params_dict(self):
        return {"weights": self.weights.devmem,
                "bias": self.bias.devmem if self.include_bias else None}

    # -- execution ----------------------------------------------------------

    def run(self):
        device = _require_device(self)
        with torch.no_grad():
            out = type(self).apply(self.params_dict(),
                                   self.input.device_array(device),
                                   **self.static_config())
        self.output.set_device_array(out, device)
        if root.common.get("sync_run", False):
            device.sync()  # honest per-unit timings (--sync-run)


class GradientDescentBase(Unit):
    """Backward + parameter update for one forward unit.

    kwargs: learning_rate, learning_rate_bias, weights_decay (L2/L1 per
    l1_vs_l2 blend), gradient_moment (momentum), solver
    ("momentum" | "adagrad" | "adadelta"), adadelta_rho, solver_epsilon.

    err_output is dL/d(output) arriving from the NEXT unit (or the
    evaluator); run() produces err_input = dL/d(input) for the PREVIOUS
    unit and adopts the updated parameters and solver state.
    """

    MAPPING = None

    def __init__(self, workflow, **kwargs):
        super(GradientDescentBase, self).__init__(workflow, **kwargs)
        self.input = None
        self.output = None
        self.err_output = None   # linked: next gd's err_input / evaluator
        self.err_input = Array()
        self.weights = None      # linked BY OBJECT from the forward unit
        self.bias = None
        self.include_bias = kwargs.get("include_bias", True)
        self.learning_rate = kwargs.get("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.get(
            "learning_rate_bias", kwargs.get("learning_rate", 0.01))
        self.weights_decay = kwargs.get("weights_decay", 0.0)
        self.weights_decay_bias = kwargs.get("weights_decay_bias", 0.0)
        self.l1_vs_l2 = kwargs.get("l1_vs_l2", 0.0)
        self.gradient_moment = kwargs.get("gradient_moment", 0.0)
        self.gradient_moment_bias = kwargs.get(
            "gradient_moment_bias", kwargs.get("gradient_moment", 0.0))
        self.solver = kwargs.get("solver", "momentum")
        self.adadelta_rho = kwargs.get("adadelta_rho", 0.95)
        self.solver_epsilon = kwargs.get("solver_epsilon", 1e-6)
        self.need_err_input = kwargs.get("need_err_input", True)
        self.device = None
        self.accum_weights = Array()
        self.accum_bias = Array()
        self.accum2_weights = Array()
        self.accum2_bias = Array()
        # updates whose gradients were non-finite are SKIPPED; both
        # counters stay device tensors, read by the decision once per
        # finished class
        self.skip_count = 0
        self.consecutive_skips = 0
        self.demand("input", "output", "err_output", "weights")

    def initialize(self, device=None, **kwargs):
        self.device = device
        super(GradientDescentBase, self).initialize(**kwargs)
        self._init_solver_state()
        return True

    def _init_solver_state(self):
        pairs = [(self.accum_weights, self.weights),
                 (self.accum_bias,
                  self.bias if self.include_bias else None)]
        if self.solver == "adadelta":
            pairs += [(self.accum2_weights, self.weights),
                      (self.accum2_bias,
                       self.bias if self.include_bias else None)]
        for accum, param in pairs:
            if param and not accum:
                accum.mem = numpy.zeros(param.shape, param.dtype)
            if accum:
                accum.initialize(self.device)

    def reset_health_counters(self):
        self.skip_count = 0
        self.consecutive_skips = 0

    def __getstate__(self):
        # snapshots carry plain ints, not device tensors
        state = super(GradientDescentBase, self).__getstate__()
        state["skip_count"] = int(self.skip_count)
        state["consecutive_skips"] = int(self.consecutive_skips)
        return state

    def hyper_dict(self):
        return {
            "learning_rate": self.learning_rate,
            "learning_rate_bias": self.learning_rate_bias,
            "weights_decay": self.weights_decay,
            "weights_decay_bias": self.weights_decay_bias,
            "l1_vs_l2": self.l1_vs_l2,
            "gradient_moment": self.gradient_moment,
            "gradient_moment_bias": self.gradient_moment_bias,
            "adadelta_rho": self.adadelta_rho,
            "solver_epsilon": self.solver_epsilon,
        }

    # -- the static solver formulas (shared with the fused step) ------------

    @staticmethod
    def regularized(grad, param, decay, l1_vs_l2):
        """L1/L2-blended weight decay gradient term."""
        return grad + decay * ((1.0 - l1_vs_l2) * param +
                               l1_vs_l2 * torch.sign(param))

    @staticmethod
    def select_state(finite, new_state, old_state):
        """``where(finite, new, old)`` over one state dict's leaves: the
        single definition of the skip-step fallback.  ``None`` leaves
        and leaves that ARE the old object (param-less passthroughs) are
        kept as they are."""
        selected = {}
        for key, value in new_state.items():
            old = old_state.get(key)
            selected[key] = value if (value is None or old is None or
                                      value is old) else \
                torch.where(finite, value, old)
        return selected

    @staticmethod
    def finite_guard(state, new_state, *grads):
        """When any gradient in ``grads`` carries a non-finite value,
        every leaf of ``new_state`` falls back to its pre-step value in
        ``state``.  Adds the int32 ``"skipped"`` flag (0/1) to the
        returned dict."""
        finite = None
        for grad in grads:
            if grad is not None:
                ok = torch.isfinite(grad).all()
                finite = ok if finite is None else finite & ok
        if finite is None:
            finite = torch.ones((), dtype=torch.bool)
        guarded = GradientDescentBase.select_state(finite, new_state,
                                                   state)
        guarded["skipped"] = (~finite).to(torch.int32)
        return guarded

    @staticmethod
    def solver_update(solver, param, grad, accum, accum2, lr, moment,
                      rho, eps):
        """One solver step; returns (new_param, new_accum, new_accum2).

        momentum:  v = moment*v + lr*g;            p -= v
        adagrad:   a += g*g;                       p -= lr*g/sqrt(a+eps)
        adadelta:  a  = rho*a + (1-rho)*g*g
                   d  = g*sqrt(a2+eps)/sqrt(a+eps); p -= lr*d
                   a2 = rho*a2 + (1-rho)*d*d
        """
        if solver == "momentum":
            v = moment * accum + lr * grad
            return param - v, v, accum2
        if solver == "adagrad":
            a = accum + grad * grad
            return param - lr * grad / torch.sqrt(a + eps), a, accum2
        if solver == "adadelta":
            a = rho * accum + (1.0 - rho) * grad * grad
            d = grad * torch.sqrt(accum2 + eps) / torch.sqrt(a + eps)
            a2 = rho * accum2 + (1.0 - rho) * d * d
            return param - lr * d, a, a2
        raise ValueError("unknown solver %r" % solver)

    # -- the pure backward --------------------------------------------------

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input):
        """state dict (weights/bias/accums) -> (err_input, new_state)."""
        raise NotImplementedError

    def state_dict(self):
        d = {"weights": self.weights.devmem,
             "accum_weights": self.accum_weights.devmem,
             "accum2_weights": (self.accum2_weights.devmem
                                if self.accum2_weights else None)}
        if self.include_bias and self.bias:
            d["bias"] = self.bias.devmem
            d["accum_bias"] = self.accum_bias.devmem
            d["accum2_bias"] = (self.accum2_bias.devmem
                                if self.accum2_bias else None)
        else:
            d["bias"] = d["accum_bias"] = d["accum2_bias"] = None
        return d

    def _adopt_state(self, new_state):
        """Hand each updated leaf to its Array (new tensors, adopted as
        they are: nothing is written in place)."""
        for key, arr in (("weights", self.weights),
                         ("accum_weights", self.accum_weights),
                         ("accum2_weights", self.accum2_weights),
                         ("bias", self.bias),
                         ("accum_bias", self.accum_bias),
                         ("accum2_bias", self.accum2_bias)):
            value = new_state.get(key)
            if value is None or arr is None or not arr:
                continue
            arr.set_device_array(value, self.device)

    # -- execution ----------------------------------------------------------

    def run(self):
        device = _require_device(self)
        with torch.no_grad():
            err_input, new_state = type(self).backward(
                self.state_dict(), self.hyper_dict(),
                self.input.device_array(device),
                self.output.device_array(device),
                self.err_output.device_array(device),
                solver=self.solver,
                include_bias=self.include_bias and bool(self.bias),
                need_err_input=self.need_err_input)
        skipped = new_state.pop("skipped", None)
        if skipped is not None:
            self.skip_count = self.skip_count + skipped
            self.consecutive_skips = \
                (self.consecutive_skips + skipped) * skipped
        if self.need_err_input and err_input is not None:
            self.err_input.set_device_array(err_input, device)
        self._adopt_state(new_state)
        if root.common.get("sync_run", False):
            device.sync()
