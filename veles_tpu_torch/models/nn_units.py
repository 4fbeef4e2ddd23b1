"""Base classes of the forward and gradient-descent units.

Counterpart of ``veles_tpu/models/nn_units.py``.  Parameters (weights,
bias and the solver state) are Arrays shared BY OBJECT between a forward
unit and its GD unit, so an update one adopts is the tensor the other
reads next.  The math lives in pure class methods over tensors, so one
definition serves two paths: a unit's own ``run`` (the per-unit graph)
and the fused train step (``veles_tpu_torch/compiler.py``), which calls
the forward classes' ``apply`` and the static solver formulas of
:class:`GradientDescentBase` without any unit instance.

A unit runs on its ``Device`` when the device exists (the card, or
the CPU when asked for): ``run`` takes ``_device_run``, which hands its
Arrays new tensors (``Array.set_device_array``) and never updates one
in place.  On the host pseudo-device (``NumpyDevice``, ``-d numpy``),
which does not exist, ``run`` takes ``_numpy_run``, the JAX package's
host path: the same class-level math over CPU tensors copied from the
Arrays' host buffers (``Array.host_tensor``), its results copied back
into ``mem`` as numpy (``Array.set_host``), so the Arrays stay
host-only and no kernel is launched.  :func:`on_device`,
:func:`operand` and :func:`adopt` carry that rule for the other units
(evaluators, dropout, the SOM, the RBM, the service units).  A unit
with no device raises.

A GD unit's ``run`` fires the ``step.grad`` chaos point once and adds
its poison to ``err_output`` before the backward, so the layer's
gradients and the err_input it hands upstream are non-finite together
and the whole chain skips the step, as in the JAX package.

The master-slave contract (job-farming data parallelism): a master
ships each job its canonical parameters (the forward units) and solver
accumulators (the GD units) as numpy arrays, one device-to-host copy per
array; the slave adopts them (a host write, uploaded at its next device
read), trains on its minibatch and ships back the DELTAS, and the master
adds them on its device, handing each Array a new tensor.  A momentum
run therefore farms out exactly: a respawned slave replays a job from
the same parameters and velocities as one that survived.
"""

import numpy
import torch

from veles_tpu_torch import chaos, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import Unit

__all__ = ["ForwardBase", "GradientDescentBase", "on_device", "operand",
           "adopt"]


def _ship(pairs):
    """{name: a numpy copy of the Array} over the non-empty Arrays."""
    payload = {}
    for name, arr in pairs:
        if arr:
            arr.map_read()
            payload[name] = numpy.array(arr.mem)
    return payload or None


def _adopt(unit, pairs, data, start_attr):
    """A slave adopts the master's arrays and keeps them as the job's
    start, the base of its delta."""
    if not data:
        return
    start = {}
    for name, arr in pairs:
        value = data.get(name)
        if value is not None and arr:
            arr.map_invalidate()
            arr.mem = numpy.array(value)
            start[name] = numpy.array(value)
    setattr(unit, start_attr, start)


def _delta(unit, pairs, start_attr):
    """The slave's update: each Array less the job's start."""
    start = getattr(unit, start_attr, None)
    if not start:
        return None
    delta = {}
    for name, arr in pairs:
        if name in start and arr:
            arr.map_read()
            delta[name] = arr.mem - start[name]
    return delta or None


def _merge(unit, pairs, data):
    """A master adds a slave's deltas on its device (on the host run,
    into its host buffers): each Array gets a new value (nothing is
    written in place)."""
    if not data:
        return
    for name, arr in pairs:
        value = data.get(name)
        if value is not None and arr:
            current = operand(unit, arr)
            delta = torch.from_numpy(numpy.ascontiguousarray(value))
            adopt(unit, arr,
                  current + delta.to(current.device, current.dtype))


def _require_device(unit):
    if unit.device is None:
        raise RuntimeError(
            "%s has no device: initialize it with a "
            "veles_tpu_torch.backends.Device" % unit)
    return unit.device


def on_device(unit):
    """True when ``unit`` runs on its device, False on a device that
    does not exist (``NumpyDevice``): the unit then takes its host run,
    as the JAX package's units do.  A unit with no device raises."""
    return _require_device(unit).exists


def operand(unit, arr):
    """``arr`` as a tensor for ``unit``'s math: its device tensor, or
    on the host run a CPU tensor copied from its host buffer."""
    if on_device(unit):
        return arr.device_array(unit.device)
    return arr.host_tensor()


def adopt(unit, arr, value):
    """Hand ``arr`` a result of ``unit``'s math: adopted as its device
    tensor, or on the host run copied into its host buffer."""
    if on_device(unit):
        arr.set_device_array(value, unit.device)
    else:
        arr.set_host(value)


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
        return {"weights": operand(self, self.weights),
                "bias": (operand(self, self.bias) if self.include_bias
                         else None)}

    # -- execution ----------------------------------------------------------

    def on_device(self):
        return on_device(self)

    def run(self):
        if self.on_device():
            self._device_run()
        else:
            self._numpy_run()

    def _forward(self, x):
        with torch.no_grad():
            return type(self).apply(self.params_dict(), x,
                                    **self.static_config())

    def _device_run(self):
        out = self._forward(self.input.device_array(self.device))
        self.output.set_device_array(out, self.device)
        if root.common.get("sync_run", False):
            self.device.sync()  # honest per-unit timings (--sync-run)

    def _numpy_run(self):
        self.output.set_host(self._forward(self.input.host_tensor()))

    # -- the master-slave contract: parameters out, deltas back ----------

    def _param_pairs(self):
        return (("weights", self.weights), ("bias", self.bias))

    def generate_data_for_slave(self, slave=None):
        return _ship(self._param_pairs())

    def apply_data_from_master(self, data):
        _adopt(self, self._param_pairs(), data, "_job_start_params_")

    def generate_data_for_master(self):
        return _delta(self, self._param_pairs(), "_job_start_params_")

    def apply_data_from_slave(self, data, slave=None):
        _merge(self, self._param_pairs(), data)


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
        """Zero accumulators shaped as the parameters; a parameter-less
        unit (pooling, dropout, activations) overrides this with a
        no-op."""
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

    def on_device(self):
        return on_device(self)

    # -- the master-slave contract: solver state out, deltas back ---------

    def _accum_pairs(self):
        return (("accum_weights", self.accum_weights),
                ("accum_bias", self.accum_bias),
                ("accum2_weights", self.accum2_weights),
                ("accum2_bias", self.accum2_bias))

    def generate_data_for_slave(self, slave=None):
        return _ship(self._accum_pairs())

    def apply_data_from_master(self, data):
        _adopt(self, self._accum_pairs(), data, "_job_start_accums_")

    def generate_data_for_master(self):
        return _delta(self, self._accum_pairs(), "_job_start_accums_")

    def apply_data_from_slave(self, data, slave=None):
        _merge(self, self._accum_pairs(), data)

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

    @staticmethod
    def descend(state, hyper, solver, grad_w, grad_b=None,
                regularize_bias=True):
        """The shared tail of a parametrized backward: the weights'
        gradient regularized, a solver step of the weights (and of the
        bias when ``grad_b`` is given; its decay term only with
        ``regularize_bias``), then :meth:`finite_guard` over the
        gradients the solver took.  Returns the guarded new state."""
        w = state["weights"]
        grad_w = GradientDescentBase.regularized(
            grad_w.to(torch.float32), w, hyper["weights_decay"],
            hyper["l1_vs_l2"])
        new_w, acc_w, acc2_w = GradientDescentBase.solver_update(
            solver, w, grad_w.to(w.dtype), state["accum_weights"],
            state["accum2_weights"], hyper["learning_rate"],
            hyper["gradient_moment"], hyper["adadelta_rho"],
            hyper["solver_epsilon"])
        new_state = {"weights": new_w, "accum_weights": acc_w,
                     "accum2_weights": acc2_w}
        if grad_b is not None:
            b = state["bias"]
            if regularize_bias:
                grad_b = GradientDescentBase.regularized(
                    grad_b, b, hyper["weights_decay_bias"],
                    hyper["l1_vs_l2"])
            new_b, acc_b, acc2_b = GradientDescentBase.solver_update(
                solver, b, grad_b.to(b.dtype), state["accum_bias"],
                state["accum2_bias"], hyper["learning_rate_bias"],
                hyper["gradient_moment_bias"], hyper["adadelta_rho"],
                hyper["solver_epsilon"])
            new_state.update({"bias": new_b, "accum_bias": acc_b,
                              "accum2_bias": acc2_b})
        # a non-finite gradient SKIPS the update; the "skipped" flag
        # rides the returned dict
        return GradientDescentBase.finite_guard(state, new_state, grad_w,
                                                grad_b)

    # -- the pure backward --------------------------------------------------

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, **static):
        """state dict (weights/bias/accums) -> (err_input, new_state).
        ``static`` holds :meth:`backward_static`'s layer config."""
        raise NotImplementedError

    def backward_static(self):
        """The fixed kwargs ``backward`` takes (padding, window, heads,
        ...)."""
        return {}

    def state_dict(self):
        """The backward's state: ``None`` for a missing or empty Array
        (the parameter-less units')."""
        def tensor(arr):
            return operand(self, arr) if arr else None

        d = {"weights": tensor(self.weights),
             "accum_weights": tensor(self.accum_weights),
             "accum2_weights": tensor(self.accum2_weights)}
        if self.include_bias and self.bias:
            d["bias"] = tensor(self.bias)
            d["accum_bias"] = tensor(self.accum_bias)
            d["accum2_bias"] = tensor(self.accum2_bias)
        else:
            d["bias"] = d["accum_bias"] = d["accum2_bias"] = None
        return d

    def _adopt_state(self, new_state):
        """Hand each updated leaf to its Array (new tensors, adopted as
        they are: nothing is written in place; on the host run, numpy
        copies)."""
        for key, arr in (("weights", self.weights),
                         ("accum_weights", self.accum_weights),
                         ("accum2_weights", self.accum2_weights),
                         ("bias", self.bias),
                         ("accum_bias", self.accum_bias),
                         ("accum2_bias", self.accum2_bias)):
            value = new_state.get(key)
            if value is None or arr is None or not arr:
                continue
            adopt(self, arr, value)

    # -- execution ----------------------------------------------------------

    def run(self):
        poison = None
        if chaos.plan is not None:
            fault = chaos.plan.fire("step.grad")
            if fault is not None:
                poison = float(numpy.float32(
                    numpy.nan if fault.param is None else fault.param))
        if self.on_device():
            self._device_run(poison)
        else:
            self._numpy_run(poison)

    def _backward(self, x, y, err_output, poison):
        """(err_input, new state, the 0/1 skip flag or None) of one
        backward over the given operands."""
        if poison is not None:
            err_output = err_output + poison
        with torch.no_grad():
            err_input, new_state = type(self).backward(
                self.state_dict(), self.hyper_dict(), x, y, err_output,
                solver=self.solver,
                include_bias=self.include_bias and bool(self.bias),
                need_err_input=self.need_err_input,
                **self.backward_static())
        return err_input, new_state, new_state.pop("skipped", None)

    def _account_skip(self, skipped):
        self.skip_count = self.skip_count + skipped
        self.consecutive_skips = (self.consecutive_skips + skipped) * skipped

    def _device_run(self, poison=None):
        device = self.device
        err_input, new_state, skipped = self._backward(
            self.input.device_array(device),
            self.output.device_array(device),
            self.err_output.device_array(device), poison)
        if skipped is not None:
            self._account_skip(skipped)  # device tensors, read lazily
        if self.need_err_input and err_input is not None:
            self.err_input.set_device_array(err_input, device)
        self._adopt_state(new_state)
        if root.common.get("sync_run", False):
            device.sync()

    def _numpy_run(self, poison=None):
        err_input, new_state, skipped = self._backward(
            self.input.host_tensor(), self.output.host_tensor(),
            self.err_output.host_tensor(), poison)
        if skipped is not None:
            self._account_skip(int(skipped))
        if self.need_err_input and err_input is not None:
            self.err_input.set_host(err_input)
        self._adopt_state(new_state)
