"""Learning-rate policies and the weights rollback.

Counterpart of ``veles_tpu/models/lr_adjust.py``.  The policies map the
minibatch count ``it`` to a rate: fixed, step_exp (gamma^floor(it /
step)), exp (gamma^it), inv ((1 + gamma it)^-power), or any function of
``it``.  A per-unit GD unit reads its learning rate at each run, so a
change reaches the next minibatch; a fused trainer reads it at its next
step.
"""

import numpy

from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import Unit

__all__ = ["LearningRateAdjust", "Rollback",
           "fixed_policy", "step_exp_policy", "exp_policy", "inv_policy"]


def fixed_policy(base):
    return lambda it: base


def step_exp_policy(base, gamma, step):
    return lambda it: base * gamma ** (it // step)


def exp_policy(base, gamma):
    return lambda it: base * gamma ** it


def inv_policy(base, gamma, power=1.0):
    return lambda it: base * (1.0 + gamma * it) ** (-power)


class LearningRateAdjust(Unit):
    """Applies (lr_policy, bias_lr_policy) to the linked GD units at
    each run; ``it`` counts the runs (minibatches)."""

    def __init__(self, workflow, **kwargs):
        super(LearningRateAdjust, self).__init__(workflow, **kwargs)
        self.lr_policy = kwargs.get("lr_policy")
        self.bias_lr_policy = kwargs.get("bias_lr_policy", self.lr_policy)
        self.gd_units = []
        self._iteration = 0

    def add_gd_unit(self, *units):
        self.gd_units.extend(units)
        return self

    def run(self):
        self._iteration += 1
        for gd in self.gd_units:
            if self.lr_policy is not None:
                gd.learning_rate = float(self.lr_policy(self._iteration))
            if self.bias_lr_policy is not None:
                gd.learning_rate_bias = float(
                    self.bias_lr_policy(self._iteration))


class Rollback(Unit):
    """Keeps the best parameters; on a slip (``improved`` false) it
    restores them into the linked GD units' Arrays, weights and solver
    state, and multiplies their learning rates by ``lr_cut`` while the
    result stays at or over ``lr_limit``; an improvement refreshes the
    copy.

    Link ``improved`` from the decision, the GD units with
    :meth:`add_gd_unit`."""

    def __init__(self, workflow, **kwargs):
        super(Rollback, self).__init__(workflow, **kwargs)
        self.lr_cut = kwargs.get("lr_cut", 0.5)
        self.lr_limit = kwargs.get("lr_limit", 1e-8)
        self.improved = None  # linked Bool from the decision
        self.gd_units = []
        self._best = {}
        self.demand("improved")

    def add_gd_unit(self, *units):
        self.gd_units.extend(units)
        return self

    @staticmethod
    def _param_arrays(gd):
        out = []
        for name in ("weights", "bias", "accum_weights", "accum_bias",
                     "accum2_weights", "accum2_bias"):
            arr = getattr(gd, name, None)
            if isinstance(arr, Array) and arr:
                out.append((name, arr))
        return out

    def run(self):
        if bool(self.improved) or not self._best:
            for i, gd in enumerate(self.gd_units):
                for name, arr in self._param_arrays(gd):
                    arr.map_read()
                    self._best[(i, name)] = numpy.array(arr.mem)
            return
        # a slip: the best parameters back, the learning rate cut
        for i, gd in enumerate(self.gd_units):
            for name, arr in self._param_arrays(gd):
                saved = self._best.get((i, name))
                if saved is not None:
                    arr.map_invalidate()
                    arr.mem = numpy.array(saved)
            if gd.learning_rate * self.lr_cut >= self.lr_limit:
                gd.learning_rate *= self.lr_cut
                gd.learning_rate_bias *= self.lr_cut
