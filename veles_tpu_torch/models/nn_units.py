"""Base of the forward layer classes and the solver formulas.

Counterpart of ``veles_tpu/models/nn_units.py``'s ``ForwardBase`` and
the pure static half of its ``GradientDescentBase``.  The port has no
unit graph yet: a forward class is a namespace holding its ``MAPPING``
name (the layer-spec ``type``) and a pure ``apply(params, x, **static)``
over torch tensors, and :class:`GradientDescentBase` holds the weight
decay, the skip-step select and the solver updates the fused train step
(``veles_tpu_torch/compiler.py``) applies."""

import torch

__all__ = ["ForwardBase", "GradientDescentBase"]


class ForwardBase(object):
    """A forward layer: ``apply(params, x, **static) -> y``."""

    MAPPING = None


class GradientDescentBase(object):
    """The solver formulas, as static functions over tensors."""

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
