"""The inference part of ``veles_tpu/compiler.py``: ``LayerPlan`` and
``build_forward``.

PyTorch runs eagerly, so the "compiled" forward is a plain function
over a parameter list of ``{"weights", "bias"}`` tensor dicts.  The
walk follows the JAX one: a softmax layer keeps its logits and the
softmax is applied once at the tail; dropout is the identity at
inference.  The fused training step is not ported yet.
"""

import functools

import torch

__all__ = ["LayerPlan", "build_forward"]


class LayerPlan(object):
    """Static per-layer compile info: forward class, solver, hyper."""

    def __init__(self, forward_cls, solver="momentum", hyper=None,
                 include_bias=True, static=None):
        self.forward_cls = forward_cls
        self.solver = solver
        self.hyper = hyper or {}
        self.include_bias = include_bias
        self.static = static or {}


def _forward_for_loss(plans, params, x):
    """Inference forward; returns the pre-softmax logits of a softmax
    tail, else the final output."""
    from veles_tpu_torch.models.all2all import All2All, All2AllSoftmax
    from veles_tpu_torch.models.dropout import DropoutForward

    h = x
    for plan, p in zip(plans, params):
        if plan.forward_cls is All2AllSoftmax:
            h = All2All.apply(p, h)
        elif issubclass(plan.forward_cls, DropoutForward):
            continue
        else:
            h = functools.partial(plan.forward_cls.apply,
                                  **plan.static)(p, h)
    return h


def build_forward(plans):
    """Pure inference fn(params_list, x) -> output (probabilities for a
    softmax tail)."""
    from veles_tpu_torch.models.all2all import All2AllSoftmax

    def forward(params, x):
        h = _forward_for_loss(plans, params, x)
        if plans and plans[-1].forward_cls is All2AllSoftmax:
            h = torch.softmax(h, dim=-1)
        return h
    return forward
