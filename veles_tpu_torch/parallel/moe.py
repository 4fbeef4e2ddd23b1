"""Expert parallelism: a mixture-of-experts layer sharded over an
``expert`` mesh axis.

Counterpart of ``veles_tpu/parallel/moe.py``: expert parameters carry a
leading expert dim split over the axis (:func:`shard_moe_params` gives
a rank its block); the gate (softmax top-k) is computed on every rank;
each rank evaluates ITS experts for all tokens, and the gate-weighted
combine is one sum over the axis (``collectives.psum_leave``: the
reference's ``lax.psum``, with the identity as its transpose).  This
dense dispatch is exact: no capacity factor drops a token.
"""

import numpy
import torch

from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

__all__ = ["moe_apply", "moe_reference", "init_moe_params",
           "shard_moe_params"]


def init_moe_params(rng, n_experts, features, hidden, out_features):
    """Gate + per-expert 2-layer MLP (host numpy, the JAX package's
    draws from the same ``rng``)."""
    def u(shape, fan_in):
        return (rng.uniform(-1, 1, shape) /
                numpy.sqrt(fan_in)).astype(numpy.float32)
    return {
        "gate": u((features, n_experts), features),
        "w1": u((n_experts, features, hidden), features),
        "b1": numpy.zeros((n_experts, hidden), numpy.float32),
        "w2": u((n_experts, hidden, out_features), hidden),
        "b2": numpy.zeros((n_experts, out_features), numpy.float32),
    }


def _experts(w1, b1, w2, b2, x):
    """Every expert of the stacks on x: (E, B, out)."""
    h = torch.tanh(torch.einsum("bf,efh->ebh", x.float(), w1) +
                   b1[:, None, :])
    return torch.einsum("ebh,eho->ebo", h, w2) + b2[:, None, :]


def _gate_weights(gate, x, top_k):
    logits = x.float() @ gate
    n_experts = logits.shape[-1]
    if top_k >= n_experts:
        return torch.softmax(logits, dim=-1)
    threshold = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    masked = torch.where(logits >= threshold, logits,
                         torch.full_like(logits, -torch.inf))
    return torch.softmax(masked, dim=-1)


def moe_reference(params, x, top_k=2):
    """Single-device oracle."""
    gates = _gate_weights(params["gate"], x, top_k)  # (B, E)
    outs = _experts(params["w1"], params["b1"], params["w2"],
                    params["b2"], x)  # (E, B, F)
    return torch.einsum("be,ebf->bf", gates, outs).to(x.dtype)


def shard_moe_params(mesh, params, axis="expert"):
    """This rank's block of the expert-dim leaves; the gate whole."""
    n, me = axis_size(mesh, axis), axis_index(mesh, axis)
    out = {}
    for key, leaf in params.items():
        leaf = torch.as_tensor(leaf)
        if key != "gate":
            if leaf.shape[0] % n:
                raise ValueError("%d experts do not split over %d ranks"
                                 % (leaf.shape[0], n))
            size = leaf.shape[0] // n
            leaf = leaf[me * size:(me + 1) * size]
        out[key] = leaf.contiguous()
    return out


def moe_apply(params, x, mesh, top_k=2, axis="expert", data_axis=None):
    """Expert-parallel forward of this rank's tokens: (B_l, F) -> (B_l,
    out), ``params`` this rank's block (:func:`shard_moe_params`).
    ``data_axis`` names the axis the caller split the tokens over; the
    combine sums over ``axis`` only."""
    del data_axis
    n_local = params["w1"].shape[0]
    gates = _gate_weights(params["gate"], x, top_k)  # (B, E_total)
    local_out = _experts(params["w1"], params["b1"], params["w2"],
                         params["b2"], x)  # (E_local, B, F_out)
    offset = axis_index(mesh, axis) * n_local
    local_gates = gates[:, offset:offset + n_local]
    partial = torch.einsum("be,ebf->bf", local_gates, local_out)
    return collectives.psum_leave(partial, axis_group(mesh, axis)).to(
        x.dtype)
