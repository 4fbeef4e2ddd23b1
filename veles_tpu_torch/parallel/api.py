"""Placement helpers for the meshed train step.

Counterpart of ``veles_tpu/parallel/api.py``.  The JAX package places a
global array over the mesh and lets XLA slice it; here each rank holds
its own part, so each helper returns this rank's part (or, for
:func:`replicate`, rank 0's values on every rank).

A sharding is a :class:`Spec`: a tuple over a leaf's dims naming the
mesh axis that splits each (None: whole), the JAX ``PartitionSpec``.
:func:`shard_leaf` takes a rank's block of a whole leaf and
:func:`unshard_leaf` gathers the blocks back (called on every rank).
"""

import collections

import torch

from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

__all__ = ["Spec", "replicate", "shard_batch", "batch_sharding",
           "mlp_state_shardings", "shard_host_batch", "shard_leaf",
           "unshard_leaf", "shard_state", "unshard_state"]


class Spec(tuple):
    """A leaf's sharding: one entry a dim, the axis name that splits it
    or None (``PartitionSpec``; trailing dims not named are whole)."""

    def __new__(cls, *axes):
        return super(Spec, cls).__new__(cls, axes)

    def __repr__(self):
        return "Spec%s" % (tuple.__repr__(self),)


#: a batch sharding: the mesh and the spec of the leading dim
BatchSharding = collections.namedtuple("BatchSharding", ("mesh", "spec"))


def replicate(mesh, tree):
    """Rank 0's value of every tensor leaf on every rank of ``mesh``
    (a broadcast along each axis in turn); returns new tensors."""
    def leaf(value):
        if not isinstance(value, torch.Tensor):
            return value
        value = value.detach().clone().contiguous()
        for axis in mesh.mesh_dim_names:
            if axis_size(mesh, axis) > 1:
                collectives.broadcast(value, 0, axis_group(mesh, axis))
        return value
    return _map(leaf, tree)


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def batch_sharding(mesh, data_axis="data"):
    """Leading-dim (batch) sharding."""
    return BatchSharding(mesh, Spec(data_axis))


def _block(n_rows, parts, index, what):
    if n_rows % parts:
        raise ValueError("%s: %d rows do not split over %d ranks"
                         % (what, n_rows, parts))
    size = n_rows // parts
    return index * size, (index + 1) * size


def shard_batch(mesh, batch, data_axis="data"):
    """This rank's rows of a global batch: the ``data_axis`` index's
    contiguous block."""
    start, stop = _block(batch.shape[0], axis_size(mesh, data_axis),
                         axis_index(mesh, data_axis), "shard_batch")
    return batch[start:stop]


def shard_host_batch(mesh, local_batch, data_axis="data"):
    """A process's local minibatch slice as its part of the global
    batch.  One process a rank holds its part as it is: every rank of a
    data row passes its row's rows, the same shape on every rank (the
    Loader pads a short minibatch and ships the real count in
    ``batch_size``)."""
    del mesh, data_axis
    return torch.as_tensor(local_batch)


def mlp_state_shardings(mesh, state, data_axis="data", model_axis=None):
    """Spec list for an MLP's layer-state list.

    DP only: everything whole (replicated).  With ``model_axis``
    (tensor parallelism): alternate layers split fan_out / fan_in —
    Megatron's column-then-row split, so the activations between the
    pair need one sum over ``model_axis``."""
    del mesh, data_axis

    def spec_for(layer_idx, key, leaf):
        if leaf is None or model_axis is None:
            return Spec()
        column = (layer_idx % 2 == 0)
        if key in ("weights", "accum_weights", "accum2_weights"):
            if getattr(leaf, "ndim", 0) != 2:
                return Spec()
            return (Spec(None, model_axis) if column
                    else Spec(model_axis, None))
        if key in ("bias", "accum_bias", "accum2_bias"):
            return Spec(model_axis) if column else Spec()
        return Spec()

    return [{key: spec_for(i, key, leaf) for key, leaf in entry.items()}
            for i, entry in enumerate(state)]


def shard_leaf(mesh, leaf, spec):
    """This rank's block of a whole leaf under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        start, stop = _block(leaf.shape[dim], axis_size(mesh, axis),
                             axis_index(mesh, axis), "shard_leaf")
        leaf = leaf.narrow(dim, start, stop - start)
    return leaf.contiguous()


def unshard_leaf(mesh, block, spec):
    """The whole leaf from every rank's block (an all-gather along each
    split dim); called on every rank of the split axes."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        moved = block.movedim(dim, 0).contiguous()
        out = torch.empty((n * moved.shape[0],) + moved.shape[1:],
                          dtype=moved.dtype, device=moved.device)
        collectives.all_gather(out, moved, axis_group(mesh, axis))
        block = out.movedim(0, dim)
    return block.contiguous()


def shard_state(mesh, state, shardings):
    """Each leaf's block under its spec (None leaves stay None)."""
    return [{key: None if leaf is None else
             shard_leaf(mesh, leaf, shardings[i].get(key, Spec()))
             for key, leaf in entry.items()}
            for i, entry in enumerate(state)]


def unshard_state(mesh, state, shardings):
    """Inverse of :func:`shard_state` (every rank calls it)."""
    return [{key: None if leaf is None else
             unshard_leaf(mesh, leaf, shardings[i].get(key, Spec()))
             for key, leaf in entry.items()}
            for i, entry in enumerate(state)]
