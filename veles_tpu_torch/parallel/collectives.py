"""The collective layer: every collective of the parallel layer, on a
``torch.distributed`` process group, counted.

The JAX package's collectives are XLA ops inside one program
(``lax.psum``, ``psum_scatter``, ``all_gather``, ``ppermute``,
``all_to_all``).  The port runs one process a rank, and each of those
becomes the matching ``torch.distributed`` call on the mesh axis's
group (``mesh.get_group(axis)``):

=====================  ==========================  ====================
JAX                    here                        kind (analysis.py)
=====================  ==========================  ====================
``lax.psum``           :func:`all_reduce`          ``all-reduce``
``lax.psum_scatter``   :func:`reduce_scatter`      ``reduce-scatter``
``lax.all_gather``     :func:`all_gather`          ``all-gather``
``lax.all_to_all``     :func:`all_to_all`          ``all-to-all``
``lax.ppermute``       :func:`ppermute`            ``collective-permute``
=====================  ==========================  ====================

plus :func:`broadcast` (``replicate``'s, kind ``broadcast``).  Where an
op needs a gradient, :func:`psum_enter`, :func:`psum_leave`,
:func:`ppermute` and :func:`all_to_all` are ``torch.autograd``
functions whose backward is the op's transpose.

Counting.  Each call adds one to :data:`COLLECTIVES` (``launches``, and
``paths`` by kind) and its result's bytes to :data:`COLLECTIVE_BYTES`,
where it issues the collective and nowhere else.  Both register with
``graphs.register_counters``, so a captured step's replays advance
them like a kernel's launch counter (they are not kernels:
``Graph.launches`` leaves them out).  ``analysis.collective_bytes``
reads them.  A group of one process still issues its collectives (a
sum of one term), except :func:`ppermute`, which has no peer there and
returns its input.

Backends: NCCL on the card, gloo on the CPU.  gloo also takes CUDA
tensors for every collective here but send / receive (staged through
the host by gloo itself; torch 2.11 on the card), which is how two
ranks share one card.  Nothing here moves a tensor between devices.
"""

import torch
import torch.distributed as dist

from veles_tpu_torch.graphs import register_counters

__all__ = ["COLLECTIVES", "COLLECTIVE_BYTES", "KINDS", "all_reduce",
           "reduce_scatter", "all_gather", "all_to_all", "ppermute",
           "broadcast", "psum_enter", "psum_leave", "group_size",
           "group_rank"]

#: the kinds, in the JAX package's ``parallel/analysis.py`` names
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


class _Count(object):
    """A counter with the kernel wrappers' interface (``launches``,
    ``paths``) that is not a kernel launch."""

    counts_launches = False

    def __init__(self, name):
        self.__name__ = name
        self.launches = 0
        self.paths = {kind: 0 for kind in KINDS}


#: collectives issued, by kind in ``paths``
COLLECTIVES = _Count("collectives")
#: bytes of the collectives' results, by kind in ``paths``
COLLECTIVE_BYTES = _Count("collective bytes")
register_counters(COLLECTIVES, COLLECTIVE_BYTES)


def _count(kind, nbytes):
    COLLECTIVES.launches += 1
    COLLECTIVES.paths[kind] += 1
    COLLECTIVE_BYTES.launches += nbytes
    COLLECTIVE_BYTES.paths[kind] += nbytes


def _nbytes(tensor):
    return tensor.numel() * tensor.element_size()


def group_size(group):
    return dist.get_world_size(group)


def group_rank(group):
    return dist.get_rank(group)


# API drift: torch 2.13 names the tensor forms *_single
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_reduce(tensor, group, async_op=False):
    """Sum ``tensor`` over ``group`` in place; returns the work handle
    with ``async_op`` (wait on it before reading), else None."""
    _count("all-reduce", _nbytes(tensor))
    return dist.all_reduce(tensor, group=group, async_op=async_op)


def reduce_scatter(output, tensor, group, async_op=False):
    """Sum ``tensor`` over ``group``; rank r receives rows
    ``[r * len(output), (r + 1) * len(output))`` of the sum in
    ``output`` (``lax.psum_scatter(..., tiled=True)``)."""
    _count("reduce-scatter", _nbytes(output))
    return _reduce_scatter(output, tensor, group=group, async_op=async_op)


def all_gather(output, tensor, group, async_op=False):
    """Concatenate every rank's ``tensor`` along dim 0 into ``output``
    (``lax.all_gather(..., axis=0, tiled=True)``)."""
    _count("all-gather", _nbytes(output))
    return _all_gather(output, tensor, group=group, async_op=async_op)


def broadcast(tensor, src_rank, group):
    """Rank ``src_rank`` of ``group``'s ``tensor`` to every rank of it,
    in place."""
    _count("broadcast", _nbytes(tensor))
    dist.broadcast(tensor, src=dist.get_global_rank(group, src_rank),
                   group=group)


def _all_to_all(x, group, split_dim, concat_dim):
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)``: split ``x`` in ``n`` along ``split_dim``, send piece
    j to rank j, concatenate the pieces received along
    ``concat_dim`` in rank order."""
    n = group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError("all_to_all: dim %d of %s is not a multiple of "
                         "%d ranks" % (split_dim, tuple(x.shape), n))
    pieces = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
    out = torch.empty_like(pieces)
    _count("all-to-all", _nbytes(out))
    dist.all_to_all_single(out, pieces, group=group)
    return torch.cat(list(out.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(grad.contiguous(), ctx.group, concat_dim,
                            split_dim), None, None, None)


def all_to_all(x, group, split_dim, concat_dim):
    """Differentiable tiled all-to-all (its transpose swaps the two
    dims)."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _permute(x, group, shift):
    """Send ``x`` to group rank ``(me + shift) % n`` and return what
    group rank ``(me - shift) % n`` sent (``lax.ppermute`` with the
    permutation ``j -> (j + shift) % n``)."""
    n = group_size(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    me = group_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("collective-permute", _nbytes(out))
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + shift) % n),
                      group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - shift) % n),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, ctx.group, -ctx.shift), None, None


def ppermute(x, group, shift=1):
    """Differentiable ring shift over ``group`` (its transpose is the
    opposite shift)."""
    return _Permute.apply(x, group, shift)


class _Enter(torch.autograd.Function):
    """Identity forward, sum backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        all_reduce(grad, ctx.group)
        return grad, None


class _Leave(torch.autograd.Function):
    """Sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum_enter(x, group):
    """The Megatron ``f``: identity forward, the cotangent summed over
    ``group`` backward (a replicated activation entering a sharded
    region)."""
    return _Enter.apply(x, group)


def psum_leave(x, group):
    """The Megatron ``g``: ``x`` summed over ``group`` forward, the
    cotangent passed through backward (partial results leaving a
    sharded region)."""
    return _Leave.apply(x, group)
