"""Pipeline parallelism over a mesh axis (GPipe-style microbatching).

Counterpart of ``veles_tpu/parallel/pipeline.py``.  Each rank of the
``pipe`` axis holds ONE stage (its parameters as (1, ...) rows, the
local view of the JAX package's stage stack).  The schedule is the
skewed wavefront: at tick t, rank p runs microbatch (t - p); the
activations hop to the next stage each tick (``collectives.ppermute``,
whose transpose sends the cotangents back); M + P - 1 ticks for M
microbatches over P stages.  Autograd through the ticks is the backward
pipeline.  Every rank runs every tick, as the JAX scan does: warm-up
and drain ticks process finite garbage whose outputs get exact-zero
cotangents (``torch.where``, as ``jnp.where``), so every rank's
backward makes the same sends and receives and the garbage adds exact
zeros to the gradients.

Every stage maps activations to the same shape — the transformer-block
contract ((B, T, D) -> (B, T, D)) — so :func:`build_pipeline_train_step`
splits a model's contiguous block run into contiguous stage groups
(the port's ``TransformerBlock``: flash-attention kernels 6-8), and
keeps the prefix and tail layers whole, trained off the final
activations summed to every rank (the ``leave`` conjugate).
"""

import numpy
import torch

from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

__all__ = ["pipeline_forward", "stack_stage_params",
           "stage_param_sharding", "build_pipeline_train_step",
           "stack_pipeline_state", "unstack_pipeline_state"]


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] -> tree with a leading stage dim
    (dicts of tensors or arrays)."""
    first = per_stage_params[0]
    return {key: torch.stack([torch.as_tensor(p[key])
                              for p in per_stage_params])
            for key in first}


def stage_param_sharding(mesh, params_stacked, axis="pipe"):
    """This rank's (1, ...) row of every stacked leaf."""
    me = axis_index(mesh, axis)
    return {key: leaf[me:me + 1].contiguous()
            for key, leaf in params_stacked.items()}


def _wavefront(stage_fn, my_params, x_full, p, group, n_stages,
               microbatches, batch):
    """The skewed wavefront: returns the (batch, ...) result as the LAST
    stage produces it (garbage elsewhere: callers mask and sum)."""
    if batch % microbatches:
        raise ValueError("batch %d %% microbatches %d != 0"
                         % (batch, microbatches))
    mbs = x_full.reshape((microbatches, batch // microbatches) +
                         tuple(x_full.shape[1:]))
    ticks = microbatches + n_stages - 1
    first = torch.full((), p == 0, dtype=torch.bool,
                       device=x_full.device)
    buf = torch.zeros_like(mbs[0])
    outs = []
    for t in range(ticks):
        inject = mbs[min(max(t - p, 0), microbatches - 1)]
        current = torch.where(first, inject, buf)
        out = stage_fn(my_params, current)
        buf = collectives.ppermute(out, group, 1)
        outs.append(out)
    # the last stage emits microbatch m at tick m + (P-1)
    tail = torch.stack(outs[n_stages - 1:n_stages - 1 + microbatches])
    return tail.reshape((batch,) + tuple(x_full.shape[1:]))


def _replicate_last(result, p, n_stages, group):
    """The last stage's result on every rank (sum forward, identity
    backward)."""
    last = torch.full((), p == n_stages - 1, dtype=torch.bool,
                      device=result.device)
    return collectives.psum_leave(
        torch.where(last, result, torch.zeros_like(result)), group)


def pipeline_forward(stage_fn, params_local, x, mesh, microbatches,
                     axis="pipe", data_axis=None):
    """Run this rank's rows x (B, ...) through the pipelined stages;
    returns (B, ...) on every rank of ``axis``.  stage_fn(stage_params,
    activation) -> activation (same shape); ``params_local`` this
    rank's (1, ...) stage rows (:func:`stage_param_sharding`).
    ``data_axis`` names the axis the caller split the batch over (each
    data row runs its own wavefront)."""
    del data_axis
    group = axis_group(mesh, axis)
    n_stages, p = axis_size(mesh, axis), axis_index(mesh, axis)
    my_params = {key: leaf[0] for key, leaf in params_local.items()}
    result = _wavefront(stage_fn, my_params, x, p, group, n_stages,
                        microbatches, x.shape[0])
    return _replicate_last(result, p, n_stages, group)


# -- the pipeline-parallel train step ---------------------------------------


def _stage_split(plans):
    """(start, stop): the contiguous run of TransformerBlock plans is
    the stage payload; everything before / after stays whole."""
    from veles_tpu_torch.models.transformer import TransformerBlock
    flags = [p.forward_cls is TransformerBlock for p in plans]
    if not any(flags):
        raise ValueError("no transformer-block layers to stage-split")
    start = flags.index(True)
    stop = len(flags) - flags[::-1].index(True)
    if not all(flags[start:stop]):
        raise ValueError("transformer blocks must be contiguous for "
                         "the stage split")
    return start, stop


def _per_stage(plans, n_stages):
    start, stop = _stage_split(plans)
    n_blocks = stop - start
    if n_blocks % n_stages:
        raise ValueError("%d transformer blocks %% %d stages != 0"
                         % (n_blocks, n_stages))
    return start, stop, n_blocks // n_stages


def stack_pipeline_state(mesh, plans, state, device, axis="pipe"):
    """Host state -> this rank's pipeline state on ``device``: entry j
    of the block run holds block (stage * per_stage + j) of this rank's
    stage as (1, ...) rows; prefix / tail entries whole.  Returns
    (state, layout); ``layout`` feeds :func:`unstack_pipeline_state`."""
    n_stages, me = axis_size(mesh, axis), axis_index(mesh, axis)
    start, stop, per_stage = _per_stage(plans, n_stages)

    def put(value, row=False):
        value = numpy.asarray(value)
        return torch.as_tensor(numpy.ascontiguousarray(
            value[None] if row else value), device=device)

    def whole(entry):
        return {k: None if v is None else put(v) for k, v in entry.items()}

    placed = [whole(e) for e in state[:start]]
    for j in range(per_stage):
        entry = state[start + me * per_stage + j]
        placed.append({k: None if v is None else put(v, row=True)
                       for k, v in entry.items()})
    placed += [whole(e) for e in state[stop:]]
    layout = {"start": start, "stop": stop, "per_stage": per_stage,
              "n_stages": n_stages}
    return placed, layout


def unstack_pipeline_state(mesh, placed, layout, axis="pipe"):
    """Every rank's pipeline state back to the global host state
    (numpy), each stage's rows all-gathered over ``axis``.  Called on
    every rank of the axis."""
    group = axis_group(mesh, axis)
    start, per_stage = layout["start"], layout["per_stage"]
    n_stages = layout["n_stages"]

    def host(entry):
        return {k: None if v is None else v.cpu().numpy().copy()
                for k, v in entry.items()}

    def gathered(leaf):
        leaf = leaf.contiguous()
        out = leaf.new_empty((n_stages,) + tuple(leaf.shape[1:]))
        collectives.all_gather(out, leaf, group)
        return out.cpu().numpy()

    stacked = [{k: None if v is None else gathered(v)
                for k, v in entry.items()}
               for entry in placed[start:start + per_stage]]
    state = [host(e) for e in placed[:start]]
    for s in range(n_stages):
        for j in range(per_stage):
            state.append({k: None if v is None else v[s]
                          for k, v in stacked[j].items()})
    state += [host(e) for e in placed[start + per_stage:]]
    return state


def build_pipeline_train_step(plans, loss="softmax", mesh=None,
                              axis="pipe", microbatches=1, donate=True,
                              graphs=None):
    """The pipeline-parallel train step: the model's contiguous
    transformer-block run split into ``axis``-many contiguous stage
    groups driven through the wavefront; prefix / tail layers whole,
    off the stage stack's output summed to every rank.  State from
    :func:`stack_pipeline_state`.  The guard sums the stage leaves'
    squares over the axis, so a poisoned step skips on every stage.
    Same contract as ``compiler.build_train_step``."""
    from veles_tpu_torch import compiler as _compiler
    from veles_tpu_torch.models.transformer import TransformerBlock
    from veles_tpu_torch.parallel.tensor import psum_conjugates, sharded_gsq

    if mesh is None:
        raise ValueError("build_pipeline_train_step needs a mesh")
    group = axis_group(mesh, axis)
    n_stages, p = axis_size(mesh, axis), axis_index(mesh, axis)
    start, stop, per_stage = _per_stage(plans, n_stages)
    block_plans = plans[start:stop]
    for plan in block_plans[1:]:
        if plan.hyper_full() != block_plans[0].hyper_full() or \
                plan.static != block_plans[0].static:
            raise ValueError(
                "stage-split blocks must share hyper/static config "
                "(stacked entries update under one plan)")
    # the step's plan list: one entry a block slot of this stage
    step_plans = (plans[:start] + block_plans[:per_stage] +
                  plans[stop:])
    enter, _ = psum_conjugates(group)
    statics = [pl.static for pl in block_plans[:per_stage]]

    def stage_fn(block_params, a):
        for bp, static in zip(block_params, statics):
            a = TransformerBlock.apply(bp, a, **static)
        return a

    def forward_fn(params, x, key, remat):
        prefix = params[:start]
        stacked = params[start:start + per_stage]
        tail = params[start + per_stage:]
        h = x
        if prefix:
            h = _compiler._forward_for_loss(plans[:start], prefix, h, key,
                                            remat=remat)
            # the wavefront reads h on stage 0 only, so the prefix's
            # cotangent is zero elsewhere; enter sums it, making the
            # prefix update the same on every rank
            h = enter(h)
        my_blocks = [{k: None if v is None else v[0] for k, v in e.items()}
                     for e in stacked]
        result = _wavefront(stage_fn, my_blocks, h, p, group, n_stages,
                            microbatches, h.shape[0])
        h = _replicate_last(result, p, n_stages, group)
        if tail:
            # dropout after the block run keys on its GLOBAL layer index
            h = _compiler._forward_for_loss(plans[stop:], tail, h, key,
                                            remat=remat, fold_offset=stop)
        return h

    staged = set(range(start, start + per_stage))

    def gsq_fn(grads):
        return sharded_gsq(grads, staged, group)

    raw = _compiler._build_step_fn(step_plans, loss, in_place=donate,
                                   forward_fn=forward_fn, gsq_fn=gsq_fn)
    return _compiler._finalize_step(step_plans, loss, raw, donate, graphs,
                                    mesh=mesh, pipe_axis=axis,
                                    microbatches=microbatches)
