"""Tensor parallelism: transformer blocks (and the annotation path's
all2all layers) split over a ``model`` mesh axis, Megatron style.

Counterpart of ``veles_tpu/parallel/tensor.py``.  Attention heads split
over the axis (each rank projects, attends and output-projects ITS
heads, through the port's flash-attention kernels), the position-wise
MLP splits W1 by columns and W2 by rows, so a block pays two activation
sums a direction, on the residual trunk.  The sums are the conjugate
pair :func:`psum_conjugates` — ``enter`` (identity forward, sum
backward) where a replicated activation enters a split region,
``leave`` (sum forward, identity backward) where partial results merge
— so every parameter gradient is right by construction: split
parameters get their local slices' gradients, replicated ones the same
whole gradient on every model rank.  The numerics guard sums the split
leaves' squares over the axis (:func:`sharded_gsq`), so every rank sees
one norm and a poisoned step skips on all of them.

Each rank holds its block of a TP entry as a (1, L_local) row (the
local view of the JAX package's (n, L_local) stack):
:func:`place_tp_state` gives it, :func:`gather_tp_state` collects every
rank's rows back into the global packed state.

Parity: the TP step sums the output projection as per-rank partial
contractions, another f32 grouping than the single-device step:
ULP-bounded, as in the reference.
"""

import numpy
import torch

from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

__all__ = ["psum_conjugates", "sharded_gsq", "mlp_tp_forward",
           "block_param_sizes_local", "split_block_shards",
           "merge_block_shards", "place_tp_state", "gather_tp_state",
           "tp_block_apply", "build_tp_train_step"]


def psum_conjugates(group):
    """(enter, leave): the Megatron f / g pair over ``group``."""
    def enter(x):
        return collectives.psum_enter(x, group)

    def leave(x):
        return collectives.psum_leave(x, group)
    return enter, leave


def sharded_gsq(grads, sharded, group):
    """The model-parallel guard's squared gradient sum: leaves of the
    layers in ``sharded`` (layer indices, or (layer, key) pairs for one
    leaf) are summed over ``group`` (each rank holds a slice), the rest
    add locally (bit-identical on every rank by construction)."""
    device = next(leaf.device for g in grads for leaf in g.values())
    shard_sq = torch.zeros((), dtype=torch.float32, device=device)
    repl_sq = torch.zeros((), dtype=torch.float32, device=device)
    for i, g in enumerate(grads):
        for key in sorted(g):
            sq = torch.sum(torch.square(g[key].to(torch.float32)))
            if i in sharded or (i, key) in sharded:
                shard_sq = shard_sq + sq
            else:
                repl_sq = repl_sq + sq
    shard_sq = shard_sq.clone()
    collectives.all_reduce(shard_sq, group)
    return shard_sq + repl_sq


# -- the annotation path's all2all split ------------------------------------


class _GatherLast(torch.autograd.Function):
    """Concatenate every rank's last-dim block (forward); this rank's
    block of the replicated cotangent (backward)."""

    @staticmethod
    def forward(ctx, x, group):
        n = collectives.group_size(group)
        ctx.group, ctx.width = group, x.shape[-1]
        x = x.contiguous()
        out = x.new_empty((n,) + tuple(x.shape))
        collectives.all_gather(out, x, group)
        return torch.cat(list(out.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        me = collectives.group_rank(ctx.group)
        return grad[..., me * ctx.width:(me + 1) * ctx.width], None


def mlp_tp_forward(plans, shardings, mesh, model_axis):
    """(forward_fn, sharded) of the annotation path's model split: a
    layer whose weights are ``Spec(None, model)`` runs column-split on
    the whole input (``enter``) and leaves its output split; one with
    ``Spec(model, None)`` runs row-split on the split input (taken
    from a whole one when needed), its partial products summed
    (``leave``) before its bias and activation; a split activation
    meets a whole layer or the loss only after an all-gather.  Split
    layers must be all2all layers.  ``sharded``: the (layer, key) pairs
    held split."""
    from veles_tpu_torch.compiler import _forward_for_loss
    from veles_tpu_torch.models.all2all import All2All, All2AllSoftmax
    group = axis_group(mesh, model_axis)
    n, me = axis_size(mesh, model_axis), axis_index(mesh, model_axis)
    enter, leave = psum_conjugates(group)
    kinds, sharded = [], set()
    for i, (plan, entry) in enumerate(zip(plans, shardings)):
        spec = tuple(entry.get("weights", ()))
        kind = {(None, model_axis): "column",
                (model_axis, None): "row"}.get(spec)
        if kind is not None and not issubclass(plan.forward_cls, All2All):
            raise ValueError("layer %d (%s): the annotation path splits "
                             "all2all layers only" % (
                                 i, plan.forward_cls.__name__))
        kinds.append(kind)
        for key, leaf_spec in entry.items():
            if any(axis is not None for axis in leaf_spec):
                sharded.add((i, key))

    def activate(plan, z):
        if plan.forward_cls is All2AllSoftmax:
            return z  # the logits: the loss applies the softmax
        return plan.forward_cls._activate(z)

    def forward_fn(params, x, key, remat):
        h, split = x, False
        for i, (plan, p) in enumerate(zip(plans, params)):
            kind = kinds[i]
            if kind != "row" and split:
                h, split = _GatherLast.apply(h, group), False
            if kind is None:
                # the stock walk of one layer, keyed on its index
                h = _forward_for_loss([plan], [p], h, key, remat=remat,
                                      fold_offset=i)
            elif kind == "column":
                apply = (All2All.apply if plan.forward_cls is All2AllSoftmax
                         else plan.forward_cls.apply)
                h, split = apply(p, enter(h)), True
            else:
                h2 = h.reshape(h.shape[0], -1)
                if not split:
                    width = h2.shape[1] // n
                    h2 = enter(h2)[:, me * width:(me + 1) * width]
                z = leave(h2.to(torch.float32) @ p["weights"])
                if p.get("bias") is not None:
                    z = z + p["bias"]
                h, split = activate(plan, z).to(h2.dtype), False
        if split:
            h = _GatherLast.apply(h, group)
        return h

    return forward_fn, sharded


# -- packed-layout shard plumbing -------------------------------------------


def block_param_sizes_local(d, hidden, n_shards):
    """Per-shard (name, shape) layout of one TP transformer block:
    Wq/Wk/Wv keep their head-slice columns, Wo its head-slice rows, W1
    its hidden columns, W2 its hidden rows; the LN gains and the
    post-sum biases (b_o, b2) are whole on every shard."""
    dl, hl = d // n_shards, hidden // n_shards
    weights = [("ln1_gamma", (d,)), ("w_qkv", (d, 3 * dl)),
               ("w_o", (dl, d)), ("ln2_gamma", (d,)),
               ("w1", (d, hl)), ("w2", (hl, d))]
    bias = [("ln1_beta", (d,)), ("b_qkv", (3 * dl,)), ("b_o", (d,)),
            ("ln2_beta", (d,)), ("b1", (hl,)), ("b2", (d,))]
    return weights, bias


def _pack(pieces, layout):
    return numpy.concatenate(
        [numpy.asarray(pieces[name]).ravel() for name, _ in layout])


def split_block_shards(weights, bias, d, heads, hidden, n_shards):
    """Global packed (weights, bias) -> (n_shards, L_local) stacked host
    arrays, head-aligned: shard s owns heads [s*H/n, (s+1)*H/n)."""
    from veles_tpu_torch.models.transformer import split_block_params
    if heads % n_shards or hidden % n_shards:
        raise ValueError("heads %d / hidden %d not divisible by "
                         "model shards %d" % (heads, hidden, n_shards))
    wp, bp = split_block_params(numpy.asarray(weights),
                                numpy.asarray(bias), d, hidden)
    dl, hl = d // n_shards, hidden // n_shards
    layout_w, layout_b = block_param_sizes_local(d, hidden, n_shards)
    w_rows, b_rows = [], []
    wq, wk, wv = (wp["w_qkv"][:, :d], wp["w_qkv"][:, d:2 * d],
                  wp["w_qkv"][:, 2 * d:])
    bq, bk, bv = bp["b_qkv"][:d], bp["b_qkv"][d:2 * d], bp["b_qkv"][2 * d:]
    for s in range(n_shards):
        cols = slice(s * dl, (s + 1) * dl)
        hcols = slice(s * hl, (s + 1) * hl)
        w_rows.append(_pack({
            "ln1_gamma": wp["ln1_gamma"],
            "w_qkv": numpy.concatenate(
                [wq[:, cols], wk[:, cols], wv[:, cols]], axis=1),
            "w_o": wp["w_o"][cols, :],
            "ln2_gamma": wp["ln2_gamma"],
            "w1": wp["w1"][:, hcols],
            "w2": wp["w2"][hcols, :],
        }, layout_w))
        b_rows.append(_pack({
            "ln1_beta": bp["ln1_beta"],
            "b_qkv": numpy.concatenate([bq[cols], bk[cols], bv[cols]]),
            "b_o": bp["b_o"],
            "ln2_beta": bp["ln2_beta"],
            "b1": bp["b1"][hcols],
            "b2": bp["b2"],
        }, layout_b))
    return numpy.stack(w_rows), numpy.stack(b_rows)


def merge_block_shards(w_stacked, b_stacked, d, heads, hidden):
    """Inverse of :func:`split_block_shards`: (n, L_local) stacks back to
    the global packed (weights, bias); the whole pieces come from shard
    0 (the TP step keeps them bit-identical across shards)."""
    from veles_tpu_torch.models.transformer import (_unpack,
                                                    block_param_sizes)
    del heads
    w_stacked, b_stacked = numpy.asarray(w_stacked), numpy.asarray(b_stacked)
    n = w_stacked.shape[0]
    dl = d // n
    layout_w, layout_b = block_param_sizes_local(d, hidden, n)
    locals_w = [_unpack(w_stacked[s], layout_w) for s in range(n)]
    locals_b = [_unpack(b_stacked[s], layout_b) for s in range(n)]
    wq = numpy.concatenate([lw["w_qkv"][:, :dl] for lw in locals_w], 1)
    wk = numpy.concatenate([lw["w_qkv"][:, dl:2 * dl]
                            for lw in locals_w], 1)
    wv = numpy.concatenate([lw["w_qkv"][:, 2 * dl:]
                            for lw in locals_w], 1)
    merged_w = {
        "ln1_gamma": locals_w[0]["ln1_gamma"],
        "w_qkv": numpy.concatenate([wq, wk, wv], axis=1),
        "w_o": numpy.concatenate([lw["w_o"] for lw in locals_w], 0),
        "ln2_gamma": locals_w[0]["ln2_gamma"],
        "w1": numpy.concatenate([lw["w1"] for lw in locals_w], 1),
        "w2": numpy.concatenate([lw["w2"] for lw in locals_w], 0),
    }
    merged_b = {
        "ln1_beta": locals_b[0]["ln1_beta"],
        "b_qkv": numpy.concatenate(
            [numpy.concatenate([lb["b_qkv"][i * dl:(i + 1) * dl]
                                for lb in locals_b])
             for i in range(3)]),
        "b_o": locals_b[0]["b_o"],
        "ln2_beta": locals_b[0]["ln2_beta"],
        "b1": numpy.concatenate([lb["b1"] for lb in locals_b]),
        "b2": locals_b[0]["b2"],
    }
    layout_gw, layout_gb = block_param_sizes(d, hidden)
    return _pack(merged_w, layout_gw), _pack(merged_b, layout_gb)


def _tp_plan(plan):
    from veles_tpu_torch.models.transformer import TransformerBlock
    return plan.forward_cls is TransformerBlock


def _packed_d(packed_len, hidden, local=False, n=1):
    """Solve the packed length for the feature dim d.

    Global: L = 2d + 4d^2 + 2*d*hidden.
    Local (per shard): L = 2d + 4d^2/n + 2*d*hidden/n.
    """
    for d in range(1, 1 << 16):
        if local:
            if n * (2 * d) + 4 * d * d + 2 * d * hidden == \
                    packed_len * n:
                return d
        elif 2 * d + 4 * d * d + 2 * d * hidden == packed_len:
            return d
    raise ValueError("packed length %d matches no feature dim"
                     % packed_len)


_PAIRS = (("weights", "bias"), ("accum_weights", "accum_bias"),
          ("accum2_weights", "accum2_bias"))


def place_tp_state(mesh, plans, state, device, model_axis="model"):
    """Host state -> this rank's TP state on ``device``: a transformer
    block's entries split per shard, this rank's (1, L_local) row of
    each; every other entry whole."""
    n, me = axis_size(mesh, model_axis), axis_index(mesh, model_axis)

    def put(value):
        return torch.as_tensor(numpy.ascontiguousarray(value),
                               device=device)
    placed = []
    for plan, entry in zip(plans, state):
        if not _tp_plan(plan):
            placed.append({k: None if v is None else put(v)
                           for k, v in entry.items()})
            continue
        heads, hidden = plan.static["heads"], plan.static["hidden"]
        d = _packed_d(int(numpy.prod(numpy.shape(entry["weights"]))),
                      hidden)
        out = {}
        for wkey, bkey in _PAIRS:
            wv, bv = entry.get(wkey), entry.get(bkey)
            if wv is None:
                out[wkey], out[bkey] = None, None
                continue
            ws, bs = split_block_shards(wv, bv, d, heads, hidden, n)
            out[wkey], out[bkey] = put(ws[me:me + 1]), put(bs[me:me + 1])
        placed.append(out)
    return placed


def _gather_rows(row, group):
    row = row.contiguous()
    out = row.new_empty((collectives.group_size(group),) +
                        tuple(row.shape[1:]))
    collectives.all_gather(out, row, group)
    return out.cpu().numpy()


def gather_tp_state(mesh, plans, tp_state, model_axis="model"):
    """Every rank's TP state back to the global host state (numpy):
    each TP entry's rows all-gathered over ``model_axis`` and merged.
    Called on every rank of the axis."""
    group = axis_group(mesh, model_axis)
    merged = []
    for plan, entry in zip(plans, tp_state):
        if not _tp_plan(plan):
            merged.append({k: None if v is None else v.cpu().numpy().copy()
                           for k, v in entry.items()})
            continue
        heads, hidden = plan.static["heads"], plan.static["hidden"]
        n = axis_size(mesh, model_axis)
        d = _packed_d(entry["weights"].shape[1], hidden, local=True, n=n)
        out = {}
        for wkey, bkey in _PAIRS:
            wv, bv = entry.get(wkey), entry.get(bkey)
            if wv is None:
                out[wkey], out[bkey] = None, None
                continue
            out[wkey], out[bkey] = merge_block_shards(
                _gather_rows(wv, group), _gather_rows(bv, group), d,
                heads, hidden)
        merged.append(out)
    return merged


# -- the sharded forward -----------------------------------------------------


def tp_block_apply(w_local, b_local, x, *, heads, hidden, n_shards, group,
                   eps=1e-5):
    """One pre-LN block over this rank's packed params: LN and the
    residuals whole; QKV, attention (the port's flash kernels on the
    local heads) and W1 on this shard's heads / columns through the
    single-device block's sub-layer cores; the two ``leave`` sums merge
    the output projections, then the whole biases (b_o, b2) add."""
    from veles_tpu_torch.models.transformer import (_dense, _unpack,
                                                    attention_heads,
                                                    layer_norm,
                                                    position_wise_mlp)
    d = x.shape[-1]
    layout_w, layout_b = block_param_sizes_local(d, hidden, n_shards)
    wp = _unpack(w_local, layout_w)
    bp = _unpack(b_local, layout_b)
    enter, leave = psum_conjugates(group)

    ln1 = layer_norm(x, wp["ln1_gamma"], bp["ln1_beta"], eps)
    o = attention_heads(enter(ln1), wp["w_qkv"], bp["b_qkv"],
                        heads // n_shards)
    attn = leave(_dense(o, wp["w_o"])) + bp["b_o"]
    h = x + attn.to(x.dtype)

    ln2 = layer_norm(h, wp["ln2_gamma"], bp["ln2_beta"], eps)
    part2 = position_wise_mlp(enter(ln2), wp["w1"], bp["b1"], wp["w2"])
    return (h + (leave(part2) + bp["b2"]).to(x.dtype)).to(x.dtype)


def build_tp_train_step(plans, loss="softmax", mesh=None,
                        model_axis="model", data_axis=None,
                        grad_bucket_mb=None, grad_compress=None,
                        grad_allreduce_impl="psum", donate=True,
                        graphs=None):
    """The tensor-parallel train step: transformer-block entries held as
    this rank's (1, L_local) rows (:func:`place_tp_state`), their
    activations summed over ``model_axis``; with ``data_axis`` each rank
    passes its rows of the batch and the gradients are summed over that
    axis by the bucketed all-reduce (``grad_bucket_mb``, default one
    bucket).  Same contract as ``compiler.build_train_step``."""
    import math as _math

    from veles_tpu_torch import compiler as _compiler

    if mesh is None:
        raise ValueError("build_tp_train_step needs a mesh")
    n = axis_size(mesh, model_axis)
    model_group = axis_group(mesh, model_axis)
    tp_flags = [_tp_plan(p) for p in plans]
    if not any(tp_flags):
        raise ValueError("no transformer-block layers to shard over "
                         "%r" % model_axis)

    grad_sync = metric_sync = row_offset_fn = None
    rank = 0
    if data_axis is not None:
        bucket_bytes = (
            float("inf") if grad_bucket_mb is None
            or _math.isinf(float(grad_bucket_mb))
            else float(grad_bucket_mb) * 2.0 ** 20)
        group = axis_group(mesh, data_axis)
        rank = axis_index(mesh, data_axis)
        grad_sync = _compiler._GradSync(group, bucket_bytes,
                                        grad_allreduce_impl, grad_compress)
        metric_sync = _compiler._metric_sync(group)

        def row_offset_fn(x):
            return rank * x.shape[0]

    tp_indices = {i for i, flag in enumerate(tp_flags) if flag}

    def gsq_fn(grads):
        return sharded_gsq(grads, tp_indices, model_group)

    def forward_fn(params, x, key, remat):
        h = x
        for i, (plan, p) in enumerate(zip(plans, params)):
            if tp_flags[i]:
                h = tp_block_apply(
                    p["weights"][0], p["bias"][0], h,
                    heads=plan.static["heads"],
                    hidden=plan.static["hidden"], n_shards=n,
                    group=model_group, eps=plan.static.get("eps", 1e-5))
            else:
                # the stock walk of one layer, keyed on its index
                h = _compiler._forward_for_loss([plan], [p], h, key,
                                                remat=remat, fold_offset=i)
        return h

    raw = _compiler._build_step_fn(
        plans, loss, in_place=donate, grad_sync=grad_sync,
        metric_sync=metric_sync, row_offset_fn=row_offset_fn,
        forward_fn=forward_fn, gsq_fn=gsq_fn)
    if data_axis is not None:
        # a distinct dropout stream a DATA rank; model ranks share it
        # (their activations are whole)
        raw = _compiler._keyed_by_rank(raw, rank)
    step = _compiler._finalize_step(plans, loss, raw, donate, graphs,
                                    mesh=mesh, model_axis=model_axis,
                                    data_axis=data_axis, bucket_plan=None)
    if grad_sync is not None:
        grad_sync.bind(step)
    return step
