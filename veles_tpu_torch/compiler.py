"""The workflow compiler of ``veles_tpu/compiler.py``: ``LayerPlan``,
the inference forward and the fused training step and epochs.

PyTorch runs eagerly, so the "compiled" functions are plain Python over
a state list of ``{"weights", "bias", "accum_weights", "accum_bias",
"accum2_weights", "accum2_bias"}`` tensor dicts (``None`` for a leaf a
layer lacks).  The walk follows the JAX one: a softmax layer keeps its
logits and the softmax (or the cross-entropy) is applied once at the
tail; dropout is the identity at inference and in keyless steps.

The train step (:func:`build_train_step`) differentiates the loss with
``torch.autograd``.  Its conv and max-pool layers run the port's fused
backwards (``ops/conv_vjp.py``, ``ops/pool_bwd.py``), so on the card
every step launches the ``conv_wgrad`` and ``max_pool_bwd`` kernels;
the epoch functions gather each minibatch with the ``gather_minibatch``
kernel.  A step keeps its metrics as device tensors (no ``.item()``, no
host sync) and never updates the caller's state in place: it returns
new leaf tensors, and a step whose loss or gradient norm is not finite
returns the old leaves themselves, bit for bit.  The JAX package's
buffer donation has no counterpart: the old state is freed when the
caller drops it.
"""

import functools

import torch

from veles_tpu_torch import threefry
from veles_tpu_torch.models.nn_units import GradientDescentBase

__all__ = ["LayerPlan", "build_forward", "build_train_step",
           "build_train_epoch", "build_eval_epoch", "workflow_plan",
           "extract_state", "adopt_state", "state_arrays", "STATE_KEYS"]

#: where the parallel and memory-saving variants of the step are queued
_QUEUED = "not ported yet: ROADMAP.md Queue 1 item 8 (parallel layer)"


class LayerPlan(object):
    """Static per-layer compile info: forward class, solver, hyper."""

    def __init__(self, forward_cls, solver="momentum", hyper=None,
                 include_bias=True, static=None):
        self.forward_cls = forward_cls
        self.solver = solver
        self.hyper = hyper or {}
        self.include_bias = include_bias
        self.static = static or {}

    def hyper_full(self):
        base = {
            "learning_rate": 0.01, "learning_rate_bias": None,
            "weights_decay": 0.0, "weights_decay_bias": 0.0,
            "l1_vs_l2": 0.0, "gradient_moment": 0.0,
            "gradient_moment_bias": None, "adadelta_rho": 0.95,
            "solver_epsilon": 1e-6,
        }
        base.update(self.hyper)
        if base["learning_rate_bias"] is None:
            base["learning_rate_bias"] = base["learning_rate"]
        if base["gradient_moment_bias"] is None:
            base["gradient_moment_bias"] = base["gradient_moment"]
        return base


#: the leaves of one layer's state entry, in the JAX package's order
STATE_KEYS = ("weights", "bias", "accum_weights", "accum_bias",
              "accum2_weights", "accum2_bias")


def state_arrays(fwd, gd):
    """(key, Array) pairs of one layer's state entry: the forward unit's
    weights and bias, its GD unit's accumulators."""
    return zip(STATE_KEYS, (fwd.weights, fwd.bias, gd.accum_weights,
                            gd.accum_bias, gd.accum2_weights,
                            gd.accum2_bias))


def workflow_plan(sw):
    """LayerPlans of a StandardWorkflow's forward and GD units."""
    return [LayerPlan(type(fwd), solver=gd.solver, hyper=gd.hyper_dict(),
                      include_bias=fwd.include_bias,
                      static=fwd.static_config())
            for fwd, gd in zip(sw.forwards, sw.gds)]


def extract_state(sw):
    """The state list of a StandardWorkflow: each layer's parameter and
    solver-state Arrays' device tensors (``None`` for an empty
    Array)."""
    return [{key: arr.devmem if arr else None
             for key, arr in state_arrays(fwd, gd)}
            for fwd, gd in zip(sw.forwards, sw.gds)]


def adopt_state(sw, new_state, device=None):
    """Hand a fused step's state list back to the workflow's Arrays.
    The Arrays adopt the tensors as they are: a step never updates a
    tensor in place, so nothing is copied."""
    for (fwd, gd), entry in zip(zip(sw.forwards, sw.gds), new_state):
        for key, arr in state_arrays(fwd, gd):
            if entry.get(key) is not None and arr:
                arr.set_device_array(entry[key], device or fwd.device)


def _forward_for_loss(plans, params, x, key=None):
    """Forward pass; returns the pre-softmax logits of a softmax tail,
    else the final output.  ``key``: the step's threefry key (a pair of
    ints); layer i's dropout mask is drawn from ``fold_in(key, i)``, as
    the JAX package draws it.  None makes dropout the identity
    (inference, keyless steps)."""
    from veles_tpu_torch.models.all2all import All2All, All2AllSoftmax
    from veles_tpu_torch.models.dropout import DropoutForward

    h = x
    for i, (plan, p) in enumerate(zip(plans, params)):
        if plan.forward_cls is All2AllSoftmax:
            h = All2All.apply(p, h)
        elif issubclass(plan.forward_cls, DropoutForward):
            if key is not None:
                h = h * DropoutForward.make_mask(
                    threefry.fold_in(key, i), h.shape,
                    plan.static.get("dropout_ratio", 0.5), h.dtype,
                    h.device)
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


def _loss(loss, out, target, batch_size):
    """(loss value, aux): softmax cross-entropy over the rows whose
    label is >= 0 and the error count, or the squared error over the
    first ``batch_size`` rows and its per-sample-mean sum."""
    if loss == "softmax":
        valid = target >= 0
        safe = torch.where(valid, target, torch.zeros_like(target)).long()
        logp = torch.log_softmax(out, dim=-1)
        picked = logp.gather(1, safe[:, None])[:, 0]
        total = -torch.sum(picked * valid.to(picked.dtype))
        pred = torch.argmax(out, dim=-1)
        n_err = torch.sum((pred != safe) & valid).to(torch.int32)
        return total / batch_size, n_err
    if loss != "mse":
        raise ValueError("unknown loss %r (known: softmax, mse)" % loss)
    out2 = out.reshape(out.shape[0], -1)
    t2 = target.reshape(target.shape[0], -1)
    rows = torch.arange(out2.shape[0], device=out2.device)
    mask = (rows < batch_size).to(out2.dtype)[:, None]
    diff = (out2 - t2) * mask
    mse_sum = torch.sum(torch.sum(diff * diff, dim=1) / out2.shape[1])
    return torch.sum(diff * diff) / batch_size, mse_sum


def _apply_solver(plans, hypers, state, grads):
    new_state = []
    for plan, hyper, s, g in zip(plans, hypers, state, grads):
        if s["weights"] is None:  # param-less layer (pooling, ...)
            new_state.append(dict(s))
            continue
        w = s["weights"]
        gw = GradientDescentBase.regularized(
            g["weights"].to(w.dtype), w, hyper["weights_decay"],
            hyper["l1_vs_l2"])
        new_w, acc_w, acc2_w = GradientDescentBase.solver_update(
            plan.solver, w, gw, s["accum_weights"], s["accum2_weights"],
            hyper["learning_rate"], hyper["gradient_moment"],
            hyper["adadelta_rho"], hyper["solver_epsilon"])
        entry = {"weights": new_w, "accum_weights": acc_w,
                 "accum2_weights": acc2_w,
                 "bias": s["bias"], "accum_bias": s["accum_bias"],
                 "accum2_bias": s["accum2_bias"]}
        if plan.include_bias and s["bias"] is not None:
            b = s["bias"]
            gb = GradientDescentBase.regularized(
                g["bias"].to(b.dtype), b, hyper["weights_decay_bias"],
                hyper["l1_vs_l2"])
            new_b, acc_b, acc2_b = GradientDescentBase.solver_update(
                plan.solver, b, gb, s["accum_bias"], s["accum2_bias"],
                hyper["learning_rate_bias"],
                hyper["gradient_moment_bias"], hyper["adadelta_rho"],
                hyper["solver_epsilon"])
            entry.update({"bias": new_b, "accum_bias": acc_b,
                          "accum2_bias": acc2_b})
        new_state.append(entry)
    return new_state


def _build_step_fn(plans, loss):
    """fn(state, x, target, batch_size, step_key=None, grad_poison=None,
    loss_poison=None) -> (new_state, metrics), shared by
    :func:`build_train_step` and :func:`build_train_epoch`."""
    hypers = [p.hyper_full() for p in plans]

    def step(state, x, target, batch_size, step_key=None,
             grad_poison=None, loss_poison=None):
        params, leaves = [], []
        for s in state:
            entry = {}
            for key in ("weights", "bias"):
                leaf = s[key]
                if leaf is not None:
                    leaf = leaf.detach().requires_grad_(True)
                    leaves.append((len(params), key, leaf))
                entry[key] = leaf
            params.append(entry)
        with torch.enable_grad():
            out = _forward_for_loss(plans, params, x, step_key)
            loss_value, aux = _loss(loss, out, target, batch_size)
            flat = torch.autograd.grad(loss_value,
                                       [leaf for _, _, leaf in leaves])
        loss_value = loss_value.detach()
        grads = [{} for _ in state]
        for (i, key, _), g in zip(leaves, flat):
            if grad_poison is not None:
                # the chaos harness's nan-injection, where a real
                # numeric fault would appear: right after the backward
                g = g + torch.as_tensor(grad_poison, dtype=g.dtype,
                                        device=g.device)
            grads[i][key] = g
        if loss_poison is not None:
            loss_value = loss_value + torch.as_tensor(
                loss_poison, dtype=loss_value.dtype,
                device=loss_value.device)

        # the numerics guard: one isfinite over the loss and the global
        # gradient norm; a single inf/nan in any leaf makes the norm
        # non-finite.  Both stay device tensors.
        gsq = torch.zeros((), dtype=torch.float32,
                          device=loss_value.device)
        for g in grads:
            for leaf in g.values():
                gsq = gsq + torch.sum(torch.square(leaf.to(torch.float32)))
        grad_norm = torch.sqrt(gsq)
        step_finite = torch.isfinite(loss_value) & torch.isfinite(grad_norm)

        new_state = _apply_solver(plans, hypers, state, grads)
        # a non-finite update is SKIPPED: every leaf falls back to its
        # pre-step value, params and solver accumulators alike
        new_state = [GradientDescentBase.select_state(step_finite, entry,
                                                      old)
                     for entry, old in zip(new_state, state)]
        if loss == "softmax":
            metrics = {"loss": loss_value, "n_err": aux}
        else:
            metrics = {"loss": loss_value,
                       "n_err": torch.zeros((), dtype=torch.int32,
                                            device=loss_value.device),
                       "mse_sum": aux.detach()}
        metrics["grad_norm"] = grad_norm
        metrics["finite"] = step_finite
        metrics["skipped"] = (~step_finite).to(torch.int32)
        return new_state, metrics

    return step


def build_train_step(plans, loss="softmax", mesh=None, grad_bucket_mb=None,
                     grad_compress=None, bwd_schedule=None, bwd_remat=False,
                     zero=None):
    """fn(state, x, labels_or_targets, batch_size, step_key=None,
    grad_poison=None, loss_poison=None) -> (new_state, metrics).

    metrics: {"loss", "n_err"} (+ "mse_sum" for mse) and the
    numerics-health trio {"grad_norm", "finite", "skipped"}, all device
    tensors.  A step whose loss or global gradient norm is not finite
    leaves every state leaf as it was (``skipped`` = 1).
    ``grad_poison`` / ``loss_poison`` are the chaos harness's scalar
    nan-injection hooks.  ``step_key``: the threefry key of the
    dropout masks (a pair of ints, ``veles_tpu_torch.threefry``), or
    None for a keyless step.

    ``bwd_schedule`` (an XLA scheduling hint, identity on values) is
    accepted and has no effect.  ``mesh``, ``grad_bucket_mb``,
    ``grad_compress``, ``zero`` and ``bwd_remat`` raise
    ``NotImplementedError``."""
    del bwd_schedule
    for name, value in (("mesh", mesh), ("grad_bucket_mb", grad_bucket_mb),
                        ("grad_compress", grad_compress), ("zero", zero),
                        ("bwd_remat", bwd_remat)):
        if value:
            raise NotImplementedError("build_train_step(%s=...) is %s"
                                      % (name, _QUEUED))
    return _build_step_fn(plans, loss)


def _as_order(order, device):
    order = torch.as_tensor(order, device=device)
    if order.ndim != 1:
        raise ValueError("order must be 1-D, got %s" % (tuple(order.shape),))
    return order


def _tail_schedule(order, batch, what):
    """Ceil-div step count, edge-padded order (the callers mask the
    padded slots out) and each step's count of valid rows."""
    n = order.shape[0]
    n_steps = -(-n // batch)
    if n_steps == 0:
        raise ValueError("%s: order is empty (batch %d)" % (what, batch))
    pad = n_steps * batch - n
    if pad:
        order = torch.cat([order, order[-1:].expand(pad)])
    sizes = [batch] * n_steps
    sizes[-1] = batch - pad
    return order, sizes, n_steps, n


def build_train_epoch(plans, batch, loss="softmax"):
    """fn(state, dataset, targets, order, key=None) -> (new_state,
    epoch_metrics): one pass over ``order`` in ``batch``-row steps.

    Each step gathers its minibatch from the device-resident dataset
    with the ``gather_minibatch`` kernel and runs the
    :func:`build_train_step` step.  ceil(N / batch) steps run; a tail
    shorter than ``batch`` runs as one masked step (padded slots carry
    label -1 for softmax, and rows past the tail are masked out of the
    mse), so exactly N samples count.  ``targets``: int labels
    (softmax) or a float array indexed like the dataset (mse).
    ``key``: a threefry key (a pair of ints) or None; step i draws its
    dropout masks from ``fold_in(key, i)``, as the JAX epoch scan does.
    metrics: {"loss_mean", "n_err", "skipped"} (+
    "mse_sum"), device tensors; loss_mean is the sample-weighted mean."""
    from veles_tpu_torch.ops.gather import gather_labels, gather_minibatch

    step = _build_step_fn(plans, loss)

    def epoch(state, dataset, targets, order, key=None):
        order, sizes, n_steps, n = _tail_schedule(
            _as_order(order, dataset.device), batch, "build_train_epoch")
        slots = torch.arange(batch, device=dataset.device)
        losses, n_err, skipped, mse_sum = [], 0, 0, 0
        for i in range(n_steps):
            idx = order[i * batch:(i + 1) * batch]
            x = gather_minibatch(dataset, idx)
            if loss == "softmax":
                y = gather_labels(targets, idx)
                y = torch.where(slots < sizes[i], y, torch.full_like(y, -1))
            else:
                y = gather_minibatch(targets, idx)
            k = None if key is None else threefry.fold_in(key, i)
            state, m = step(state, x, y, float(sizes[i]), k)
            losses.append(m["loss"] * sizes[i])
            n_err = n_err + m["n_err"]
            skipped = skipped + m["skipped"]
            if "mse_sum" in m:
                mse_sum = mse_sum + m["mse_sum"]
        totals = {"loss_mean": torch.stack(losses).sum() / n,
                  "n_err": n_err, "skipped": skipped}
        if loss != "softmax":
            totals["mse_sum"] = mse_sum
        return state, totals

    return epoch


def build_eval_epoch(plans, batch, loss="softmax"):
    """fn(params, dataset, targets, order) -> metrics: the evaluation
    pass of :func:`build_train_epoch` (gather each minibatch, run the
    forward, dropout the identity), accumulated on the device:
    {"n_err", "samples"} for softmax, {"mse_sum", "samples"} for mse.
    A short tail runs as one masked step; ``samples`` counts the rows
    that entered the metric (valid labels for softmax)."""
    from veles_tpu_torch.ops.gather import gather_labels, gather_minibatch

    def epoch(params, dataset, targets, order):
        order, sizes, n_steps, _ = _tail_schedule(
            _as_order(order, dataset.device), batch, "build_eval_epoch")
        slots = torch.arange(batch, device=dataset.device)
        total = torch.zeros((), dtype=torch.int32 if loss == "softmax"
                            else torch.float32, device=dataset.device)
        count = torch.zeros((), dtype=torch.int32, device=dataset.device)
        with torch.no_grad():
            for i in range(n_steps):
                idx = order[i * batch:(i + 1) * batch]
                x = gather_minibatch(dataset, idx)
                out = _forward_for_loss(plans, params, x)
                slot = slots < sizes[i]
                if loss == "softmax":
                    y = gather_labels(targets, idx)
                    valid = (y >= 0) & slot
                    pred = torch.argmax(out, dim=-1)
                    total = total + torch.sum((pred != y) & valid).to(
                        torch.int32)
                    count = count + torch.sum(valid).to(torch.int32)
                else:
                    t = gather_minibatch(targets, idx)
                    diff = (out.reshape(out.shape[0], -1) -
                            t.reshape(t.shape[0], -1))
                    diff = diff * slot[:, None].to(diff.dtype)
                    total = total + torch.sum(torch.mean(diff * diff,
                                                         dim=1))
                    count = count + sizes[i]
        name = "n_err" if loss == "softmax" else "mse_sum"
        return {name: total, "samples": count}

    return epoch
