"""The workflow compiler of ``veles_tpu/compiler.py``: ``LayerPlan``,
the inference forward and the fused training step and epochs.

The functions are Python over a state list of ``{"weights", "bias",
"accum_weights", "accum_bias", "accum2_weights", "accum2_bias"}`` tensor
dicts (``None`` for a leaf a layer lacks).  The walk follows the JAX
one: a softmax layer keeps its logits and the softmax (or the
cross-entropy) is applied once at the tail; dropout is the identity at
inference and in keyless steps.

The train step differentiates the loss with ``torch.autograd``.  Its
conv and max-pool layers run the port's fused backwards
(``ops/conv_vjp.py``, ``ops/pool_bwd.py``), so on the card every step
launches the ``conv_wgrad`` and ``max_pool_bwd`` kernels; the epoch
functions gather each minibatch with the ``gather_minibatch`` kernel.
A step keeps its metrics as device tensors (no ``.item()``, no host
sync), and a step whose loss or gradient norm is not finite leaves
every leaf as it was, bit for bit.

The compile step (``veles_tpu_torch/graphs.py``).  :func:`_build_step_fn`
is the raw step, the counterpart of the JAX package's unjitted step:
functional, it returns new leaf tensors.  :func:`build_train_step`
returns, by default (``donate=True``, the reference's
``donate_argnums=(0,)``), a :class:`TrainStep` that owns static state
buffers and writes each step's new state into them in place: a caller's
state that is not those buffers is copied in, and the state returned is
those buffers, valid until the step's next call.  On the card each
signature of the step (input shapes and dtypes, ``batch_size``, whether
a key or a chaos poison is given) is captured once as a CUDA graph and
replayed; the inputs are copied into static ones, the dropout key and
the poisons reach the graph through static device buffers, and the
metrics returned are copied out of the graph, so a later step leaves
them as they were.  On the CPU the same donated body runs without a
graph.  ``donate=False`` is the raw step: functional and never
captured.  The epoch functions do the same per minibatch, with the
gather inside the graph and the index slice in a static buffer.
"""

import functools

import torch

from veles_tpu_torch import threefry
from veles_tpu_torch.graphs import GraphOwner, HostScalars
from veles_tpu_torch.models.nn_units import GradientDescentBase

__all__ = ["LayerPlan", "build_forward", "build_train_step",
           "build_train_epoch", "build_eval_epoch", "workflow_plan",
           "extract_state", "adopt_state", "state_arrays", "STATE_KEYS",
           "TrainStep"]

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
    The Arrays adopt the tensors as they are, nothing is copied: a
    donated step updates them in place, so its owner calls this after
    every step (``Array.set_device_array``'s contract)."""
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


def _select_into(finite, new_state, state):
    """The donated skip-step select: ``where(finite, new, old)`` written
    into each old leaf in place (a leaf the step left as it was is
    skipped), so a skipped step leaves the old values there."""
    for entry, old in zip(new_state, state):
        for key, value in entry.items():
            held = old.get(key)
            if value is not None and held is not None and value is not held:
                torch.where(finite, value, held, out=held)
    return [dict(old) for old in state]


def _build_step_fn(plans, loss, in_place=False):
    """The raw step, fn(state, x, target, batch_size, step_key=None,
    grad_poison=None, loss_poison=None) -> (new_state, metrics): the
    counterpart of the JAX package's unjitted step.  ``in_place`` makes
    the donated body: the new state is written into ``state``'s leaves
    (:func:`_select_into`), bit for bit the values the functional step
    returns.  ``step_key`` is a pair of ints or of int64 device tensors;
    the poisons numpy scalars or device tensors."""
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
        if in_place:
            new_state = _select_into(step_finite, new_state, state)
        else:
            new_state = [GradientDescentBase.select_state(step_finite,
                                                          entry, old)
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




#: the metrics of a step, in the order a captured step packs them
_METRICS = ("loss", "n_err", "grad_norm", "finite", "skipped", "mse_sum")


def _pack(metrics):
    """One int32 word a metric (float32 bits, int32, bool as 0 or 1):
    a captured step's one metric output, copied out with one launch."""
    words = []
    for name in _METRICS:
        if name not in metrics:
            continue
        value = metrics[name].reshape(1)
        if value.dtype == torch.float32:
            value = value.view(torch.int32)
        elif value.dtype in (torch.int32, torch.bool):
            value = value.to(torch.int32)
        else:
            raise TypeError("metric %s is %s: a captured step packs "
                            "float32, int32 and bool" % (name, value.dtype))
        words.append(value)
    return torch.cat(words)


def _unpack(words, loss):
    """The metrics dict over packed words: views, no launch."""
    names = [n for n in _METRICS if n != "mse_sum" or loss != "softmax"]
    out = {}
    for i, name in enumerate(names):
        if name == "finite":
            out[name] = words[i:i + 1].view(torch.uint8)[0].view(torch.bool)
        elif name in ("n_err", "skipped"):
            out[name] = words[i]
        else:
            out[name] = words[i].view(torch.float32)
    return out


def _meta(tensor):
    """A static tensor's part of a graph's signature: the graph bakes in
    its shape, dtype and address."""
    return tuple(tensor.shape), str(tensor.dtype), tensor.data_ptr()


class _StaticState(object):
    """A donated state list: the owner's leaf tensors, rewritten in place
    by each step."""

    def __init__(self):
        self.entries = None

    def adopt(self, state):
        """Make ``state``'s values the static state's: the first state is
        cloned, a later one copied in leaf by leaf (a leaf that is the
        static one is left alone)."""
        if self.entries is None:
            self.entries = [
                {key: None if leaf is None else leaf.detach().clone(
                    memory_format=torch.contiguous_format)
                 for key, leaf in entry.items()} for entry in state]
            return
        if len(state) != len(self.entries):
            raise ValueError("state has %d layers, the donated state %d"
                             % (len(state), len(self.entries)))
        for i, (entry, held) in enumerate(zip(state, self.entries)):
            if sorted(entry) != sorted(held):
                raise ValueError("layer %d: keys %s, the donated state's %s"
                                 % (i, sorted(entry), sorted(held)))
            for key, leaf in entry.items():
                static = held[key]
                if (leaf is None) != (static is None) or (
                        leaf is not None and (
                            leaf.shape != static.shape or
                            leaf.device != static.device)):
                    raise ValueError(
                        "layer %d %s: %s, the donated state holds %s (a "
                        "step owns its state on one device)" % (
                            i, key, _describe(leaf), _describe(static)))
                if leaf is not None and leaf is not static:
                    static.copy_(leaf)

    def leaves(self):
        return [leaf for entry in self.entries for leaf in entry.values()
                if leaf is not None]

    def unflatten(self, leaves):
        leaves = iter(leaves)
        return [{key: None if leaf is None else next(leaves)
                 for key, leaf in entry.items()} for entry in self.entries]

    def copy(self):
        return [dict(entry) for entry in self.entries]


def _describe(leaf):
    return None if leaf is None else (tuple(leaf.shape), str(leaf.device))


class _Captured(object):
    """What the donated step and the epochs share: the static state,
    inputs and host scalars, and the graph owner (None on the CPU, where
    the bodies run as they are)."""

    def __init__(self, name, graphs=None):
        self.name = name
        self.graphs = graphs
        self.state = _StaticState()
        self._inputs = {}
        self._scalars = {}

    def _owner(self, device):
        if self.graphs is None and device.type == "cuda":
            self.graphs = GraphOwner(self.name, device)
        return self.graphs

    def bind_inputs(self, **tensors):
        """Make each tensor the static input of its role (``x``,
        ``target``) at its shape and dtype: its producer refills it in
        stream order before each call (the loader's gather writes there
        with ``out=``), and a call that passes it copies nothing.
        Another tensor of that shape is copied into it."""
        for role, tensor in tensors.items():
            self._inputs[(role, tuple(tensor.shape), tensor.dtype)] = tensor

    def _input(self, role, tensor):
        key = (role, tuple(tensor.shape), tensor.dtype)
        static = self._inputs.get(key)
        if static is None:
            static = self._inputs[key] = torch.empty(
                tensor.shape, dtype=tensor.dtype, device=tensor.device)
        if static is not tensor:
            static.copy_(tensor)
        return static

    def _host_scalars(self, name, values, dtype, device):
        held = self._scalars.get(name)
        if held is None:
            held = self._scalars[name] = HostScalars(
                tuple(torch.as_tensor(values).shape), dtype, device)
        return held.write(values)


class TrainStep(_Captured):
    """The donated train step of :func:`build_train_step`:
    fn(state, x, target, batch_size, step_key=None, grad_poison=None,
    loss_poison=None) -> (state, metrics).

    The returned state is the step's static buffers (valid until its
    next call); the metrics are the step's own.  On the card each
    signature is captured once (``graphs``, a
    :class:`~veles_tpu_torch.graphs.GraphOwner` the caller may share,
    made on the first call if None) and replayed; ``step_key`` is a pair
    of ints there.  :meth:`evaluate` runs an evaluation body over the
    same static parameters and inputs."""

    def __init__(self, plans, loss="softmax", graphs=None):
        super(TrainStep, self).__init__("train step", graphs)
        self.plans = plans
        self.loss = loss
        self._body = _build_step_fn(plans, loss, in_place=True)

    def own_state(self, state):
        """Adopt ``state`` as the static state; returns it."""
        self.state.adopt(state)
        return self.state.copy()

    def __call__(self, state, x, target, batch_size, step_key=None,
                 grad_poison=None, loss_poison=None):
        self.state.adopt(state)
        graphs = self._owner(x.device)
        if graphs is None:
            _, metrics = self._body(self.state.entries, x, target,
                                    batch_size, step_key, grad_poison,
                                    loss_poison)
            return self.state.copy(), metrics
        batch_size = float(batch_size)
        inputs = [self._input("x", x), self._input("target", target)]
        if step_key is not None:
            inputs.append(self._host_scalars(
                "key", [int(w) for w in step_key], torch.int64, x.device))
        poisons = (grad_poison is not None, loss_poison is not None)
        for name, value in zip(("grad_poison", "loss_poison"),
                               (grad_poison, loss_poison)):
            if value is not None:
                inputs.append(self._host_scalars(name, float(value),
                                                 torch.float32, x.device))
        signature = ("step", tuple(_meta(t) for t in inputs), batch_size,
                     step_key is not None) + poisons
        graph = graphs.graph(
            signature, self._graph_body(batch_size, step_key is not None,
                                        *poisons),
            self.state.leaves() + inputs)
        packed, = graph.replay()
        return self.state.copy(), _unpack(packed.clone(), self.loss)

    def _graph_body(self, batch_size, keyed, grad_poisoned, loss_poisoned):
        n = len(self.state.leaves())

        def body(*args):
            x, target, *rest = args[n:]
            key = grad_poison = loss_poison = None
            if keyed:
                words = rest.pop(0)
                key = (words[0], words[1])
            if grad_poisoned:
                grad_poison = rest.pop(0)
            if loss_poisoned:
                loss_poison = rest.pop(0)
            _, metrics = self._body(self.state.unflatten(args[:n]), x,
                                    target, batch_size, key, grad_poison,
                                    loss_poison)
            return (_pack(metrics),)
        return body

    def evaluate(self, fn, state, x, target, batch_size):
        """``fn(params, x, target, batch_size)`` -> a tensor, over the
        static parameters (``state`` adopted first), captured on the
        card; returns a copy that later calls leave alone."""
        self.state.adopt(state)
        params = [{"weights": e["weights"], "bias": e["bias"]}
                  for e in self.state.entries]
        graphs = self._owner(x.device)
        if graphs is None:
            with torch.no_grad():
                return fn(params, x, target, batch_size)
        batch_size = float(batch_size)
        inputs = [self._input("x", x), self._input("target", target)]

        def body(x, target):
            with torch.no_grad():
                return (fn(params, x, target, batch_size),)

        signature = ("eval", fn, tuple(_meta(t) for t in inputs),
                     batch_size)
        out, = graphs.graph(signature, body, inputs).replay()
        return out.clone()


def build_train_step(plans, loss="softmax", mesh=None, grad_bucket_mb=None,
                     grad_compress=None, bwd_schedule=None, bwd_remat=False,
                     zero=None, donate=True, graphs=None):
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

    ``donate=True`` (the default, as in the reference) returns a
    :class:`TrainStep`: the state returned is the step's own buffers,
    updated in place by its next call, and on the card each signature
    runs as a captured CUDA graph (``graphs``: a shared
    :class:`~veles_tpu_torch.graphs.GraphOwner`, or None for one of its
    own).  ``donate=False`` returns the raw functional step, never
    captured.

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
    if not donate:
        return _build_step_fn(plans, loss)
    return TrainStep(plans, loss, graphs)


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


def _train_minibatch(loss, dataset, targets, idx, size):
    """An epoch step's gathered minibatch: rows past ``size`` carry label
    -1 (softmax); the mse masks them in the loss."""
    from veles_tpu_torch.ops.gather import gather_labels, gather_minibatch
    x = gather_minibatch(dataset, idx)
    if loss != "softmax":
        return x, gather_minibatch(targets, idx)
    y = gather_labels(targets, idx)
    slots = torch.arange(idx.shape[0], device=idx.device)
    return x, torch.where(slots < size, y, torch.full_like(y, -1))


class _TrainEpoch(_Captured):
    """:func:`build_train_epoch`'s function."""

    def __init__(self, plans, batch, loss, donate, graphs):
        super(_TrainEpoch, self).__init__("train epoch", graphs)
        self.batch = batch
        self.loss = loss
        self.donate = donate
        self._step = _build_step_fn(plans, loss, in_place=donate)

    def __call__(self, state, dataset, targets, order, key=None):
        order, sizes, n_steps, n = _tail_schedule(
            _as_order(order, dataset.device), self.batch,
            "build_train_epoch")
        graphs = None
        if self.donate:
            self.state.adopt(state)
            state = self.state.copy()
            graphs = self._owner(dataset.device)
        losses, n_err, skipped, mse_sum = [], 0, 0, 0
        for i in range(n_steps):
            idx = order[i * self.batch:(i + 1) * self.batch]
            k = None if key is None else threefry.fold_in(key, i)
            if graphs is None:
                x, y = _train_minibatch(self.loss, dataset, targets, idx,
                                        sizes[i])
                state, m = self._step(state, x, y, float(sizes[i]), k)
            else:
                m = self._replay(graphs, dataset, targets, idx, sizes[i], k)
            # read before the next replay rewrites the graph's outputs
            losses.append(m["loss"] * sizes[i])
            n_err = n_err + m["n_err"]
            skipped = skipped + m["skipped"]
            if "mse_sum" in m:
                mse_sum = mse_sum + m["mse_sum"]
        totals = {"loss_mean": torch.stack(losses).sum() / n,
                  "n_err": n_err, "skipped": skipped}
        if self.loss != "softmax":
            totals["mse_sum"] = mse_sum
        return state, totals

    def _replay(self, graphs, dataset, targets, idx, size, key):
        inputs = [self._input("idx", idx)]
        if key is not None:
            inputs.append(self._host_scalars("key", list(key), torch.int64,
                                             dataset.device))
        signature = ("epoch step", _meta(dataset), _meta(targets),
                     tuple(_meta(t) for t in inputs), size, key is not None)
        n = len(self.state.leaves())

        def body(*args):
            x, y = _train_minibatch(self.loss, dataset, targets, args[n],
                                    size)
            step_key = None
            if key is not None:
                step_key = (args[n + 1][0], args[n + 1][1])
            _, m = self._step(self.state.unflatten(args[:n]), x, y,
                              float(size), step_key)
            return (_pack(m),)

        packed, = graphs.graph(signature, body,
                               self.state.leaves() + inputs).replay()
        return _unpack(packed, self.loss)


def build_train_epoch(plans, batch, loss="softmax", donate=True,
                      graphs=None):
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
    "mse_sum"), device tensors; loss_mean is the sample-weighted mean.

    ``donate`` as in :func:`build_train_step`: the state returned is the
    function's own buffers, and on the card each step is one replay of
    a captured graph that gathers the minibatch (its index slice copied
    into a static buffer) and runs the step.  The dataset and targets
    are the graph's by address: another dataset captures another graph.
    ``donate=False`` runs the raw step, functional and uncaptured."""
    return _TrainEpoch(plans, batch, loss, donate, graphs)


def _eval_counts(plans, loss, params, dataset, targets, idx, size):
    """One evaluation minibatch: (errors, valid rows) for softmax,
    (squared-error sum, rows) for mse."""
    from veles_tpu_torch.ops.gather import gather_labels, gather_minibatch
    x = gather_minibatch(dataset, idx)
    out = _forward_for_loss(plans, params, x)
    slot = torch.arange(idx.shape[0], device=idx.device) < size
    if loss == "softmax":
        y = gather_labels(targets, idx)
        valid = (y >= 0) & slot
        pred = torch.argmax(out, dim=-1)
        return (torch.sum((pred != y) & valid).to(torch.int32),
                torch.sum(valid).to(torch.int32))
    t = gather_minibatch(targets, idx)
    diff = (out.reshape(out.shape[0], -1) - t.reshape(t.shape[0], -1))
    diff = diff * slot[:, None].to(diff.dtype)
    return torch.sum(torch.mean(diff * diff, dim=1)), size


class _EvalEpoch(_Captured):
    """:func:`build_eval_epoch`'s function."""

    def __init__(self, plans, batch, loss, graphs):
        super(_EvalEpoch, self).__init__("eval epoch", graphs)
        self.plans = plans
        self.batch = batch
        self.loss = loss
        self._sums = None

    def __call__(self, params, dataset, targets, order):
        order, sizes, n_steps, _ = _tail_schedule(
            _as_order(order, dataset.device), self.batch,
            "build_eval_epoch")
        graphs = self._owner(dataset.device)
        dtype = torch.int32 if self.loss == "softmax" else torch.float32
        if graphs is None:
            total = torch.zeros((), dtype=dtype, device=dataset.device)
            count = torch.zeros((), dtype=torch.int32, device=dataset.device)
        else:
            # the graphs add into static sums, zeroed here
            if self._sums is None:
                self._sums = (
                    torch.zeros((), dtype=dtype, device=dataset.device),
                    torch.zeros((), dtype=torch.int32,
                                device=dataset.device))
            total, count = self._sums
            total.zero_()
            count.zero_()
        with torch.no_grad():
            for i in range(n_steps):
                idx = order[i * self.batch:(i + 1) * self.batch]
                if graphs is None:
                    errors, rows = _eval_counts(self.plans, self.loss,
                                                params, dataset, targets,
                                                idx, sizes[i])
                    total = total + errors
                    count = count + rows
                else:
                    self._replay(graphs, params, dataset, targets, idx,
                                 sizes[i])
        if graphs is not None:
            total, count = total.clone(), count.clone()
        name = "n_err" if self.loss == "softmax" else "mse_sum"
        return {name: total, "samples": count}

    def _replay(self, graphs, params, dataset, targets, idx, size):
        inputs = [self._input("idx", idx)]
        leaves = [e[key] for e in params for key in ("weights", "bias")
                  if e.get(key) is not None]
        # the parameters are the graph's by address, like the dataset
        signature = ("eval step", _meta(dataset), _meta(targets),
                     _meta(inputs[0]), size,
                     tuple(_meta(leaf) for leaf in leaves))

        def body(idx, total, count):
            errors, rows = _eval_counts(self.plans, self.loss, params,
                                        dataset, targets, idx, size)
            total.add_(errors)
            count.add_(rows)
            return ()

        graphs.graph(signature, body, inputs + list(self._sums)).replay()


def build_eval_epoch(plans, batch, loss="softmax", graphs=None):
    """fn(params, dataset, targets, order) -> metrics: the evaluation
    pass of :func:`build_train_epoch` (gather each minibatch, run the
    forward, dropout the identity), accumulated on the device:
    {"n_err", "samples"} for softmax, {"mse_sum", "samples"} for mse.
    A short tail runs as one masked step; ``samples`` counts the rows
    that entered the metric (valid labels for softmax).  On the card
    each minibatch is one replay of a captured graph (``graphs``, a
    shared owner, or None for one of its own) that gathers it and adds
    into static sums; the dataset, targets and ``params`` are the
    graph's by address."""
    return _EvalEpoch(plans, batch, loss, graphs)
