"""FusedTrainer — the forward, loss, backward and update of a standard
workflow as one train step per minibatch.

Counterpart of ``veles_tpu/models/fused.py``.  The unit graph keeps
orchestrating (the loader serves minibatches, the decision stops
training), but between loader and decision one FusedTrainer replaces the
forwards, the evaluator and the GD units, and runs
``compiler.build_train_step`` (autograd through the layers' ``apply``,
the solver update and the skip-step guard) on each train minibatch and
``compiler.build_forward`` plus the error count on each evaluation
minibatch.  The metrics it exposes (``n_err`` / ``mse_sum``) are device
tensors with the evaluator's meaning, so the decision unit works
unchanged and reads them once per finished class.

The trainer reads ``loader.minibatch_data`` (and the labels or targets)
directly, as the JAX package's does: a unit wired between the loader
and ``forwards[0]`` is bypassed when the workflow is fused.  With
``pipeline=True`` (the auto-fused default, ``root.common.engine.
pipeline_input``) a standalone run starts a
:class:`~veles_tpu_torch.pipeline_input.Prefetcher` at initialize, which
serves ``pipeline_depth`` minibatches ahead on its worker, and each
step reads the minibatch the Prefetcher hands it (``current``); the
step copies it into its static input (one device-to-device copy), the
loader's slots being rewritten while the step runs.

The train step is donated (``compiler.TrainStep``): it owns the state
buffers and rewrites them in place, and after each step the unit Arrays
adopt them again (``Array.set_device_array``; nothing is copied), so the
forward and GD units always hold the current parameters and a host read
copies the current values.  On the card the train and evaluation steps
are captured CUDA graphs (``veles_tpu_torch/graphs.py``), one per
signature, in one memory pool: the loader's device minibatch buffers
are their static inputs (``FullBatchLoader.static_minibatch``), and the
metrics each step hands over (``n_err``, ``grad_norm``, ``finite``,
``skipped``, ``mse_sum``, ``last_loss``) are copies that later replays
leave alone.  :attr:`FusedTrainer.compile_receipt` counts captures,
replays and eager steps.  A divergence rollback re-captures (the
learning rates change).  Under ``VELES_DEBUG_NONFINITE`` the kernels'
guard syncs the host, which a capture cannot hold: the trainer then
runs the raw step eagerly, logs it once and counts each such run in
the receipt's ``eager_steps``.

The trainer counts its train steps as the JAX package's does and keys
step ``iteration`` (from 1) with ``fold_in(key(dropout_base_key),
iteration)`` (``veles_tpu_torch.threefry``), where ``dropout_base_key``
is ``dropout_seed`` until a divergence rollback re-keys it
(:meth:`FusedTrainer.reset_after_rollback`): one seed gives the JAX
package's dropout masks bit for bit, before and after a rollback.

The chaos points ``step.grad`` and ``step.loss``
(``veles_tpu_torch.chaos``) fire once per train step, into the step's
``grad_poison`` / ``loss_poison`` arguments.  A snapshot pickles the
trainer without its step, state or plans (the unit Arrays hold the
parameters) and with its metrics as Python numbers.

Not ported: the SPMD mesh and gradient bucketing / compression
(ROADMAP.md Queue 1 item 8) and the profiler and telemetry hooks (item
11).
"""

import numpy
import torch

from veles_tpu_torch import chaos, threefry
from veles_tpu_torch.graphs import GraphOwner
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.units import Unit

__all__ = ["FusedTrainer", "fuse_standard_workflow"]


class FusedTrainer(Unit):
    """Runs compiler.build_train_step over a StandardWorkflow's layers;
    exposes evaluator-compatible metrics (n_err / mse_sum)."""

    def __init__(self, workflow, sw, **kwargs):
        super(FusedTrainer, self).__init__(workflow, **kwargs)
        self.sw = sw
        self.loss = sw.loss
        self.device = None
        self.dropout_seed = kwargs.get("dropout_seed", 0)
        self.dropout_base_key = self.dropout_seed
        self.iteration = 0
        self.skip_count = 0
        self.consecutive_skips = 0
        self.last_step_finite = True
        self.grad_norm = None
        self.n_err = 0
        self.mse_sum = 0.0
        self.n_samples = 0
        self.last_loss = None
        #: the input pipeline: serve minibatch k+1 while step k runs
        self.pipeline = kwargs.get("pipeline", False)
        self.pipeline_depth = kwargs.get("pipeline_depth", 1)

    def init_unpickled(self):
        super(FusedTrainer, self).init_unpickled()
        self._prefetcher_ = None
        self._step_fn_ = None
        self._raw_step_ = None
        self._eval_metrics_ = None
        self._state_ = None
        self._has_dropout_ = False
        self._graphs_ = None

    def initialize(self, device=None, **kwargs):
        self.device = device
        if (self.pipeline and self._prefetcher_ is None
                and device is not None
                and self.sw.workflow_mode == "standalone"):
            from veles_tpu_torch.pipeline_input import Prefetcher
            self._prefetcher_ = Prefetcher(
                self.sw.loader, device, depth=self.pipeline_depth).attach()
        return super(FusedTrainer, self).initialize(**kwargs)

    @property
    def prefetcher(self):
        """The input pipeline's Prefetcher, None when it is off."""
        return self._prefetcher_

    def _compile(self):
        from veles_tpu_torch.compiler import (build_forward,
                                              build_train_step,
                                              extract_state, workflow_plan)
        from veles_tpu_torch.models.dropout import DropoutForward
        plans = workflow_plan(self.sw)
        self._has_dropout_ = any(issubclass(p.forward_cls, DropoutForward)
                                 for p in plans)
        state = extract_state(self.sw)
        leaf = next(t for entry in state for t in entry.values()
                    if t is not None)
        if self._graphs_ is not None:
            self._graphs_.clear()
        elif leaf.device.type == "cuda":
            self._graphs_ = GraphOwner("fused trainer", leaf.device)
        self._step_fn_ = build_train_step(plans, loss=self.loss,
                                          graphs=self._graphs_)
        self._raw_step_ = build_train_step(plans, loss=self.loss,
                                           donate=False)
        forward = build_forward(plans)

        if self.loss == "softmax":
            def eval_metrics(params, x, labels, batch_size):
                out = forward(params, x)
                valid = labels >= 0
                pred = torch.argmax(out, dim=-1)
                return ((pred != labels) & valid).sum()
        else:
            def eval_metrics(params, x, target, batch_size):
                out = forward(params, x)
                diff = (out.reshape(out.shape[0], -1) -
                        target.reshape(target.shape[0], -1))
                mask = torch.arange(out.shape[0],
                                    device=out.device) < batch_size
                return torch.sum(torch.mean(diff * diff, dim=1) * mask)
        self._eval_metrics_ = eval_metrics
        self._state_ = self._step_fn_.own_state(state)

    @property
    def compile_receipt(self):
        """The graphs' receipt (``graphs.GraphOwner.receipt``), None
        before the first step on the card and on the CPU."""
        return None if self._graphs_ is None else self._graphs_.receipt

    def _eager(self, what):
        """True when this run must skip the graphs: the card under
        ``VELES_DEBUG_NONFINITE``.  Logs the first such run and counts
        each."""
        from veles_tpu_torch.ops import common
        if self._graphs_ is None or not common.DEBUG_NONFINITE:
            return False
        receipt = self._graphs_.receipt
        if not receipt["eager_steps"]:
            self.warning("VELES_DEBUG_NONFINITE: the kernels' guard syncs "
                         "the host, which a CUDA graph cannot hold; the "
                         "%s step and every step while it is on run "
                         "eagerly (counted in compile_receipt)", what)
        receipt["eager_steps"] += 1
        return True

    def sync(self):
        """Hand the fused state to the unit Arrays."""
        from veles_tpu_torch.compiler import adopt_state
        if self._state_ is not None:
            adopt_state(self.sw, self._state_, self.device)

    def run(self):
        if self._step_fn_ is None:
            self._compile()
        loader = self.sw.loader
        is_train = loader.minibatch_class == TRAIN
        prefetched = (self._prefetcher_.current
                      if self._prefetcher_ is not None else None)
        if prefetched is not None:
            x = prefetched.data
            target = (prefetched.labels if self.loss == "softmax"
                      else prefetched.targets)
        else:
            x = loader.minibatch_data.device_array(self.device)
            target = (loader.minibatch_labels if self.loss == "softmax"
                      else loader.minibatch_targets).device_array(
                          self.device)
        batch_size = float(loader.minibatch_size)
        if getattr(loader, "static_minibatch", False):
            self._step_fn_.bind_inputs(x=x, target=target)
        if is_train:
            self.iteration += 1
            key = None
            if self._has_dropout_:
                key = threefry.fold_in(threefry.key(self.dropout_base_key),
                                       self.iteration)
            poisons = {}
            if chaos.plan is not None:
                for point, kwarg in (("step.grad", "grad_poison"),
                                     ("step.loss", "loss_poison")):
                    fault = chaos.plan.fire(point)
                    if fault is not None:
                        poisons[kwarg] = numpy.float32(
                            numpy.nan if fault.param is None
                            else fault.param)
            step = self._raw_step_ if self._eager("train") \
                else self._step_fn_
            self._state_, metrics = step(self._state_, x, target,
                                         batch_size, key, **poisons)
            self.sync()
            self.last_loss = metrics["loss"]
            self.n_err = metrics["n_err"]
            self.grad_norm = metrics["grad_norm"]
            self.last_step_finite = metrics["finite"]
            skipped = metrics["skipped"]
            self.skip_count = self.skip_count + skipped
            self.consecutive_skips = \
                (self.consecutive_skips + skipped) * skipped
            if "mse_sum" in metrics:
                self.mse_sum = metrics["mse_sum"]
        else:
            value = self._evaluate(x, target, batch_size)
            if self.loss == "softmax":
                self.n_err = value
            else:
                self.mse_sum = value
        self.n_samples = int(batch_size)

    def _evaluate(self, x, target, batch_size):
        if not self._eager("evaluation"):
            return self._step_fn_.evaluate(self._eval_metrics_,
                                           self._state_, x, target,
                                           batch_size)
        params = [{"weights": s["weights"], "bias": s["bias"]}
                  for s in self._state_]
        with torch.no_grad():
            return self._eval_metrics_(params, x, target, batch_size)

    def reset_health_counters(self):
        """Zero the skip accounting (after a rollback, so the next
        epoch's check starts clean)."""
        self.skip_count = 0
        self.consecutive_skips = 0
        self.last_step_finite = True

    def reset_after_rollback(self, rollbacks):
        """Post-rollback reset: drop the step (its graphs too) and the
        device state, so the next run re-reads the restored unit Arrays
        and captures the backed-off GD hyperparameters anew, and re-key
        the dropout stream as
        the JAX package does (replaying the noise that accompanied a
        divergence would waste a retry of the bounded budget)."""
        self._step_fn_ = None
        self._raw_step_ = None
        self._state_ = None
        self._eval_metrics_ = None
        # deterministic but distinct per rollback (a golden-ratio
        # increment keeps the streams apart for small seeds)
        self.dropout_base_key = (
            self.dropout_seed + rollbacks * 0x9E3779B1) & 0x7FFFFFFF
        self.reset_health_counters()

    def __getstate__(self):
        # the parameters live in the unit Arrays for snapshots; device
        # metrics become Python numbers
        self.sync()
        state = super(FusedTrainer, self).__getstate__()
        state["n_err"] = int(self.n_err)
        state["mse_sum"] = float(self.mse_sum)
        if self.last_loss is not None:
            state["last_loss"] = float(self.last_loss)
        state["skip_count"] = int(self.skip_count)
        state["consecutive_skips"] = int(self.consecutive_skips)
        state["last_step_finite"] = bool(self.last_step_finite)
        state["grad_norm"] = (None if self.grad_norm is None
                              else float(self.grad_norm))
        # the JAX package's names and its unported options at their
        # defaults, so the snapshot trains on there too
        state.update({
            "_iteration": self.iteration,
            "_dropout_seed": self.dropout_seed,
            "_dropout_base_key": self.dropout_base_key,
            "_step_fn": None, "_state": None, "_eval_metrics": None,
            "_plans": None, "_prefetcher": None, "_spmd_axes_": None,
            "mesh": None, "data_axis": "data", "grad_bucket_mb": None,
            "grad_compress": None})
        return state

    def __setstate__(self, state):
        # the JAX package's names for the step counter and the keys
        for jax_name, name in (("_iteration", "iteration"),
                               ("_dropout_seed", "dropout_seed"),
                               ("_dropout_base_key", "dropout_base_key")):
            if jax_name in state:
                state[name] = state.pop(jax_name)
        state.setdefault("dropout_base_key", state.get("dropout_seed", 0))
        state.setdefault("pipeline", False)
        state.setdefault("pipeline_depth", 1)
        super(FusedTrainer, self).__setstate__(state)


def fuse_standard_workflow(sw, dropout_seed=0, pipeline=False,
                           pipeline_depth=1):
    """Rewire a StandardWorkflow: loader -> FusedTrainer -> decision.

    The forward/GD units stay constructed (they own the parameter Arrays
    and create the initial weights at initialize) but leave the control
    graph.  ``pipeline=True`` serves minibatch k+1 (the gather or the
    host fill and its upload) on the input pipeline's worker while step
    k runs (``pipeline_input.Prefetcher``), in a standalone run."""
    trainer = FusedTrainer(sw, sw, dropout_seed=dropout_seed,
                           pipeline=pipeline, pipeline_depth=pipeline_depth)
    for unit in sw.forwards + [sw.evaluator] + sw.gds:
        unit.unlink_all()
    trainer.link_from(sw.loader)
    sw.decision.link_from(trainer)
    # the decision reads its metrics and health counters from the
    # trainer now
    sw.decision.evaluator = trainer
    sw.decision.health_sources = [trainer]
    snapshotter = getattr(sw, "snapshotter", None)
    if snapshotter is not None:
        # the fused step is atomic, so the state after the decision is
        # already quiescent: decision -> snapshotter -> repeater, once
        # per improved epoch
        snapshotter.unlink_all()
        snapshotter.link_from(sw.decision)
        sw.repeater.link_from(snapshotter)
        sw.end_point.link_from(snapshotter)
        snapshotter.gate_skip = ~(sw.decision.improved &
                                  sw.loader.epoch_ended)
    else:
        sw.repeater.link_from(sw.decision)
    sw.end_point.link_from(sw.decision)
    sw.end_point.gate_block = ~sw.decision.complete
    sw.fused_trainer = trainer
    return trainer
