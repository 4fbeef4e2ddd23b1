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
and ``forwards[0]`` is bypassed when the workflow is fused.

After each step the unit Arrays adopt the new state tensors (a step
never updates a tensor in place, so this copies nothing), so the
forward and GD units always hold the current parameters.

The trainer counts its train steps as the JAX package's does and keys
step ``iteration`` (from 1) with ``fold_in(key(dropout_seed),
iteration)`` (``veles_tpu_torch.threefry``): one seed gives the JAX
package's dropout masks bit for bit.  The re-keying after a rollback
waits for the snapshots (ROADMAP.md Queue 1 item 5).

Not ported: the SPMD mesh and gradient bucketing / compression, the
input pipeline, the chaos points, and the profiler and telemetry
hooks.
"""

import torch

from veles_tpu_torch import threefry
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
        self.iteration = 0
        self.skip_count = 0
        self.consecutive_skips = 0
        self.last_step_finite = True
        self.grad_norm = None
        self.n_err = 0
        self.mse_sum = 0.0
        self.n_samples = 0
        self.last_loss = None

    def init_unpickled(self):
        super(FusedTrainer, self).init_unpickled()
        self._step_fn_ = None
        self._eval_metrics_ = None
        self._state_ = None
        self._has_dropout_ = False

    def initialize(self, device=None, **kwargs):
        self.device = device
        return super(FusedTrainer, self).initialize(**kwargs)

    def _compile(self):
        from veles_tpu_torch.compiler import (build_forward,
                                              build_train_step,
                                              extract_state, workflow_plan)
        from veles_tpu_torch.models.dropout import DropoutForward
        plans = workflow_plan(self.sw)
        self._has_dropout_ = any(issubclass(p.forward_cls, DropoutForward)
                                 for p in plans)
        self._step_fn_ = build_train_step(plans, loss=self.loss)
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
        self._state_ = extract_state(self.sw)

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
        x = loader.minibatch_data.device_array(self.device)
        target = (loader.minibatch_labels if self.loss == "softmax"
                  else loader.minibatch_targets).device_array(self.device)
        batch_size = float(loader.minibatch_size)
        if is_train:
            self.iteration += 1
            key = None
            if self._has_dropout_:
                key = threefry.fold_in(threefry.key(self.dropout_seed),
                                       self.iteration)
            self._state_, metrics = self._step_fn_(
                self._state_, x, target, batch_size, key)
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
            params = [{"weights": s["weights"], "bias": s["bias"]}
                      for s in self._state_]
            with torch.no_grad():
                value = self._eval_metrics_(params, x, target, batch_size)
            if self.loss == "softmax":
                self.n_err = value
            else:
                self.mse_sum = value
        self.n_samples = int(batch_size)


def fuse_standard_workflow(sw, dropout_seed=0):
    """Rewire a StandardWorkflow: loader -> FusedTrainer -> decision.

    The forward/GD units stay constructed (they own the parameter Arrays
    and create the initial weights at initialize) but leave the control
    graph."""
    trainer = FusedTrainer(sw, sw, dropout_seed=dropout_seed)
    for unit in sw.forwards + [sw.evaluator] + sw.gds:
        unit.unlink_all()
    trainer.link_from(sw.loader)
    sw.decision.link_from(trainer)
    # the decision reads its metrics and health counters from the
    # trainer now
    sw.decision.evaluator = trainer
    sw.decision.health_sources = [trainer]
    sw.repeater.link_from(sw.decision)
    sw.end_point.link_from(sw.decision)
    sw.end_point.gate_block = ~sw.decision.complete
    sw.fused_trainer = trainer
    return trainer
