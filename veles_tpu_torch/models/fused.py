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
unchanged and reads them once per finished class.  With plotters linked
(``StandardWorkflow.link_plotters``) each evaluation step also hands
over its confusion matrix, and the trainer keeps the matrix of the
epoch's validation minibatches in the evaluator's ``confusion_matrix``
(the JAX package's fused path leaves it empty).

On the host pseudo-device (``NumpyDevice``, fused only when asked for:
auto-fuse takes the card) the trainer runs its step on the CPU: it
reads the state and the minibatch as CPU copies of the host buffers
and hands the new state back into them (``Array.set_host``), so the
Arrays stay host-only.  The input pipeline stays off there, as in the
JAX package.

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

The SPMD data plane (``mesh``, ``data_axis``, ``grad_bucket_mb``,
``grad_compress``; ``veles_tpu_torch/parallel/``): with a mesh, every
rank runs the same workflow (the same seeds, so the same minibatches),
and each train step takes this rank's rows of the minibatch
(``parallel.api.shard_batch``) through ``compiler.build_train_step``'s
bucketed all-reduce (``grad_bucket_mb``, default ~25 MB).  The state is
rank 0's, broadcast at compile (``parallel.api.replicate``); an
evaluation minibatch runs whole on every rank (no collective: the
parameters are the same everywhere).  The input pipeline is off with a
mesh, as in the reference.  The first clean step after a compile
publishes the comm receipt (``comm.*`` gauges, :attr:`comm_receipt`,
one log line).  A skipped step under ``grad_compress="bf16"`` falls
back to the f32 all-reduce at the decision's next health sync
(:meth:`FusedTrainer.on_health_sync`).  A snapshot pickles the mesh's
axes (``_spmd_axes_``), and initialize rebuilds the mesh over the
world it finds (a one-axis mesh re-spans it; a multi-axis one that no
longer fits raises).  The NCCL step is captured like the one-device
step; gloo's collectives cannot be captured, so a gloo world's fused
trainer runs on the CPU.

Telemetry (``veles_tpu_torch/observe``), as in the JAX package: the
``train.steps`` / ``train.samples`` counters, the ``step.train_s`` /
``step.eval_s`` histograms, :func:`~veles_tpu_torch.observe.profile.
profiler_step` after each train step, the ``fused.train_step`` /
``fused.eval_step`` spans (host time) while the tracer or the flight
ring is on (while the tracer or a ``torch.profiler`` records, the
train step's span is open around its children: ``fused.replay``, the
step's enqueue, and ``fused.adopt``, the state's hand-over to the unit
Arrays; its ``seq`` is the iteration), the graph owner watched for
recapture storms (``observe.introspect.watch``, its "step" and "eval" signatures), and
at the first train step the analytic FLOPs of a step and of its forward
(``compiler.step_flops``) published for the live MFU.  On the card a
step's time is not the host's: a replay returns in microseconds and the
host runs ahead until the decision's class-end sync, so the trainer
records a CUDA event on the step's stream after each step, and a step's
time is the interval between the end events of two consecutive steps of
one class (:class:`StepClock`; a step that captured and the first of a
class are not counted).  In steady state that is the wall time per step
whoever sets the pace, and never less than the card's own.  The events
are resolved by ``query()`` at later steps, never by a synchronization,
from a bounded ring.  On the CPU a step's time is the host's wall time
around it, as in the JAX package.
"""

import collections
import time

import numpy
import torch

from veles_tpu_torch import chaos, threefry
from veles_tpu_torch.graphs import GraphOwner
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.models.nn_units import adopt, operand
from veles_tpu_torch.observe import introspect
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.profile import profiler_step
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.units import Unit

__all__ = ["FusedTrainer", "fuse_standard_workflow", "StepClock"]


class StepClock(object):
    """Step times on the card from CUDA events, resolved off the step
    path.  :meth:`mark` records an event on the current stream after a
    step; the interval from the previous step's event to this one is
    that step's time when both steps are of one class and this one did
    not capture.  Intervals wait in a ring of ``capacity`` (the oldest
    is dropped, and counted in ``dropped``, when the host runs that far
    ahead) until :meth:`poll` finds their end event complete
    (``query()``, which never blocks) and observes them."""

    def __init__(self, device, capacity=64, record=None):
        self.device = device
        self.capacity = capacity
        self.dropped = 0
        #: records and returns an event (``query()``, ``elapsed_time``)
        self.record = record or self._record
        self._pending = collections.deque()
        self._last = None

    def _record(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def mark(self, kind, histogram, counted=True):
        event = self.record()
        last, self._last = self._last, (kind, event)
        if counted and last is not None and last[0] == kind:
            if len(self._pending) >= self.capacity:
                self._pending.popleft()
                self.dropped += 1
            self._pending.append((last[1], event, histogram))
        self.poll()

    def poll(self):
        """Observe every pending interval whose end has completed, in
        order; returns how many it observed."""
        done = 0
        pending = self._pending
        while pending and pending[0][1].query():
            start, end, histogram = pending.popleft()
            histogram.observe(start.elapsed_time(end) / 1e3)
            done += 1
        return done

    def reset(self):
        """Forget the last step: the next one starts a new interval."""
        self._last = None


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
        #: the SPMD data plane: a parallel.mesh DeviceMesh, or None
        self.mesh = kwargs.get("mesh")
        self.data_axis = kwargs.get("data_axis", "data")
        self.grad_bucket_mb = kwargs.get("grad_bucket_mb")
        #: "bf16" halves the gradient wire bytes; falls back to f32 after
        #: a skipped step (on_health_sync)
        self.grad_compress = kwargs.get("grad_compress")

    def init_unpickled(self):
        super(FusedTrainer, self).init_unpickled()
        self._prefetcher_ = None
        self._step_fn_ = None
        self._raw_step_ = None
        self._eval_metrics_ = None
        self._state_ = None
        self._has_dropout_ = False
        self._graphs_ = None
        #: the comm receipt (SPMD): published once, at the first clean
        #: step after a compile
        self.comm_receipt = None
        self._comm_published_ = False
        self._compiled_at_iter_ = 0
        #: skips already seen at the last health sync
        self._compress_skips_seen_ = 0
        # telemetry handles (transient, made again after unpickling)
        self._m_train_step_ = _registry.histogram("step.train_s")
        self._m_eval_step_ = _registry.histogram("step.eval_s")
        self._m_steps_ = _registry.counter("train.steps")
        self._m_samples_ = _registry.counter("train.samples")
        #: the FLOPs of one train step (None until the first train step;
        #: 0.0 when they could not be counted)
        self._step_flops_ = None
        self._plans_ = None
        self._clock_ = None
        #: the validation confusion matrix of the current epoch, kept
        #: when the workflow has plotters linked (link_plotters)
        self._confusion_ = False
        self._confusion_acc_ = None
        self._confusion_epoch_ = None

    def _restore_mesh(self):
        """Rebuild the mesh after unpickling from its axes: the same
        shape where the world still fits it; a one-axis mesh re-spans
        the world; a multi-axis shape that no longer fits raises."""
        axes = getattr(self, "_spmd_axes_", None)
        if not axes or self.mesh is not None:
            return
        from veles_tpu_torch.parallel import auto_mesh, make_mesh
        device = self.device.torch_device
        try:
            self.mesh = make_mesh(dict(axes), device)
        except ValueError as exc:
            if len(axes) != 1:
                raise ValueError(
                    "cannot rebuild the resumed SPMD mesh %s on this world: "
                    "%s — re-fuse with an explicit mesh" % (dict(axes), exc))
            self.mesh = auto_mesh(next(iter(axes)), device)
            self.warning("resumed SPMD mesh %s does not fit this world (%s); "
                         "re-spanning the data axis", dict(axes), exc)

    def initialize(self, device=None, **kwargs):
        self.device = device
        self._restore_mesh()
        if (self.pipeline and self._prefetcher_ is None
                and self.mesh is None and device is not None
                and device.exists
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
        self._plans_ = plans
        self._has_dropout_ = any(issubclass(p.forward_cls, DropoutForward)
                                 for p in plans)
        state = extract_state(self.sw)
        leaf = next(t for entry in state for t in entry.values()
                    if t is not None)
        if self._graphs_ is not None:
            self._graphs_.clear()
        elif leaf.device.type == "cuda":
            self._graphs_ = GraphOwner("fused trainer", leaf.device)
            self._clock_ = StepClock(leaf.device)
        # each should settle on a handful of signatures: growth past
        # that is the recapture storm the watcher warns about
        introspect.watch(self._graphs_, "fused.step", kind="step")
        introspect.watch(self._graphs_, "fused.eval", kind="eval")
        if self._clock_ is not None:
            self._clock_.reset()
        meshed = {}
        if self.mesh is not None:
            from veles_tpu_torch.parallel.api import replicate
            from veles_tpu_torch.parallel.bucketed import DEFAULT_BUCKET_MB
            meshed = dict(mesh=self.mesh, data_axis=self.data_axis,
                          grad_bucket_mb=(self.grad_bucket_mb
                                          if self.grad_bucket_mb is not None
                                          else DEFAULT_BUCKET_MB),
                          grad_compress=self.grad_compress)
            # rank 0's state on every rank
            state = replicate(self.mesh, state)
        self._compiled_at_iter_ = self.iteration
        self._step_fn_ = build_train_step(plans, loss=self.loss,
                                          graphs=self._graphs_, **meshed)
        self._raw_step_ = build_train_step(plans, loss=self.loss,
                                           donate=False, **meshed)
        forward = build_forward(plans)
        # the evaluator leaves the graph when fused: with plotters
        # linked, the evaluation step also hands over its confusion
        # matrix (row truth, column prediction) after the error count
        confusion = self._confusion_ = (
            self.loss == "softmax" and bool(getattr(self.sw, "plotters", ()))
            and hasattr(self.sw.evaluator, "confusion_matrix"))

        if self.loss == "softmax":
            def eval_metrics(params, x, labels, batch_size):
                out = forward(params, x)
                valid = labels >= 0
                pred = torch.argmax(out, dim=-1)
                n_err = ((pred != labels) & valid).sum()
                if not confusion:
                    return n_err
                n = out.shape[-1]
                safe = torch.where(valid, labels, 0).long()
                matrix = torch.zeros(n * n, dtype=n_err.dtype,
                                     device=out.device).index_add(
                    0, safe * n + pred, valid.to(n_err.dtype))
                return torch.cat([n_err.reshape(1), matrix])
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
        start = time.perf_counter()
        is_train = self.sw.loader.minibatch_class == TRAIN
        # flight-only while only the ring is on: it keeps the last
        # steps' spans for a post-mortem dump even while full tracing
        # is off
        span = _tracer.open(
            "fused.train_step" if is_train else "fused.eval_step", start,
            cat="step", seq=self.iteration + 1 if is_train else None)
        elapsed = None
        try:
            elapsed = self._run_step(start, is_train, span.live)
        finally:
            span.close(None if elapsed is None else start + elapsed,
                       iteration=self.iteration)

    def _run_step(self, start, is_train, live):
        """One minibatch from ``start``; returns its host seconds.
        ``live``: record the child spans."""
        if self._step_fn_ is None:
            self._compile()
        loader = self.sw.loader
        prefetched = (self._prefetcher_.current
                      if self._prefetcher_ is not None else None)
        if prefetched is not None:
            x = prefetched.data
            target = (prefetched.labels if self.loss == "softmax"
                      else prefetched.targets)
        else:
            x = operand(self, loader.minibatch_data)
            target = operand(self, loader.minibatch_labels
                             if self.loss == "softmax"
                             else loader.minibatch_targets)
        batch_size = float(loader.minibatch_size)
        captures = (self._graphs_.receipt["captures"]
                    if self._graphs_ is not None else 0)
        if is_train and self.mesh is not None:
            x, target = self._local_rows(x), self._local_rows(target)
        elif getattr(loader, "static_minibatch", False):
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
            launched = time.perf_counter() if live else None
            self._state_, metrics = step(self._state_, x, target,
                                         batch_size, key, **poisons)
            if launched is not None:
                adopted = time.perf_counter()
                _tracer.complete("fused.replay", launched,
                                 adopted - launched, cat="step")
            self.sync()
            if launched is not None:
                _tracer.complete("fused.adopt", adopted,
                                 time.perf_counter() - adopted, cat="step")
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
            if self._confusion_:
                value = self._note_confusion(value, loader)
            if self.loss == "softmax":
                self.n_err = value
            else:
                self.mse_sum = value
        self.n_samples = int(batch_size)
        elapsed = time.perf_counter() - start
        if (is_train and self.mesh is not None
                and not self._comm_published_
                and self.iteration >= self._compiled_at_iter_ + 2):
            # the step after a compile pays its capture; this one is the
            # first clean step the overlap model can be sized on
            self._publish_comm(elapsed)
        histogram = self._m_train_step_ if is_train else self._m_eval_step_
        if self._clock_ is not None:
            self._clock_.mark(is_train, histogram, counted=(
                self._graphs_.receipt["captures"] == captures))
        else:
            histogram.observe(elapsed)
        if is_train:
            self._m_steps_.inc()
            self._m_samples_.inc(self.n_samples)
            if self._step_flops_ is None:
                self._publish_step_flops(x)
            profiler_step()
        return elapsed

    def _publish_step_flops(self, x):
        """The analytic FLOPs of one train step and of its forward
        (``compiler.step_flops``) for the live MFU: once, at the first
        train step; a failure leaves 0.0, so it is not retried."""
        from veles_tpu_torch.compiler import step_flops
        self._step_flops_ = 0.0
        try:
            flops = step_flops(self._plans_, self._state_, tuple(x.shape),
                               loss=self.loss)
        except Exception as exc:
            self.debug("step FLOPs unavailable: %s", exc)
            return
        self._step_flops_ = flops["train"]
        introspect.set_step_flops(flops["train"])
        if 0 < flops["forward"] < flops["train"]:
            introspect.set_fwd_flops(flops["forward"])

    def poll_step_times(self):
        """Observe the step times whose events have completed (a no-op
        on the CPU); never waits."""
        if self._clock_ is not None:
            self._clock_.poll()

    def _local_rows(self, tensor):
        """This rank's rows of a minibatch tensor."""
        from veles_tpu_torch.parallel.api import shard_batch
        from veles_tpu_torch.parallel.mesh import axis_size
        n = axis_size(self.mesh, self.data_axis)
        if tensor.shape[0] % n:
            raise ValueError("minibatch rows %d not divisible by mesh axis "
                             "%r=%d" % (tensor.shape[0], self.data_axis, n))
        return shard_batch(self.mesh, tensor, self.data_axis)

    def _publish_comm(self, step_seconds):
        """The one-time comm receipt: the bucket partition the step
        runs and the modeled overlap schedule, as ``comm.*`` gauges,
        :attr:`comm_receipt` and a log line."""
        from veles_tpu_torch.compiler import _grad_order
        from veles_tpu_torch.parallel import bucketed
        from veles_tpu_torch.parallel.mesh import axis_size
        self._comm_published_ = True
        leaves = [self._state_[i][key] for i, key in _grad_order(self._state_)]
        receipt = bucketed.comm_receipt(
            leaves, axis_size(self.mesh, self.data_axis),
            bucket_bytes=self._step_fn_.bucket_bytes,
            step_seconds=step_seconds, compress=self.grad_compress)
        bucketed.publish_comm_receipt(receipt)
        self.comm_receipt = receipt
        self.info("SPMD comm: %d bucket(s), %d gradient bytes, modeled "
                  "overlap %.1f%%", len(receipt["bucket_bytes"]),
                  receipt["allreduce_bytes"], receipt["model"]["overlap_pct"])

    def on_health_sync(self, skips, consec):
        """The decision's health-sync hook (once a finished train
        class): a skipped step under bf16 gradient compression may be
        the compressed wire format's doing — fall back to the f32
        all-reduce (the next run builds the step anew) rather than
        risk skipping every step a f32 run would carry.  The skipped
        update was already discarded by the step's guard."""
        del consec
        if (self.grad_compress is not None
                and skips > self._compress_skips_seen_):
            self.warning("non-finite step under %s gradient compression; "
                         "falling back to the f32 all-reduce",
                         self.grad_compress)
            from veles_tpu_torch.observe.metrics import registry
            registry.counter("comm.compress_fallbacks").inc()
            self.grad_compress = None
            self._step_fn_ = None
            self._raw_step_ = None
            self._comm_published_ = False
        self._compress_skips_seen_ = skips

    def _note_confusion(self, value, loader):
        """Split an evaluation's (n_err, confusion) tensor; a
        validation minibatch's confusion adds into the epoch's matrix,
        which the evaluator's ``confusion_matrix`` holds on the device.
        Returns n_err."""
        if loader.minibatch_class == VALID:
            n = int(round((value.numel() - 1) ** 0.5))
            matrix = value[1:].reshape(n, n).to(torch.int32)
            if self._confusion_epoch_ != loader.epoch_number:
                self._confusion_epoch_ = loader.epoch_number
                self._confusion_acc_ = matrix
            else:
                self._confusion_acc_ = self._confusion_acc_ + matrix
            adopt(self, self.sw.evaluator.confusion_matrix,
                  self._confusion_acc_)
        return value[0]

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
        # the JAX package's names, so the snapshot trains on there too;
        # a mesh holds process groups, so only its axes pickle
        from veles_tpu_torch.parallel.mesh import mesh_axes
        state.update({
            "_iteration": self.iteration,
            "_dropout_seed": self.dropout_seed,
            "_dropout_base_key": self.dropout_base_key,
            "_step_fn": None, "_state": None, "_eval_metrics": None,
            "_plans": None, "_prefetcher": None,
            "_spmd_axes_": (None if self.mesh is None
                            else mesh_axes(self.mesh)),
            "mesh": None, "comm_receipt": None})
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
        for key, value in (("mesh", None), ("data_axis", "data"),
                           ("grad_bucket_mb", None),
                           ("grad_compress", None), ("_spmd_axes_", None)):
            state.setdefault(key, value)
        super(FusedTrainer, self).__setstate__(state)


def fuse_standard_workflow(sw, dropout_seed=0, pipeline=False,
                           pipeline_depth=1, mesh=None, data_axis="data",
                           grad_bucket_mb=None, grad_compress=None):
    """Rewire a StandardWorkflow: loader -> FusedTrainer -> decision.

    The forward/GD units stay constructed (they own the parameter Arrays
    and create the initial weights at initialize) but leave the control
    graph.  ``pipeline=True`` serves minibatch k+1 (the gather or the
    host fill and its upload) on the input pipeline's worker while step
    k runs (``pipeline_input.Prefetcher``), in a standalone run.

    ``mesh`` switches the trainer to the SPMD data plane over
    ``data_axis`` (``grad_bucket_mb``, default ~25 MB, and
    ``grad_compress`` default to ``root.common.train``'s, which the
    CLI's ``--grad-bucket-mb`` / ``--grad-compress`` set); the workflow
    then validates updates inline (``update_validation``), as in the
    reference."""
    from veles_tpu_torch.config import root
    train_cfg = root.common.train
    if grad_bucket_mb is None:
        grad_bucket_mb = train_cfg.get("grad_bucket_mb")
    if grad_compress is None:
        grad_compress = train_cfg.get("grad_compress")
    trainer = FusedTrainer(sw, sw, dropout_seed=dropout_seed,
                           pipeline=pipeline, pipeline_depth=pipeline_depth,
                           mesh=mesh, data_axis=data_axis,
                           grad_bucket_mb=grad_bucket_mb,
                           grad_compress=grad_compress)
    if mesh is not None:
        sw.update_validation = "inline"
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
