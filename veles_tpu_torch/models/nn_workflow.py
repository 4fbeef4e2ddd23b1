"""Standard NN training workflow wiring.

Counterpart of ``veles_tpu/models/nn_workflow.py``: builds the loop
repeater -> loader -> forwards -> evaluator -> decision -> gds ->
repeater from a declarative ``layers`` list, with the stop path
decision.complete -> end_point.

A layer spec is a dict: {"type": "all2all_tanh",
"output_sample_shape": 100, ...hyperparameters...}; forward and GD
classes are looked up by their shared MAPPING name.

Every layer family runs both ways: per unit (each unit's ``run``; a GD
unit per layer, last layer first), and fused into one train step per
minibatch (``models/fused.py``).  The families are the JAX package's:
all2all, conv, pooling, dropout, the standalone activations,
deconv/depooling, the transformer layers and the recurrent layers
(``rnn``, ``lstm``).  A dropout GD unit reads its forward's ``mask``.

In a master-slave run (the launcher's ``-l`` / ``-m``) the workflow
keeps the per-unit graph on both sides (their units' states are zipped
in order), and a slave's repeater is unlinked: one job is one pass.

Snapshots and divergence recovery: when ``root.common.snapshot.dir`` is
set (the CLI's ``--snapshot-dir``), the workflow wires a
:class:`~veles_tpu_torch.snapshotter.Snapshotter` at the quiescent point
of the minibatch cycle and exports at every improved epoch.  On
divergence the decision's watchdog calls :meth:`on_divergence`, which
rolls the model back to the last verified snapshot
(:meth:`adopt_model_state`), multiplies every learning rate by
``divergence_lr_backoff`` and re-keys the fused trainer's dropout
stream; without a snapshotter it raises :class:`DivergenceError`.

:meth:`StandardWorkflow.link_plotters` links the standard plotters
(error curves, confusion matrix, weight histograms) from the decision.
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.health import DivergenceError
from veles_tpu_torch.models import (activation, all2all, conv, deconv,
                                    dropout, gd as gd_module, gd_conv,
                                    gd_pooling, pooling, rnn, transformer)
from veles_tpu_torch.models.decision import DecisionGD, DecisionMSE
from veles_tpu_torch.models.evaluator import EvaluatorMSE, EvaluatorSoftmax
from veles_tpu_torch.models.nn_units import ForwardBase, GradientDescentBase
from veles_tpu_torch.plotting_units import AccumulatingPlotter
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.workflow import Workflow

__all__ = ["StandardWorkflow", "EpochCurve", "forward_mapping", "gd_mapping"]


class EpochCurve(AccumulatingPlotter):
    """A decision's error for one class (``input_field``: 1 validation,
    2 train), one point a finished epoch."""

    def capture(self):
        decision = self.input
        if not bool(decision.epoch_ended):
            return
        value = decision.epoch_metrics[self.input_field]
        if value is not None:
            self.values.append(float(value))


def _build_mapping(modules, base):
    mapping = {}
    for module in modules:
        for name in dir(module):
            cls = getattr(module, name)
            if isinstance(cls, type) and issubclass(cls, base) and \
                    getattr(cls, "MAPPING", None):
                mapping[cls.MAPPING] = cls
    return mapping


def forward_mapping():
    """{MAPPING name: forward class} over the ported layer families."""
    return _build_mapping((all2all, conv, pooling, dropout, activation,
                           deconv, transformer, rnn), ForwardBase)


def gd_mapping():
    """{MAPPING name: GD class} over the ported layer families."""
    return _build_mapping((gd_module, gd_conv, gd_pooling, dropout,
                           activation, deconv, transformer, rnn),
                          GradientDescentBase)


class StandardWorkflow(Workflow):
    """loader_factory(workflow) -> Loader; layers: list of layer specs.

    kwargs: loss ("softmax" | "mse"), decision_config passed to the
    decision unit, divergence_lr_backoff (0.5: the learning-rate factor
    of each divergence rollback), result_file.
    """

    hide_from_registry = True

    def __init__(self, workflow, layers, loader_factory, **kwargs):
        super(StandardWorkflow, self).__init__(workflow, **kwargs)
        self.layers_config = layers
        self.loss = kwargs.get("loss", "softmax")
        decision_config = kwargs.get("decision_config", {})
        fmap = forward_mapping()
        gmap = gd_mapping()
        for spec in layers:
            if spec["type"] not in fmap:
                raise ValueError("layer type %r is not ported (known: %s)"
                                 % (spec["type"], ", ".join(sorted(fmap))))

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.loader = loader_factory(self)
        self.loader.link_from(self.repeater)

        # forwards
        self.forwards = []
        src_unit, src_attr = self.loader, "minibatch_data"
        for spec in layers:
            spec = dict(spec)
            ltype = spec.pop("type")
            unit = fmap[ltype](self, **spec)
            unit.link_from(self.forwards[-1] if self.forwards
                           else self.loader)
            unit.link_attrs(src_unit, ("input", src_attr))
            if "minibatch_class" in unit._demanded:  # dropout
                unit.link_attrs(self.loader, "minibatch_class")
            self.forwards.append(unit)
            src_unit, src_attr = unit, "output"

        # evaluator
        if self.loss == "softmax":
            self.evaluator = EvaluatorSoftmax(self)
            self.evaluator.link_attrs(self.loader,
                                      ("labels", "minibatch_labels"))
        elif self.loss == "mse":
            self.evaluator = EvaluatorMSE(self)
            self.evaluator.link_attrs(self.loader,
                                      ("target", "minibatch_targets"))
        else:
            raise ValueError("unknown loss %r" % self.loss)
        self.evaluator.link_from(self.forwards[-1])
        self.evaluator.link_attrs(self.forwards[-1], "output")
        self.evaluator.link_attrs(self.loader,
                                  ("batch_size", "minibatch_size"))

        # decision
        decision_cls = DecisionGD if self.loss == "softmax" else DecisionMSE
        self.decision = decision_cls(self, **decision_config)
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch", "epoch_ended",
            "epoch_number", "class_lengths")
        self.decision.evaluator = self.evaluator

        # gradient descent chain, last layer first
        self.gds = [None] * len(layers)
        prev_gd = None
        for i in reversed(range(len(layers))):
            spec = dict(layers[i])
            ltype = spec.pop("type")
            spec.pop("output_sample_shape", None)
            spec.pop("output_shape", None)
            unit = gmap[ltype](self, need_err_input=(i > 0), **spec)
            fwd = self.forwards[i]
            unit.link_attrs(fwd, "input", "output", "weights", "bias")
            if "mask" in unit._demanded:  # dropout backward
                unit.link_attrs(fwd, "mask")
            if prev_gd is None:
                unit.link_from(self.decision)
                unit.link_attrs(self.evaluator, "err_output")
            else:
                unit.link_from(prev_gd)
                unit.link_attrs(prev_gd, ("err_output", "err_input"))
            # completion SKIPS the chain instead of blocking it, so the
            # final cycle still reaches end_point; every gd carries the
            # complete term
            unit.gate_skip = self.decision.gd_skip | \
                self.decision.complete
            self.gds[i] = unit
            prev_gd = unit

        self.decision.health_sources = [gd for gd in self.gds
                                        if gd is not None]
        #: learning-rate factor applied by each divergence rollback
        self.divergence_lr_backoff = kwargs.get(
            "divergence_lr_backoff", 0.5)

        # close the loop and the exit path
        self.repeater.link_from(self.gds[0])
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete

        # standard snapshotting: when the config names a snapshot dir
        # (the CLI's --snapshot-dir), every improved epoch checkpoints;
        # restore with -w <file> or --resume
        self.snapshotter = None
        if root.common.snapshot.get("dir"):
            from veles_tpu_torch.snapshotter import Snapshotter
            self.snapshotter = Snapshotter(self, prefix=type(self).__name__)
            # the QUIESCENT point of the minibatch cycle: after the last
            # gd applied its update, before the repeater serves the next
            # minibatch, so every snapshot is an exact resume point
            # (weights, loader position, prng, decision totals agree).
            # Linked from the decision instead it would pickle torn
            # state: some layers updated, some not.
            self.snapshotter.link_from(self.gds[0])
            self.repeater.unlink_from(self.gds[0])
            self.repeater.link_from(self.snapshotter)
            # once per improved epoch: improved alone stays True through
            # the whole following epoch
            self.snapshotter.gate_skip = ~(self.decision.improved &
                                           self.loader.epoch_ended)
            # the exit waits on the snapshotter too, or the worklist is
            # abandoned at end_point before the final snapshot runs
            self.end_point.link_from(self.snapshotter)

    def fuse(self, **kwargs):
        """Swap the per-unit chain for the fused train step
        (``models/fused.py``); call before initialize()."""
        from veles_tpu_torch.models.fused import fuse_standard_workflow
        return fuse_standard_workflow(self, **kwargs)

    # -- numerics health: divergence recovery ---------------------------------

    def adopt_model_state(self, donor):
        """Copy the model state (forward params + gd solver
        accumulators) out of ``donor``, a workflow unpickled from a
        verified snapshot, into this workflow's live Arrays.  The host
        copies become current: each Array uploads at its next device
        read, and a fused trainer re-reads the Arrays after
        :meth:`FusedTrainer.reset_after_rollback`."""
        import numpy
        if len(donor.forwards) != len(self.forwards):
            raise ValueError(
                "snapshot workflow has %d forward layers, live one has "
                "%d — refusing to adopt" % (len(donor.forwards),
                                            len(self.forwards)))

        def copy_arrays(src_unit, dst_unit, names):
            for name in names:
                src = getattr(src_unit, name, None)
                dst = getattr(dst_unit, name, None)
                if src is None or dst is None or not src or not dst:
                    continue
                src.map_read()
                dst.map_invalidate()
                dst.mem = numpy.array(src.mem)

        for live, old in zip(self.forwards, donor.forwards):
            copy_arrays(old, live, ("weights", "bias"))
        for live, old in zip(self.gds, donor.gds):
            if live is None or old is None:
                continue
            copy_arrays(old, live, ("accum_weights", "accum_bias",
                                    "accum2_weights", "accum2_bias"))

    def on_divergence(self, reason):
        """The decision watchdog's recovery hook: roll the model back to
        the last verified snapshot, back off every layer's learning
        rate, re-key the fused dropout stream, and clear the health
        counters so the watchdog starts a fresh observation window.
        Without a snapshotter (or with the rollback budget spent) this
        raises."""
        if self.snapshotter is None:
            raise DivergenceError(
                "training diverged (%s) and no snapshotter is attached "
                "(set --snapshot-dir / root.common.snapshot.dir) — "
                "nothing to roll back to" % reason)
        path = self.snapshotter.rollback(reason=reason)
        backoff = self.divergence_lr_backoff
        for gd in self.gds:
            if gd is None:
                continue
            gd.learning_rate *= backoff
            gd.learning_rate_bias *= backoff
            gd.reset_health_counters()
        trainer = getattr(self, "fused_trainer", None)
        if trainer is not None:
            # the next step re-reads the restored Arrays and the
            # backed-off hyperparameters, with a re-keyed dropout stream
            trainer.reset_after_rollback(self.snapshotter.rollbacks)
        self.decision.reset_divergence()
        self.warning(
            "divergence recovery: restored %s, learning rates *= %g "
            "(rollback %d/%d); training continues", path, backoff,
            self.snapshotter.rollbacks, self.snapshotter.rollback_budget)

    def link_plotters(self):
        """Attach the standard plotter set: the validation and train
        error curves (one point a finished epoch), the confusion matrix
        and the per-layer weight histograms, linked from the decision
        and run at each epoch's end (the final one included: the exit
        waits on them), where they publish to the launcher's graphics
        server when one is attached.  Each capture
        reads the live Arrays on the host side of the unit graph, after
        the fused step (never inside a captured graph).  Per unit the
        confusion matrix is the evaluator's (accumulated over the run);
        fused, the evaluator leaves the graph and the trainer keeps the
        matrix of the epoch's validation minibatches.  Returns the
        plotters."""
        from veles_tpu_torch.plotting_units import (
            MatrixPlotter, MultiHistogram)
        self.plotters = []
        for cls_idx, cls_name in ((1, "validation"), (2, "train")):
            plot = EpochCurve(self, label="%s error %%" % cls_name,
                              input_field=cls_idx)
            plot.input = self.decision
            self.plotters.append(plot)
        if hasattr(self.evaluator, "confusion_matrix"):
            conf = MatrixPlotter(self)
            conf.input = self.evaluator.confusion_matrix
            self.plotters.append(conf)
        hist = MultiHistogram(self)
        hist.inputs = [f.weights for f in self.forwards
                       if f.weights is not None and hasattr(
                           f.weights, "map_read")]
        self.plotters.append(hist)
        for plot in self.plotters:
            plot.link_from(self.decision)
            plot.gate_skip = ~self.loader.epoch_ended
            # the exit waits on the plotters, so the final epoch's
            # capture runs too
            self.end_point.link_from(plot)
        return self.plotters

    def initialize(self, device=None, **kwargs):
        if self.workflow_mode == "slave":
            # one job is one pass: a slave does not loop the repeater;
            # the drained worklist ends the pass (the master iterates)
            self.repeater.unlink_from(
                self.gds[0] if self.snapshotter is None
                else self.snapshotter)
        elif self.workflow_mode == "standalone":
            # standalone only: a master and its slaves exchange unit
            # state by zipping their unit lists, so both keep the
            # per-unit graph
            device = self._maybe_auto_fuse(device)
        if device is None or isinstance(device, str):
            from veles_tpu_torch.backends import Device
            device = Device() if device is None else Device(device)
        return super(StandardWorkflow, self).initialize(
            device=device, **kwargs)

    def _maybe_auto_fuse(self, device):
        """Fuse automatically when the device is a CUDA card.

        The per-unit graph is the debug path on the card: it launches
        every unit's kernels with host scheduling in between.  The
        product default is the fused step, with the input pipeline
        (``root.common.engine.pipeline_input``, ``VELES_PIPELINE_INPUT=0``
        to serve in sequence);
        ``root.common.engine.auto_fuse = False`` (or
        ``VELES_AUTO_FUSE=0``) keeps the per-unit graph.  The host
        pseudo-device (``NumpyDevice``) never fuses on its own, as in the
        JAX package: each unit takes its host run.  A CPU device
        keeps the per-unit default, except in a ``torch.distributed``
        world (``Launcher.init_multihost``): there the workflow fuses
        with a data-parallel mesh over the world (``parallel.auto_mesh``
        on the device's backend), the per-unit graph having no
        data-parallel path.  ``device=None`` means the default
        ``Device()``, the card, which raises when there is none.
        Returns the resolved device."""
        import torch.distributed as dist

        from veles_tpu_torch.backends import Device
        if device is None or isinstance(device, str):
            device = Device() if device is None else Device(device)
        meshed = dist.is_available() and dist.is_initialized()
        if (getattr(self, "fused_trainer", None) is None
                and root.common.engine.get("auto_fuse", True)
                and device.exists
                and (device.backend == "cuda" or meshed)):
            kwargs = {}
            if meshed:
                from veles_tpu_torch.parallel import auto_mesh
                kwargs["mesh"] = auto_mesh(device=device.torch_device)
                self.info("a world of %d processes: fusing the train loop "
                          "with a data-parallel mesh over it",
                          dist.get_world_size())
            else:
                self.info("CUDA device: fusing the train loop into one "
                          "step per minibatch (root.common.engine."
                          "auto_fuse = False keeps the per-unit graph)")
            self.fuse(pipeline=root.common.engine.get("pipeline_input",
                                                      True), **kwargs)
        return device
