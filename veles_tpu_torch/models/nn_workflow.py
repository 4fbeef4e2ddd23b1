"""Standard NN training workflow wiring.

Counterpart of ``veles_tpu/models/nn_workflow.py``: builds the loop
repeater -> loader -> forwards -> evaluator -> decision -> gds ->
repeater from a declarative ``layers`` list, with the stop path
decision.complete -> end_point.

A layer spec is a dict: {"type": "all2all_tanh",
"output_sample_shape": 100, ...hyperparameters...}; forward and GD
classes are looked up by their shared MAPPING name.

The all2all families run both ways: per unit, and fused into one train
step per minibatch (``models/fused.py``).  The conv, pooling, dropout and
transformer layers have their forward units (which size their outputs
and draw their weights at initialize) but no GD units yet: a
:class:`GDNotPorted` holds their solver settings and state for the fused
step, and a workflow with one of them runs fused only; initializing it
for the per-unit graph raises ``NotImplementedError``.
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.models import (all2all, conv, dropout, gd as gd_module,
                                    pooling, transformer)
from veles_tpu_torch.models.decision import (DecisionGD, DecisionMSE,
                                             DivergenceError)
from veles_tpu_torch.models.evaluator import EvaluatorMSE, EvaluatorSoftmax
from veles_tpu_torch.models.nn_units import ForwardBase, GradientDescentBase
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.workflow import Workflow

__all__ = ["StandardWorkflow", "forward_mapping", "gd_mapping"]


def _build_mapping(modules, base):
    mapping = {}
    for module in modules:
        for name in dir(module):
            cls = getattr(module, name)
            if isinstance(cls, type) and issubclass(cls, base) and \
                    getattr(cls, "MAPPING", None):
                mapping[cls.MAPPING] = cls
    return mapping


class GDNotPorted(GradientDescentBase):
    """The GD unit of a layer whose per-unit backward is not ported
    (conv, pooling, dropout, transformer: ROADMAP.md Queue 1 item 3).
    It carries the layer's solver, hyperparameters and accumulators,
    which the fused step reads, and refuses to run."""

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, **kwargs):
        raise NotImplementedError(
            "the per-unit backward of this layer is not ported (ROADMAP.md "
            "Queue 1 item 3): fuse the workflow")


def forward_mapping():
    """{MAPPING name: forward class} over the ported layer families."""
    return _build_mapping((all2all, conv, pooling, dropout, transformer),
                          ForwardBase)


def gd_mapping():
    """{MAPPING name: GD class} over the ported GD units (the all2all
    family)."""
    return _build_mapping((gd_module,), GradientDescentBase)


class StandardWorkflow(Workflow):
    """loader_factory(workflow) -> Loader; layers: list of layer specs.

    kwargs: loss ("softmax" | "mse"), decision_config passed to the
    decision unit.
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
            unit = gmap.get(ltype, GDNotPorted)(
                self, need_err_input=(i > 0), **spec)
            fwd = self.forwards[i]
            unit.link_attrs(fwd, "input", "output", "weights", "bias")
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

        # close the loop and the exit path
        self.repeater.link_from(self.gds[0])
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete

    def fuse(self, **kwargs):
        """Swap the per-unit chain for the fused train step
        (``models/fused.py``); call before initialize()."""
        from veles_tpu_torch.models.fused import fuse_standard_workflow
        return fuse_standard_workflow(self, **kwargs)

    def on_divergence(self, reason):
        """The decision watchdog's recovery hook.  Recovery rolls back
        to a snapshot, and the port has no snapshots yet: raise."""
        raise DivergenceError(
            "training diverged (%s) and no snapshotter is attached — "
            "nothing to roll back to" % reason)

    def initialize(self, device=None, **kwargs):
        device = self._maybe_auto_fuse(device)
        unported = [spec["type"] for spec, gd in
                    zip(self.layers_config, self.gds)
                    if isinstance(gd, GDNotPorted)]
        if unported and getattr(self, "fused_trainer", None) is None:
            raise NotImplementedError(
                "the per-unit graph of %s is not ported (ROADMAP.md Queue "
                "1 item 3): fuse the workflow (sw.fuse(), or a CUDA device "
                "with root.common.engine.auto_fuse on)" % ", ".join(unported))
        return super(StandardWorkflow, self).initialize(
            device=device, **kwargs)

    def _maybe_auto_fuse(self, device):
        """Fuse automatically when the device is a CUDA card.

        The per-unit graph is the debug path on the card: it launches
        every unit's kernels with host scheduling in between.  The
        product default is the fused step;
        ``root.common.engine.auto_fuse = False`` (or
        ``VELES_AUTO_FUSE=0``) keeps the per-unit graph.  A CPU device
        keeps the per-unit default.  ``device=None`` means the default
        ``Device()``, the card, which raises when there is none.
        Returns the resolved device."""
        from veles_tpu_torch.backends import Device
        if device is None or isinstance(device, str):
            device = Device() if device is None else Device(device)
        if (getattr(self, "fused_trainer", None) is None
                and root.common.engine.get("auto_fuse", True)
                and device.backend == "cuda"):
            self.info("CUDA device: fusing the train loop into one step "
                      "per minibatch (root.common.engine.auto_fuse = "
                      "False keeps the per-unit graph)")
            self.fuse()
        return device
