"""Trivial graph-delimiting units; counterpart of
``veles_tpu/plumbing.py``."""

from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit

__all__ = ["StartPoint", "EndPoint", "Repeater", "EpochCounter"]


class StartPoint(Unit):
    """The graph entry point; running it kicks off every successor."""

    hide_from_registry = True

    def initialize(self, **kwargs):
        self._is_initialized_ = True
        return True

    def run(self):
        pass


class EndPoint(StartPoint):
    """The graph exit; running it signals workflow completion."""

    def run(self):
        if self.workflow is not None:
            self.workflow.on_workflow_finished()


class Repeater(StartPoint):
    """Loop head: ignores its gate so the training loop can cycle back
    through it every iteration."""

    def __init__(self, workflow, **kwargs):
        super(Repeater, self).__init__(workflow, **kwargs)
        self.ignores_gate <<= True


class EpochCounter(Unit):
    """Raises ``complete`` after N loop passes — the minimal termination
    gate for repeater loops without a Decision unit.  The pass count
    resets on (re-)initialize."""

    def __init__(self, workflow, epochs, **kwargs):
        super(EpochCounter, self).__init__(workflow, **kwargs)
        self.epochs = epochs
        self.passes = 0
        self.complete = Bool(False)

    def initialize(self, **kwargs):
        self.passes = 0
        self.complete <<= False
        return super(EpochCounter, self).initialize(**kwargs)

    def run(self):
        self.passes += 1
        if self.passes >= self.epochs:
            self.complete <<= True
