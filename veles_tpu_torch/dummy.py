"""Test stand-ins; counterpart of ``veles_tpu/dummy.py``."""

from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import Workflow

__all__ = ["DummyLauncher", "DummyWorkflow", "DummyUnit"]


class DummyLauncher(object):
    """Minimal launcher substitute so any unit/workflow runs standalone."""

    workflow_mode = "standalone"

    def __init__(self, **kwargs):
        self._workflows = []
        self.stopped = False
        self.interactive = False

    def add_ref(self, workflow):
        self._workflows.append(workflow)

    def del_ref(self, workflow):
        if workflow in self._workflows:
            self._workflows.remove(workflow)

    def on_workflow_finished(self):
        self.stopped = True

    @property
    def workflow(self):
        return self._workflows[0] if self._workflows else None


class DummyWorkflow(Workflow):
    """Workflow auto-owning its own DummyLauncher."""

    def __init__(self, **kwargs):
        super(DummyWorkflow, self).__init__(DummyLauncher(), **kwargs)


class DummyUnit(Unit):
    """Unit whose attributes are set freely from kwargs."""

    def __init__(self, workflow=None, **kwargs):
        attrs = dict(kwargs)
        super(DummyUnit, self).__init__(
            workflow if workflow is not None else DummyWorkflow())
        for key, value in attrs.items():
            setattr(self, key, value)

    def initialize(self, **kwargs):
        self._is_initialized_ = True
        return True

    def run(self):
        pass
