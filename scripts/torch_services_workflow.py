"""digits_conv (``veles_tpu_torch/examples/digits_conv.py``, at its full
width) with a unit that reports where it ran, for the services phase
(``scripts/torch_services_phase.py``): the composer's run and the
daemon's.

    python -m veles_tpu_torch scripts/torch_services_workflow.py - \\
        [--result-file R] [root.digits_conv.max_epochs=N]

The result file carries, beside the loader's and the decision's
metrics, ``Device`` (the card's name, ``torch.cuda.get_device_name``,
or ``cpu``), ``Backend`` and the process's ``Pid``; the log names the
card at initialize.
"""

import os

from veles_tpu_torch.examples.digits_conv import build as digits_conv
from veles_tpu_torch.units import Unit


class CardReport(Unit):
    """Outside the control graph: names the workflow's device in the
    results and the log."""

    hide_from_registry = True

    def device(self):
        return getattr(self.workflow, "device", None)

    def card(self):
        device = self.device()
        if device is None or device.backend != "cuda":
            return "cpu"
        import torch
        return torch.cuda.get_device_name(device.torch_device)

    def initialize(self, **kwargs):
        super(CardReport, self).initialize(**kwargs)
        self.info("workflow on %s", self.card())
        return True

    def run(self):
        pass

    def get_metric_values(self):
        device = self.device()
        return {"Device": self.card(), "Pid": os.getpid(),
                "Backend": None if device is None else device.backend}


def build(launcher):
    sw = digits_conv(launcher)
    sw.card_report = CardReport(sw)
    return sw


def run(load, main):
    load(build)
    main()
