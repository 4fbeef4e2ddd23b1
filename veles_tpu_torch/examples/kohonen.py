"""Kohonen self-organising map over the real handwritten digits.

Counterpart of ``examples/kohonen.py``, with its grid, hyperparameters
and seeds: the SOM (8x8 neurons, alpha 0.3) clusters the 64-feature
digits of ``veles_tpu_torch/data/digits.csv.gz`` without labels, one
update over the 1,437 train digits an epoch for 100 epochs, then reports
how cleanly the grid separates the true classes (winner purity on the
360 validation digits).  The map trains on the unit's device (the card
unless ``-d cpu``); the winners return to the host once, for the purity.

    python -m veles_tpu_torch veles_tpu_torch/examples/kohonen.py -
"""

import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import digits_arrays
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.kohonen import KohonenForward, KohonenTrainer
from veles_tpu_torch.plumbing import EpochCounter, Repeater
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.workflow import Workflow

root.kohonen.update({
    "shape": (8, 8),
    "epochs": 100,
    "alpha": 0.3,
})


def purity(winners, labels, neurons):
    """Fraction of samples whose winning neuron's majority label
    matches their own: the SOM quality readout."""
    correct = 0
    for neuron in range(neurons):
        mask = winners == neuron
        if not mask.any():
            continue
        correct += numpy.bincount(labels[mask]).max()
    return correct / len(labels)


class KohonenWorkflow(Workflow):
    """start -> repeater -> trainer -> counter -> (loop | end); the
    forward/purity readout runs once after the loop ends."""

    def __init__(self, launcher, **kwargs):
        super(KohonenWorkflow, self).__init__(launcher, **kwargs)
        cfg = root.kohonen
        shape = tuple(cfg.shape)
        train_x, _, valid_x, valid_y = digits_arrays(360, 4)
        self.valid_labels = valid_y.astype(numpy.int64)
        self.purity = None

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.trainer = KohonenTrainer(
            self, shape=shape, alpha=cfg.alpha,
            prng=RandomGenerator("kohonen", seed=9))
        self.trainer.input = Array(train_x)
        self.trainer.link_from(self.repeater)

        self.counter = EpochCounter(self, int(cfg.epochs))
        self.counter.link_from(self.trainer)

        self.repeater.link_from(self.counter)
        self.end_point.link_from(self.counter)
        self.end_point.gate_block = ~self.counter.complete

        self.forward = KohonenForward(self, shape=shape)
        self.forward.input = Array(valid_x)
        self.forward.weights = self.trainer.weights

    def on_workflow_finished(self):
        # readout: winners on the held-out split -> purity (the
        # forward unit was initialized with the rest of the graph)
        self.forward.run()
        self.forward.output.map_read()
        self.purity = purity(
            numpy.asarray(self.forward.output.mem),
            self.valid_labels, self.trainer.neurons_number)
        self.info("SOM validation purity: %.1f%% "
                  "(%d neurons, %d epochs)",
                  100.0 * self.purity, self.trainer.neurons_number,
                  self.counter.passes)
        super(KohonenWorkflow, self).on_workflow_finished()


def run(load, main):
    load(KohonenWorkflow)
    main()
