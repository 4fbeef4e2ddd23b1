"""Transformer sequence classification on the real handwritten digits.

Counterpart of ``examples/transformer.py``, with its layers,
hyperparameters and seeds: each 8x8 digit of
``veles_tpu_torch/data/digits.csv.gz`` is fed as a sequence of 8
row-vectors, 2 pre-LN transformer blocks (2 heads, MLP 32) mix the rows,
and a softmax head classifies the flattened sequence; minibatch 48, at
most 60 epochs.  On the card it fuses into one train step a minibatch,
the input pipeline serving ahead: each minibatch is one
``gather_minibatch`` launch, and each train step runs the flash-attention
kernels at (batch x heads, T, head width) = (96, 8, 4), (90, 8, 4) for
the last train minibatch: one forward, one dq and one dk/dv launch a
block.

    python -m veles_tpu_torch veles_tpu_torch/examples/transformer.py -
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import DigitsLoader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.transformer.update({
    "blocks": 2,
    "heads": 2,
    "hidden": 32,
    "learning_rate": 0.05,
    "gradient_moment": 0.9,
    "minibatch_size": 48,
    "max_epochs": 60,
    "fail_iterations": 15,
})


class DigitsRowsLoader(DigitsLoader):
    """Serves digits reshaped (batch, 8, 8): a sequence of 8 rows."""

    def load_data(self):
        super(DigitsRowsLoader, self).load_data()
        data = self.original_data.mem
        self.original_data = data.reshape(len(data), 8, 8)


def build(launcher):
    cfg = root.transformer
    layers = [
        {"type": "transformer", "heads": cfg.heads,
         "hidden": cfg.hidden, "learning_rate": cfg.learning_rate,
         "gradient_moment": cfg.gradient_moment}
        for _ in range(cfg.blocks)
    ]
    layers.append({"type": "softmax", "output_sample_shape": 10,
                   "learning_rate": cfg.learning_rate,
                   "gradient_moment": cfg.gradient_moment})
    return StandardWorkflow(
        launcher,
        layers=layers,
        loader_factory=lambda w: DigitsRowsLoader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("transformer", seed=21)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
