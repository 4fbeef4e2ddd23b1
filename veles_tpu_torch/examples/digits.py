"""Handwritten digits: the offline real-data quality anchor.

Counterpart of ``examples/digits.py``, with its layers, hyperparameters
and seeds: 64 -> all2all_tanh 64 -> softmax 10 over the 1,797 real 8x8
digits of ``veles_tpu_torch/data/digits.csv.gz``
(:class:`~veles_tpu_torch.datasets.DigitsLoader`), minibatch 48, at most
60 epochs.  On the card it fuses into one train step a minibatch, the
input pipeline serving ahead; each minibatch is one ``gather_minibatch``
launch.

    python -m veles_tpu_torch veles_tpu_torch/examples/digits.py -
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import DigitsLoader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.digits.update({
    "hidden": 64,
    "minibatch_size": 48,
    "learning_rate": 0.08,
    "gradient_moment": 0.9,
    "weights_decay": 1e-4,
    "max_epochs": 60,
    "fail_iterations": 20,
})


def build(launcher):
    cfg = root.digits
    hyper = {"learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment,
             "weights_decay": cfg.weights_decay}
    return StandardWorkflow(
        launcher,
        layers=[
            dict(type="all2all_tanh", output_sample_shape=cfg.hidden,
                 **hyper),
            dict(type="softmax", output_sample_shape=10, **hyper),
        ],
        loader_factory=lambda w: DigitsLoader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("digits", seed=2)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
