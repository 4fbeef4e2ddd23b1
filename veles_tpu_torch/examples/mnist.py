"""MNIST fully-connected workflow: the 784-100-10 parity model.

Counterpart of ``examples/mnist.py``, with its layers, hyperparameters
and seeds: all2all_tanh 100 -> softmax 10, minibatch 100, lr 0.1, moment
0.9, weight decay 5e-5, at most 100 epochs (published validation error
1.48 %).  On the card it fuses into one train step a minibatch, the
input pipeline serving ahead; each minibatch is one ``gather_minibatch``
launch.

    python -m veles_tpu_torch veles_tpu_torch/examples/mnist.py -

Needs the MNIST idx files under ``root.common.dirs.datasets``
(``VELES_DATA``); see ``veles_tpu_torch/datasets.py``.
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import MnistLoader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.mnist.update({
    "hidden": 100,
    "minibatch_size": 100,
    "learning_rate": 0.1,
    "gradient_moment": 0.9,
    "weights_decay": 5e-5,
    "max_epochs": 100,
    "fail_iterations": 25,       # early stop when validation stalls
})


def build(launcher):
    cfg = root.mnist
    return StandardWorkflow(
        launcher,
        layers=[
            {"type": "all2all_tanh",
             "output_sample_shape": cfg.hidden,
             "learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment,
             "weights_decay": cfg.weights_decay},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment,
             "weights_decay": cfg.weights_decay},
        ],
        loader_factory=lambda w: MnistLoader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("mnist", seed=1)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
