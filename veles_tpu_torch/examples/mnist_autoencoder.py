"""MNIST autoencoder: the published quality target is validation RMSE
0.5478.

Counterpart of ``examples/mnist_autoencoder.py``, with its layers,
hyperparameters and seeds: all2all_tanh 100 -> all2all 784 under the MSE
loss, minibatch 100, at most 80 epochs.  On the card it fuses into one
train step a minibatch; each minibatch is one ``gather_minibatch``
launch.

    python -m veles_tpu_torch veles_tpu_torch/examples/mnist_autoencoder.py -

Needs the MNIST idx files under ``root.common.dirs.datasets``
(``VELES_DATA``); the offline stand-in reconstructing the 8x8 digits is
``autoencoder.py``.
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import _SplitLoaderMSE, mnist_arrays
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

root.mnist_ae.update({
    "hidden": 100,
    "minibatch_size": 100,
    "learning_rate": 0.05,
    "gradient_moment": 0.9,
    "max_epochs": 80,
    "fail_iterations": 20,
})


class MnistAELoader(_SplitLoaderMSE):
    """MNIST images as both input and target."""

    def get_arrays(self):
        train_x, train_y, test_x, test_y = mnist_arrays()
        return train_x, train_y, test_x, test_y


def build(launcher):
    cfg = root.mnist_ae
    hyper = {"learning_rate": cfg.learning_rate,
             "gradient_moment": cfg.gradient_moment}
    return StandardWorkflow(
        launcher,
        layers=[
            {"type": "all2all_tanh",
             "output_sample_shape": cfg.hidden, **hyper},
            {"type": "all2all", "output_sample_shape": 784, **hyper},
        ],
        loss="mse",
        loader_factory=lambda w: MnistAELoader(
            w, minibatch_size=cfg.minibatch_size,
            prng=RandomGenerator("mnist_ae", seed=8)),
        decision_config=dict(max_epochs=cfg.max_epochs,
                             fail_iterations=cfg.fail_iterations),
        result_file=root.common.get("result_file"),
    )


def run(load, main):
    load(build)
    main()
