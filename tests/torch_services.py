"""Port workflows shared by the services' tests (forge, native): the
blobs MLP of tests/test_native.py's ``_train_mlp`` and the tiny-image
conv net of its conv case, on the port, and the port's CPU forward.
Imports no JAX."""

import numpy
import torch

from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

__all__ = ["CPU", "Blobs", "TinyImages", "train_mlp", "train_conv",
           "forward"]

CPU = Device(backend="cpu")


class Blobs(FullBatchLoader):
    """tests/test_models.py's BlobsLoader: 4 Gaussian blobs, 16 wide."""

    def load_data(self):
        self.class_lengths[:] = [0, 64, 256]
        self._calc_class_end_offsets()
        self.create_originals((16,))
        rng = numpy.random.RandomState(99)
        centers = rng.randn(4, 16) * 2.0
        for i in range(self.total_samples):
            label = i % 4
            self.original_data.mem[i] = centers[label] + rng.randn(16) * 0.3
            self.original_labels[i] = label


class TinyImages(FullBatchLoader):
    """tests/test_conv.py's TinyImageLoader: 8x8 images, the class is the
    bright quadrant."""

    def load_data(self):
        self.class_lengths[:] = [0, 48, 192]
        self._calc_class_end_offsets()
        self.create_originals((8, 8, 1))
        rng = numpy.random.RandomState(5)
        for i in range(self.total_samples):
            label = i % 3
            img = rng.rand(8, 8, 1).astype(numpy.float32) * 0.3
            r, c = divmod(label, 2)
            img[r * 4:(r + 1) * 4, c * 4:(c + 1) * 4, 0] += 1.0
            self.original_data.mem[i] = img
            self.original_labels[i] = label


def train_mlp(epochs=3, layers=None, device=CPU):
    """tests/test_native.py's ``_train_mlp`` on the port."""
    sw = StandardWorkflow(
        DummyWorkflow(),
        layers=layers or [
            {"type": "all2all_tanh", "output_sample_shape": 32,
             "learning_rate": 0.05, "gradient_moment": 0.9},
            {"type": "softmax", "output_sample_shape": 4,
             "learning_rate": 0.05, "gradient_moment": 0.9},
        ],
        loader_factory=lambda w: Blobs(
            w, minibatch_size=64, prng=RandomGenerator("nat", seed=5)),
        decision_config=dict(max_epochs=epochs))
    sw.initialize(device=device)
    if epochs:
        sw.run()
    return sw


def train_conv(epochs=2, device=CPU):
    """tests/test_native.py's conv workflow on the port."""
    sw = StandardWorkflow(
        DummyWorkflow(),
        layers=[
            {"type": "conv_tanh", "n_kernels": 6, "kx": 3, "ky": 3,
             "padding": 1, "learning_rate": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "softmax", "output_sample_shape": 3,
             "learning_rate": 0.05},
        ],
        loader_factory=lambda w: TinyImages(
            w, minibatch_size=48, prng=RandomGenerator("natc", seed=6)),
        decision_config=dict(max_epochs=epochs))
    sw.initialize(device=device)
    sw.run()
    return sw


def forward(sw, x):
    """The port's forward of ``sw`` on host ``x`` (the CPU), as numpy."""
    from veles_tpu_torch.compiler import (build_forward, extract_state,
                                          workflow_plan)
    params = [{"weights": s["weights"], "bias": s["bias"]}
              for s in extract_state(sw)]
    device = params[0]["weights"].device
    with torch.no_grad():
        out = build_forward(workflow_plan(sw))(
            params, torch.from_numpy(numpy.ascontiguousarray(
                x, numpy.float32)).to(device))
    return out.cpu().numpy()
