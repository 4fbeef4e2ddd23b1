"""Shared pieces of the port's master-slave tests.

The counterparts of tests/test_chaos.py's and tests/test_network.py's
``_build`` / ``_start_server`` / ``_weights`` on the port: the seeded
two-layer momentum MLP over tests/test_models.py's ``BlobsLoader``
(``Blobs`` here, the same samples), in master, slave or standalone mode
on the CPU, and a :class:`veles_tpu_torch.server.Server` on an
ephemeral 127.0.0.1 port whose workflow end stops it.

Import the fixture into a test module (``from tests.torch_master_slave
import port_net_isolated  # noqa: F401``): it is autouse there.  It
fails a test that leaves one of the port's ``ShmChannel`` segments open
(tests/conftest.py checks the JAX package's) and removes a chaos plan
left installed in the port; the port's flight dumps go to the test's
tmp directory.
"""

import time

import numpy
import pytest
import torch

from veles_tpu_torch import chaos, prng
from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.network_common import ShmChannel
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.server import Server

CPU = Device(backend="cpu")

LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 32,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "softmax", "output_sample_shape": 4,
     "learning_rate": 0.05, "gradient_moment": 0.9},
]


class Blobs(FullBatchLoader):
    """tests/test_models.py's BlobsLoader: 4 Gaussian blobs, 64
    validation and 256 train samples of width 16."""

    def load_data(self):
        self.class_lengths[:] = [0, 64, 256]
        self._calc_class_end_offsets()
        self.create_originals((16,))
        rng = numpy.random.RandomState(99)
        centers = rng.randn(4, 16) * 2.0
        for i in range(self.total_samples):
            label = i % 4
            self.original_data.mem[i] = (
                centers[label] + rng.randn(16) * 0.3)
            self.original_labels[i] = label


def build(mode, seed_key, max_epochs=3, layers=LAYERS, loader=Blobs,
          minibatch_size=64, device=CPU):
    """tests/test_chaos.py's ``_build`` on the port: the layer-init
    stream seeded 4242, the loader's shuffle stream ``seed_key`` /
    seed 7."""
    torch.set_num_threads(1)
    prng.get().seed(4242)
    wf = DummyWorkflow()
    wf.workflow.workflow_mode = mode
    sw = StandardWorkflow(
        wf.workflow, layers=[dict(spec) for spec in layers],
        loader_factory=lambda w: loader(
            w, minibatch_size=minibatch_size,
            prng=RandomGenerator(seed_key, seed=7)),
        decision_config=dict(max_epochs=max_epochs),
    )
    sw.initialize(device=device)
    return sw


def start_server(master_sw, **kwargs):
    server = Server("127.0.0.1:0", master_sw, **kwargs)
    master_sw.workflow.on_workflow_finished = server.on_workflow_finished
    thread = server.start_background()
    assert server.wait_listening(10), server.bind_error
    return server, thread


def weights(sw):
    out = []
    for fwd in sw.forwards:
        fwd.weights.map_read()
        out.append(numpy.array(fwd.weights.mem))
    return out


def wait_for(predicate, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError("timed out waiting for " + what)


@pytest.fixture(autouse=True)
def port_net_isolated(tmp_path, monkeypatch):
    from veles_tpu_torch.observe.flight import flight
    monkeypatch.setattr(flight, "base_path",
                        str(tmp_path / "veles_flight"))
    before = ShmChannel.open_channels()
    yield
    chaos.uninstall()
    deadline = time.time() + 3.0
    leaked = []
    while time.time() < deadline:
        leaked = [c for c in ShmChannel.open_channels() if c not in before]
        if not leaked:
            return
        time.sleep(0.05)
    for chan in leaked:
        chan.close()
    pytest.fail("leaked port ShmChannel segment(s): %s" %
                ", ".join(sorted(c.name for c in leaked)))
