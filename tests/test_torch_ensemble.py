"""The port's ensembles (veles_tpu_torch/ensemble/) on the CPU, against
the JAX package's (veles_tpu/ensemble/).

- The counterparts of tests/test_genetics.py's ensemble tests: farmed
  training over two local workers, a farmed test equal to the
  in-process one, the remote-only worker entry point, ``train_ratio``
  reaching three-argument factories (and not ``**kwargs`` ones), and an
  in-process train then test; on tests/test_models.py's Blobs MLP.
- Members the JAX package trained (its ``ensemble.json`` and pickles)
  are read by the port's tester through the snapshotter's unpickler:
  its predictions are within 1e-5 of the JAX tester's.
- Members the port trains from the same specs and seeds (the layer-init
  stream seeded per member in both packages) agree with the JAX
  package's: equal epoch metrics, weights within the master-slave
  tests' epoch limit (``EPOCH_TOL``, 1e-4 max-rel); ``ensemble.json``
  has the JAX keys.
- A fused member's pickle holds the weights its step trained.
- Without ``-d`` and ``VELES_BACKEND`` a member, a farmed run and a
  worker ask for the card and raise ``no CUDA device`` first.
"""

import json
import os
import pickle
import socket
import threading

import numpy
import pytest
import torch

from tests.test_torch_network import EPOCH_TOL, _max_rel
from tests.torch_master_slave import Blobs, port_net_isolated  # noqa: F401
from veles_tpu_torch import prng
from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.ensemble import EnsembleTester, EnsembleTrainer
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.prng import RandomGenerator

CPU = Device("cpu")

LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 16,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "softmax", "output_sample_shape": 4,
     "learning_rate": 0.05, "gradient_moment": 0.9},
]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _member_factory(member, seed):
    """tests/test_genetics.py's ``_member_factory`` on the port."""
    wf = DummyWorkflow()
    return StandardWorkflow(
        wf.workflow, layers=[dict(s) for s in LAYERS],
        loader_factory=lambda w: Blobs(
            w, minibatch_size=64,
            prng=RandomGenerator("ens%d" % member, seed=seed)),
        decision_config=dict(max_epochs=3))


def _seeded_factory(member, seed):
    """The port's member with its layer-init stream seeded per member."""
    prng.get().seed(4242 + member)
    return _member_factory(member, seed)


def _jax_seeded_factory(member, seed):
    """tests/test_genetics.py's ``_member_factory``, the layer-init
    stream seeded as :func:`_seeded_factory` seeds the port's."""
    from veles_tpu import prng as jax_prng
    from tests.test_genetics import _member_factory as jax_factory
    jax_prng.get().seed(4242 + member)
    return jax_factory(member, seed)


def _blobs(key, seed, start, stop):
    wf = DummyWorkflow()
    loader = Blobs(wf, minibatch_size=64,
                   prng=RandomGenerator(key, seed=seed))
    loader.initialize(device=None)
    x = numpy.array(loader.original_data.mem[start:stop])
    labels = numpy.array([loader.labels_mapping[loader.original_labels[i]]
                          for i in range(start, stop)])
    return x, labels


def _weights(sw):
    out = []
    for fwd in sw.forwards:
        for arr in (fwd.weights, fwd.bias):
            arr.map_read()
            out.append(numpy.array(arr.mem))
    return out


# -- the counterparts of tests/test_genetics.py ------------------------------


def test_ensemble_trains_distributed_over_control_plane(tmp_path):
    trainer = EnsembleTrainer(_member_factory, size=4,
                              directory=str(tmp_path), device=CPU,
                              farm_slaves=2)
    results_path = trainer.run()
    assert [e["id"] for e in trainer.results] == [0, 1, 2, 3]
    assert all(e["metrics"][1] is not None for e in trainer.results)
    assert trainer.farm_stats["served"] >= 4
    tester = EnsembleTester(results_path, device=CPU)
    x, labels = _blobs("enstest2", 78, 64, 128)
    err = tester.error_rate(x, labels)
    assert err < 10.0, "ensemble error %.1f%%" % err


def test_ensemble_test_farms_member_evaluation(tmp_path):
    """Farmed predictions equal the in-process ones exactly."""
    trainer = EnsembleTrainer(_member_factory, size=3,
                              directory=str(tmp_path), device=CPU)
    results_path = trainer.run()
    x, _ = _blobs("enstest3", 79, 0, 32)
    inproc = EnsembleTester(results_path, device=CPU)
    farmed = EnsembleTester(results_path, device=CPU, farm_slaves=2)
    got = farmed.predict(x)
    assert got.tobytes() == inproc.predict(x).tobytes()
    assert got.shape == (32, 4)


def test_ensemble_remote_worker_entrypoint(tmp_path):
    """Remote-only farming: an explicit address and no local workers;
    a worker joins through ``trainer.worker()``."""
    from veles_tpu_torch import jobfarm
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    master = EnsembleTrainer(_member_factory, size=2,
                             directory=str(tmp_path), device=CPU,
                             farm_address="127.0.0.1:%d" % port)
    assert master.farm_enabled
    worker = EnsembleTrainer(_member_factory, size=2,
                             directory=str(tmp_path), device=CPU)
    started = threading.Event()
    address = {}
    orig_start = jobfarm.JobFarm.start

    def start_and_publish(self, **kwargs):
        out = orig_start(self, **kwargs)
        address["addr"] = self.address
        started.set()
        return out

    jobfarm.JobFarm.start = start_and_publish
    try:
        run_thread = threading.Thread(target=master.run, daemon=True)
        run_thread.start()
        assert started.wait(30)
        n = worker.worker(address["addr"])
        run_thread.join(60)
        assert not run_thread.is_alive()
    finally:
        jobfarm.JobFarm.start = orig_start
    assert n == 2  # the remote worker trained both members
    assert [e["id"] for e in master.results] == [0, 1]


def test_ensemble_train_ratio_reaches_three_arg_factories(tmp_path):
    seen = []

    def factory3(member, seed, train_ratio):
        seen.append((member, train_ratio))
        return _member_factory(member, seed)

    EnsembleTrainer(factory3, size=2, directory=str(tmp_path),
                    train_ratio=0.5, device=CPU).run()
    assert seen == [(0, 0.5), (1, 0.5)]
    # a **kwargs-only third "parameter" is not fed a positional
    kw_calls = []

    def factory_kw(member, seed, **opts):
        kw_calls.append(opts)
        return _member_factory(member, seed)

    EnsembleTrainer(factory_kw, size=1, directory=str(tmp_path),
                    train_ratio=0.5, device=CPU).run()
    assert kw_calls == [{}]


def test_ensemble_train_and_test(tmp_path):
    trainer = EnsembleTrainer(_member_factory, size=3,
                              directory=str(tmp_path), device=CPU)
    results_path = trainer.run()
    assert len(trainer.results) == 3
    tester = EnsembleTester(results_path, device=CPU)
    x, labels = _blobs("enstest", 77, 64, 128)
    err = tester.error_rate(x, labels)
    assert err < 10.0, "ensemble error %.1f%%" % err


# -- against the JAX package --------------------------------------------------


@pytest.fixture(scope="module")
def jax_members(tmp_path_factory):
    """Three members trained by the JAX package, in process."""
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.ensemble import EnsembleTrainer as JaxTrainer
    directory = str(tmp_path_factory.mktemp("jax_ensemble"))
    trainer = JaxTrainer(_jax_seeded_factory, size=3, directory=directory,
                         device=JaxDevice(backend="cpu"))
    return trainer.run()


def test_port_tester_reads_jax_members(jax_members):
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.ensemble import EnsembleTester as JaxTester
    x, labels = _blobs("xread", 80, 0, 96)
    want = JaxTester(jax_members,
                     device=JaxDevice(backend="cpu")).predict(x)
    ours = EnsembleTester(jax_members, device=CPU)
    got = ours.predict(x)
    assert got.shape == want.shape == (96, 4)
    assert numpy.abs(got - want).max() <= 1e-5
    farmed = EnsembleTester(jax_members, device=CPU, farm_slaves=2)
    assert farmed.predict(x).tobytes() == got.tobytes()
    assert ours.error_rate(x, labels) == \
        100.0 * float((want.argmax(1) != labels).sum()) / len(labels)


def test_port_members_equal_jax_members(jax_members, tmp_path):
    trainer = EnsembleTrainer(_seeded_factory, size=3,
                              directory=str(tmp_path), device=CPU)
    with open(trainer.run()) as fin:
        ours = json.load(fin)["models"]
    with open(jax_members) as fin:
        theirs = json.load(fin)["models"]
    assert [sorted(e) for e in ours] == [sorted(e) for e in theirs] == \
        [["EvaluationFitness", "id", "metrics", "seed", "snapshot"]] * 3
    for mine, jax in zip(ours, theirs):
        assert (mine["id"], mine["seed"]) == (jax["id"], jax["seed"])
        assert mine["metrics"] == jax["metrics"]
        assert mine["EvaluationFitness"] == jax["EvaluationFitness"]
        with open(jax["snapshot"], "rb") as fin:
            jsw = pickle.load(fin)
        with open(mine["snapshot"], "rb") as fin:
            sw = pickle.load(fin)
        for got, want in zip(_weights(sw), _weights(jsw)):
            assert _max_rel(got, want) < EPOCH_TOL


# -- the port's own ----------------------------------------------------------


def test_fused_member_pickle_holds_its_trained_weights(tmp_path):
    """A fused member's trained state lives in its step; the pickle
    holds that state, not the initial weights."""
    from veles_tpu_torch.convert import state_to_numpy
    live = {}

    def factory(member, seed):
        sw = _seeded_factory(member, seed)
        sw.fuse(pipeline=False)
        live["sw"] = sw
        return sw

    trainer = EnsembleTrainer(factory, size=1, directory=str(tmp_path),
                              device=CPU)
    trainer.run()
    trained = state_to_numpy(live["sw"].fused_trainer._state_)
    with open(trainer.results[0]["snapshot"], "rb") as fin:
        sw = pickle.load(fin)
    initial = _seeded_factory(0, 0)
    initial.initialize(device=CPU)
    for i, fwd in enumerate(sw.forwards):
        fwd.weights.map_read()
        assert fwd.weights.mem.tobytes() == \
            trained[i]["weights"].tobytes()
        initial.forwards[i].weights.map_read()
        assert fwd.weights.mem.tobytes() != \
            initial.forwards[i].weights.mem.tobytes()


@pytest.mark.parametrize("entry", ["member", "farmed", "worker"])
def test_ensembles_take_the_card_unless_asked(entry, tmp_path, monkeypatch):
    from veles_tpu_torch.config import root
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VELES_BACKEND", raising=False)
    monkeypatch.setitem(root.common.engine.__dict__, "backend", "cuda")
    trainer = EnsembleTrainer(_member_factory, size=1,
                              directory=str(tmp_path),
                              farm_slaves=1 if entry == "farmed" else 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "worker":
            trainer.worker("127.0.0.1:1")
        else:
            trainer.run()
    assert not os.path.exists(trainer.results_path)
