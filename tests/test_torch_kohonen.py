"""The port's self-organising map (veles_tpu_torch/models/kohonen.py and
veles_tpu_torch/examples/kohonen.py) against the JAX package's, on the
CPU, on the vendored digits.

- The winners equal ``KohonenForward.winners`` on seeded and on trained
  weights, except at a near-tie: a different winner only where JAX's two
  smallest distances are within 1e-5 relative of each other (an argmin
  over values that differ by rounding).
- The trainer's initial weights (``prng.fill``) equal the JAX unit's bit
  for bit, and 5 runs of the unit stay within max-rel 1e-5 of JAX's.
- The counterpart of tests/test_zoo.py's ``test_kohonen_organizes``, and
  the example's purity above 0.5 at 40 epochs (``test_kohonen_example_
  workflow``); the example's initial weights equal the JAX example's.
"""


import numpy
import pytest
import torch

from tests.torch_imports import jax_example
from veles_tpu_torch.backends import Device
from veles_tpu_torch.datasets import digits_arrays
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.kohonen import (KohonenForward, KohonenTrainer,
                                            _grid_coords)
from veles_tpu_torch.prng import RandomGenerator

CPU = Device("cpu")
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the runs' operations are small, one thread
    takes them about as fast as eight, and the other cores stay with
    the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_example():
    """The JAX package's examples/kohonen.py."""
    return jax_example("kohonen")


def _jax_units():
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
    from veles_tpu.memory import Array as JaxArray
    from veles_tpu.models import kohonen
    from veles_tpu.prng import RandomGenerator as JaxGenerator
    return (JaxDevice(backend="cpu"), JaxWorkflow(), JaxArray, kohonen,
            JaxGenerator)


def _jax_distances(weights, x):
    """JAX's |w|^2 - 2 x.w, the values its argmin compares."""
    import jax.numpy as jnp
    w, x = jnp.asarray(weights), jnp.asarray(x)
    cross = jnp.dot(x, w.T, preferred_element_type=jnp.float32)
    return numpy.asarray(jnp.sum(w * w, axis=1) - 2.0 * cross)


def assert_winners_match(got, weights, x):
    """``got`` equals JAX's winners, or differs only at a near-tie."""
    from veles_tpu.models.kohonen import KohonenForward as JaxForward
    want = numpy.asarray(JaxForward.winners(weights, x))
    differ = numpy.nonzero(got != want)[0]
    if len(differ):
        dist = _jax_distances(weights, x)[differ].astype(numpy.float64)
        two = numpy.sort(dist, axis=1)[:, :2]
        gap = numpy.abs(two[:, 1] - two[:, 0]) / numpy.abs(two).max(axis=1)
        assert (gap <= NEAR_TIE).all(), (differ, gap)
    return len(differ)


def _trainers(x, seed=9, shape=(8, 8)):
    """The port's and JAX's KohonenTrainer over ``x``, initialized."""
    jdev, jwf, JaxArray, kohonen, JaxGenerator = _jax_units()
    jt = kohonen.KohonenTrainer(jwf, shape=shape, alpha=0.3,
                                prng=JaxGenerator("kohonen", seed=seed))
    jt.input = JaxArray(x)
    jt.initialize(device=jdev)
    pt = KohonenTrainer(DummyWorkflow(), shape=shape, alpha=0.3,
                        prng=RandomGenerator("kohonen", seed=seed))
    pt.input = Array(x)
    pt.initialize(device=CPU)
    return jt, pt


def test_grid_coords_equal_jax():
    from veles_tpu.models.kohonen import _grid_coords as jax_coords
    for rows, cols in ((8, 8), (3, 5), (1, 4)):
        assert _grid_coords(rows, cols).numpy().tobytes() == \
            numpy.asarray(jax_coords(rows, cols)).tobytes()


@pytest.mark.parametrize("source", ["seeded", "trained"])
def test_winners_match_jax(source):
    train_x, _, valid_x, _ = digits_arrays(360, 4)
    jt, _ = _trainers(train_x)
    weights = numpy.array(jt.weights.mem)
    if source == "trained":
        for _ in range(10):
            jt.run()
        jt.weights.map_read()
        weights = numpy.array(jt.weights.mem)
    fwd = KohonenForward(DummyWorkflow(), shape=(8, 8))
    fwd.input = Array(numpy.concatenate([train_x, valid_x]))
    fwd.weights = Array(weights)
    fwd.initialize(device=CPU)
    fwd.run()
    fwd.output.map_read()
    got = numpy.asarray(fwd.output.mem)
    assert got.dtype == numpy.int32 and got.shape == (1797,)
    assert_winners_match(got, weights, fwd.input.mem)


def test_five_trainer_runs_match_jax():
    train_x = digits_arrays(360, 4)[0]
    jt, pt = _trainers(train_x)
    pt.weights.map_read()
    assert pt.weights.mem.tobytes() == numpy.asarray(
        jt.weights.mem).tobytes()
    for run in range(5):
        jt.run()
        pt.run()
        assert pt.time == jt.time == run + 1
        pt.weights.map_read()
        got = pt.weights.mem.astype(numpy.float64)
        want = numpy.asarray(jt.weights.mem, numpy.float64)
        rel = numpy.abs(got - want).max() / numpy.abs(want).max()
        assert rel <= 1e-5, (run, rel)


def test_trainer_keeps_weights_on_its_device():
    """A run hands the weights Array a new tensor on the unit's device
    and copies nothing back to the host."""
    from veles_tpu_torch.memory import _DEVICE_DIRTY
    train_x = digits_arrays(360, 4)[0]
    _, pt = _trainers(train_x)
    before = pt.weights.devmem
    pt.run()
    assert pt.weights._state_ == _DEVICE_DIRTY
    after = pt.weights.devmem
    assert after is not before and after.device == CPU.torch_device


def test_kohonen_organizes():
    wf = DummyWorkflow()
    rng = numpy.random.RandomState(6)
    centers = numpy.array([[0, 0], [1, 1], [0, 1], [1, 0]],
                          numpy.float32)
    data = numpy.concatenate([
        centers[i] + rng.randn(50, 2).astype(numpy.float32) * 0.05
        for i in range(4)])
    trainer = KohonenTrainer(wf, shape=(4, 4),
                             prng=RandomGenerator("koh", seed=4))
    trainer.input = Array(data)
    trainer.initialize(device=CPU)
    for _ in range(40):
        trainer.run()
    fwd = KohonenForward(wf, shape=(4, 4))
    fwd.input = Array(data)
    fwd.weights = trainer.weights
    fwd.initialize(device=CPU)
    fwd.run()
    fwd.output.map_read()
    winners = fwd.output.mem
    # each cluster maps to a (mostly) distinct dominant neuron
    dominant = set()
    for i in range(4):
        counts = numpy.bincount(winners[i * 50:(i + 1) * 50],
                                minlength=16)
        dominant.add(int(counts.argmax()))
    assert len(dominant) >= 3


def test_purity_equals_jax():
    from veles_tpu_torch.examples.kohonen import purity
    jax_purity = _jax_example().purity
    rng = numpy.random.RandomState(1)
    winners = rng.randint(0, 64, 360)
    labels = rng.randint(0, 10, 360).astype(numpy.int64)
    assert purity(winners, labels, 64) == jax_purity(winners, labels, 64)


def test_kohonen_example_workflow():
    """The example through the graph engine's loop (repeater -> trainer
    -> counter gate) on the digits: initial weights equal the JAX
    example's, purity well above the 10 % of chance."""
    from veles_tpu.config import root as jax_root
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu_torch.config import root
    from veles_tpu_torch.examples import kohonen
    from veles_tpu_torch.launcher import Launcher
    jax_kohonen = _jax_example()
    saved = root.kohonen.epochs
    root.kohonen.epochs = 40  # the JAX test's; purity ~70 %
    try:
        launcher = Launcher()
        wf = kohonen.KohonenWorkflow(launcher)
        launcher.initialize(device="cpu")
        jlauncher = JaxLauncher()
        jwf = jax_kohonen.KohonenWorkflow(jlauncher)
        jlauncher.initialize(device="cpu")
        wf.trainer.weights.map_read()
        assert wf.trainer.weights.mem.tobytes() == numpy.asarray(
            jwf.trainer.weights.mem).tobytes()
        assert jax_root.kohonen.epochs == 100
        launcher.run()
        assert wf.counter.passes == 40
        assert wf.purity is not None and wf.purity > 0.5, wf.purity
    finally:
        root.kohonen.epochs = saved
