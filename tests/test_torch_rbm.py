"""The port's RBM (veles_tpu_torch/models/rbm.py and
veles_tpu_torch/examples/rbm.py) against the JAX package's, on the CPU,
on the vendored digits.

- The uniforms of a CD step are JAX's bit for bit (``fold_in(key(seed),
  step)``, then ``split`` before each draw).  A sampled hidden state
  ``uniform < p`` equals JAX's except where |u - p| < 1e-6 (``p`` is a
  sigmoid that may differ in its last bit between the packages); the
  flips are counted (none at these seeds).
- One ``cd_step`` from one state and key, and 3 runs of the unit (the
  key stream through ``_step``), give W, hb and vb within max-rel 1e-5
  of JAX's and the same reconstruction error within 1e-5 rel.
- The initial weights (``prng.fill_normal``) equal the JAX unit's bit
  for bit; the counterpart of tests/test_zoo.py's
  ``test_rbm_reduces_reconstruction_error``; the example's holdout error
  under 0.7 x the untrained one at 25 epochs (``test_rbm_example_
  workflow``).
"""

import pickle

import numpy
import pytest
import torch

from tests.torch_imports import jax_example
from veles_tpu_torch import threefry
from veles_tpu_torch.backends import Device
from veles_tpu_torch.datasets import digits_arrays
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.rbm import RBM
from veles_tpu_torch.prng import RandomGenerator

CPU = Device("cpu")
FLIP_MARGIN = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the runs' operations are small, one thread
    takes them about as fast as eight, and the other cores stay with
    the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _max_rel(got, want):
    got = numpy.asarray(got, numpy.float64)
    want = numpy.asarray(want, numpy.float64)
    return float(numpy.abs(got - want).max() /
                 max(numpy.abs(want).max(), 1e-30))


def _rbms(x, hidden=64, seed=13, lr=0.1):
    """The port's and JAX's RBM over ``x``, initialized."""
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
    from veles_tpu.memory import Array as JaxArray
    from veles_tpu.models.rbm import RBM as JaxRBM
    from veles_tpu.prng import RandomGenerator as JaxGenerator
    jr = JaxRBM(JaxWorkflow(), hidden_size=hidden, learning_rate=lr,
                prng=JaxGenerator("rbm", seed=seed))
    jr.input = JaxArray(x)
    jr.initialize(device=JaxDevice(backend="cpu"))
    pr = RBM(DummyWorkflow(), hidden_size=hidden, learning_rate=lr,
             prng=RandomGenerator("rbm", seed=seed))
    pr.input = Array(x)
    pr.initialize(device=CPU)
    return jr, pr


def _host(arr):
    arr.map_read()
    return numpy.array(arr.mem)


def _trained_state(x, steps=10):
    """(W, hb, vb) after ``steps`` port steps from the example's start:
    hidden probabilities spread away from 0.5."""
    _, pr = _rbms(x)
    for _ in range(steps):
        pr.run()
    return tuple(_host(a) for a in (pr.weights, pr.hidden_bias,
                                    pr.visible_bias))


@pytest.mark.parametrize("source", ["initial", "trained"])
def test_draws_equal_jax_up_to_near_ties(source):
    import jax
    import jax.numpy as jnp
    x = digits_arrays(360, 4)[0]
    jr, _ = _rbms(x)
    if source == "initial":
        W, hb = numpy.array(jr.weights.mem), numpy.array(jr.hidden_bias.mem)
    else:
        W, hb, _ = _trained_state(x)
    jkey = jax.random.fold_in(jax.random.PRNGKey(13), 3)
    pkey = threefry.fold_in(threefry.key(13), 3)
    flips = 0
    for draw in range(3):
        jkey, jsub = jax.random.split(jkey)
        pkey, psub = threefry.split(pkey)
        ju = numpy.asarray(jax.random.uniform(jsub, (len(x), W.shape[1])))
        pu = threefry.uniform(psub, (len(x), W.shape[1])).numpy()
        assert pu.tobytes() == ju.tobytes(), draw
        jp = numpy.asarray(jax.nn.sigmoid(
            jnp.dot(jnp.asarray(x), jnp.asarray(W),
                    preferred_element_type=jnp.float32) + hb))
        pp = torch.sigmoid(torch.from_numpy(x) @ torch.from_numpy(W) +
                           torch.from_numpy(hb)).numpy()
        differ = (pu < pp) != (ju < jp)
        assert (numpy.abs(ju - jp)[differ] < FLIP_MARGIN).all()
        flips += int(differ.sum())
    assert flips == 0, flips


@pytest.mark.parametrize("source", ["initial", "trained"])
def test_cd_step_matches_jax(source):
    import jax
    import jax.numpy as jnp
    from veles_tpu.models.rbm import RBM as JaxRBM
    x = digits_arrays(360, 4)[0]
    jr, _ = _rbms(x)
    if source == "initial":
        state = tuple(numpy.array(a.mem) for a in (
            jr.weights, jr.hidden_bias, jr.visible_bias))
    else:
        state = _trained_state(x)
    want = JaxRBM.cd_step(jax.random.fold_in(jax.random.PRNGKey(13), 11),
                          *(jnp.asarray(a) for a in state), jnp.asarray(x),
                          numpy.float32(0.1), 1)
    got = RBM.cd_step(threefry.fold_in(threefry.key(13), 11),
                      *(torch.from_numpy(a) for a in state),
                      torch.from_numpy(x), 0.1, 1)
    for name, g, w in zip(("W", "hb", "vb", "err"), got, want):
        assert _max_rel(g.numpy(), numpy.asarray(w)) <= 1e-5, name


def test_three_unit_runs_match_jax():
    x = digits_arrays(360, 4)[0]
    jr, pr = _rbms(x)
    for name in ("weights", "hidden_bias", "visible_bias"):
        assert _host(getattr(pr, name)).tobytes() == numpy.asarray(
            getattr(jr, name).mem).tobytes(), name
    for step in range(3):
        jr.run()
        pr.run()
        assert pr._step == jr._step == step + 1
        for name in ("weights", "hidden_bias", "visible_bias"):
            assert _max_rel(_host(getattr(pr, name)),
                            getattr(jr, name).mem) <= 1e-5, (step, name)
        assert abs(pr.reconstruction_error - jr.reconstruction_error) <= \
            1e-5 * jr.reconstruction_error
    held = digits_arrays(360, 4)[2]
    assert abs(pr.reconstruct_error(held) - jr.reconstruct_error(held)) <= \
        1e-5 * jr.reconstruct_error(held)


def test_step_counter_is_the_rng_state():
    """A pickled unit resumes the key stream: its next step equals the
    uninterrupted run's bit for bit."""
    x = digits_arrays(360, 4)[0][:200]
    _, a = _rbms(x, hidden=16)
    _, b = _rbms(x, hidden=16)
    for _ in range(2):
        a.run()
        b.run()
    restored = pickle.loads(pickle.dumps(b))
    assert restored._step == 2
    assert restored.reconstruction_error == b.reconstruction_error
    restored.input = Array(x)
    restored.initialize(device=CPU)
    a.run()
    restored.run()
    for name in ("weights", "hidden_bias", "visible_bias"):
        assert _host(getattr(a, name)).tobytes() == \
            _host(getattr(restored, name)).tobytes(), name


def test_rbm_reduces_reconstruction_error():
    wf = DummyWorkflow()
    rng = numpy.random.RandomState(8)
    patterns = (rng.rand(4, 20) > 0.5).astype(numpy.float32)
    data = patterns[rng.randint(0, 4, 128)]
    rbm = RBM(wf, hidden_size=12, learning_rate=0.2,
              prng=RandomGenerator("rbm", seed=6))
    rbm.input = Array(data)
    rbm.initialize(device=CPU)
    errors = []
    for _ in range(200):
        rbm.run()
        errors.append(rbm.reconstruction_error)
    assert errors[-1] < errors[0] * 0.6, (errors[0], errors[-1])


def test_rbm_example_workflow():
    """The example pretrains on the digits through the graph engine's
    loop and reconstructs held-out digits well below the untrained
    error; its initial weights equal the JAX example's."""
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu_torch.config import root
    from veles_tpu_torch.examples import rbm
    from veles_tpu_torch.launcher import Launcher
    jax_rbm = jax_example("rbm")
    saved = root.rbm.epochs
    root.rbm.epochs = 25  # the JAX test's
    try:
        launcher = Launcher()
        wf = rbm.RBMWorkflow(launcher)
        launcher.initialize(device="cpu")
        jlauncher = JaxLauncher()
        jwf = jax_rbm.RBMWorkflow(jlauncher)
        jlauncher.initialize(device="cpu")
        assert _host(wf.rbm.weights).tobytes() == numpy.asarray(
            jwf.rbm.weights.mem).tobytes()
        untrained = wf.rbm.reconstruct_error(wf.valid_x)
        launcher.run()
        assert wf.counter.passes == 25 and wf.rbm._step == 25
        assert wf.holdout_error is not None
        assert wf.holdout_error < untrained * 0.7, (untrained,
                                                    wf.holdout_error)
    finally:
        root.rbm.epochs = saved
