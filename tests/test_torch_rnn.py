"""The port's recurrent layers (veles_tpu_torch/models/rnn.py) against
the JAX package's (veles_tpu/models/rnn.py), on the CPU.

- ``RNN.apply`` and ``LSTM.apply`` on seeded (B, T, F) inputs, in both
  ``return_sequences`` modes, within 1e-6 of JAX's ``lax.scan``;
- the GD units' backward (autograd through ``apply``, JAX's
  ``jax.vjp``): new weights, bias and momentum state and err_input
  within max-rel 1e-5, the bias unregularized, a non-finite gradient
  skipping the step;
- ``StandardWorkflow`` builds ``rnn`` and ``lstm`` with the weights
  drawn bit for bit as JAX's; 3 train minibatches per unit, each from
  one state, agree with JAX's per-unit steps (err_output within 1e-5,
  every leaf within max-rel 1e-4); 3 chained fused steps agree with
  JAX's fused trainer (loss within 1e-5 rel, leaves within 1e-4); the
  port's per-unit and fused steps agree with each other;
- an LSTM workflow snapshot written by either package loads and trains
  on in the other within 1e-4.
"""

import gzip

import numpy
import pytest
import torch

import veles_tpu.prng as jax_prng
import veles_tpu_torch.prng as torch_prng
from veles_tpu.backends import Device as JaxDevice
from veles_tpu.dummy import DummyLauncher as JaxLauncher
from veles_tpu.models.nn_workflow import StandardWorkflow as JaxWorkflow
from veles_tpu_torch.backends import Device
from veles_tpu_torch.convert import adopt_workflow_state
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models import rnn
from veles_tpu_torch.models.nn_workflow import StandardWorkflow

from test_torch_loader import JaxArraysLoader, TorchArraysLoader
from test_torch_workflow import (assert_states_close, fused_step,
                                 jax_state, max_rel, torch_state,
                                 unit_step)

CPU = Device(backend="cpu")
SEED = 17
CLASSES = 4
HYPER = {"learning_rate": 0.05, "gradient_moment": 0.9,
         "weights_decay": 1e-4}


def _jax_rnn():
    import veles_tpu.models.rnn
    return veles_tpu.models.rnn


def _params(kind, features, hidden, seed=0, bias=True):
    gates = 4 if kind == "lstm" else 1
    rng = numpy.random.RandomState(seed)
    w = (rng.randn(features + hidden, gates * hidden) * 0.4).astype(
        numpy.float32)
    b = (rng.randn(gates * hidden) * 0.1).astype(numpy.float32) \
        if bias else None
    return w, b


def _classes(kind):
    port = {"rnn": (rnn.RNN, rnn.GDRNN), "lstm": (rnn.LSTM, rnn.GDLSTM)}
    jax_mod = _jax_rnn()
    jax = {"rnn": (jax_mod.RNN, jax_mod.GDRNN),
           "lstm": (jax_mod.LSTM, jax_mod.GDLSTM)}
    return port[kind], jax[kind]


@pytest.mark.parametrize("return_sequences", [True, False])
@pytest.mark.parametrize("kind", ["rnn", "lstm"])
def test_apply_matches_jax(kind, return_sequences):
    (fwd, _), (jfwd, _) = _classes(kind)
    x = numpy.random.RandomState(1).randn(5, 8, 6).astype(numpy.float32)
    w, b = _params(kind, 6, 7)
    want = numpy.asarray(jfwd.apply({"weights": w, "bias": b}, x,
                                    return_sequences=return_sequences))
    got = fwd.apply({"weights": torch.from_numpy(w),
                     "bias": torch.from_numpy(b)}, torch.from_numpy(x),
                    return_sequences=return_sequences)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (
        (5, 8, 7) if return_sequences else (5, 7))
    numpy.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    no_bias = fwd.apply({"weights": torch.from_numpy(w), "bias": None},
                        torch.from_numpy(x),
                        return_sequences=return_sequences)
    numpy.testing.assert_allclose(
        no_bias.numpy(),
        numpy.asarray(jfwd.apply({"weights": w, "bias": None}, x,
                                 return_sequences=return_sequences)),
        rtol=0, atol=1e-6)


def _state(kind, features, hidden, seed):
    w, b = _params(kind, features, hidden, seed=seed)
    rng = numpy.random.RandomState(seed + 1)
    return {"weights": w, "bias": b,
            # non-negative: adagrad's sum of squares
            "accum_weights": numpy.abs(rng.randn(*w.shape) * 0.01).astype(
                numpy.float32),
            "accum_bias": numpy.abs(rng.randn(*b.shape) * 0.01).astype(
                numpy.float32),
            "accum2_weights": numpy.zeros_like(w),
            "accum2_bias": numpy.zeros_like(b)}


def _hyper():
    return {"learning_rate": 0.05, "learning_rate_bias": 0.07,
            "weights_decay": 1e-3, "weights_decay_bias": 0.5,
            "l1_vs_l2": 0.25, "gradient_moment": 0.9,
            "gradient_moment_bias": 0.8, "adadelta_rho": 0.95,
            "solver_epsilon": 1e-6}


@pytest.mark.parametrize("solver", ["momentum", "adagrad"])
@pytest.mark.parametrize("return_sequences", [True, False])
@pytest.mark.parametrize("kind", ["rnn", "lstm"])
def test_gd_backward_matches_jax(kind, return_sequences, solver):
    (fwd, gd), (_, jgd) = _classes(kind)
    rng = numpy.random.RandomState(3)
    x = rng.randn(4, 6, 5).astype(numpy.float32)
    state = _state(kind, 5, 6, seed=4)
    y = fwd.apply({"weights": torch.from_numpy(state["weights"]),
                   "bias": torch.from_numpy(state["bias"])},
                  torch.from_numpy(x),
                  return_sequences=return_sequences).numpy()
    err = (rng.randn(*y.shape) * 0.1).astype(numpy.float32)
    kwargs = dict(solver=solver, include_bias=True, need_err_input=True,
                  return_sequences=return_sequences)
    want_err, want = jgd.backward(state, _hyper(), x, y, err, **kwargs)
    got_err, got = gd.backward(
        {k: torch.from_numpy(v) for k, v in state.items()}, _hyper(),
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(err),
        **kwargs)
    assert int(got["skipped"]) == int(want["skipped"]) == 0
    for key in ("weights", "bias", "accum_weights", "accum_bias",
                "accum2_weights", "accum2_bias"):
        assert max_rel(got[key].numpy(), numpy.asarray(want[key])) <= \
            1e-5, key
    assert max_rel(got_err.numpy(), numpy.asarray(want_err)) <= 1e-5
    # a non-finite gradient skips the whole step, as in JAX
    poisoned = err.copy()
    poisoned[0] = numpy.nan
    _, skipped = gd.backward(
        {k: torch.from_numpy(v) for k, v in state.items()}, _hyper(),
        torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(poisoned), **kwargs)
    assert int(skipped["skipped"]) == 1
    assert (skipped["weights"].numpy() == state["weights"]).all()


# -- the workflow -------------------------------------------------------------


def sequences(n_valid=24, n_train=72, t=6, f=5, seed=2):
    """Each class is a prototype sequence plus noise: learnable."""
    rng = numpy.random.RandomState(seed)
    protos = rng.randn(CLASSES, t, f)
    y = rng.randint(0, CLASSES, n_valid + n_train).astype(numpy.int32)
    x = (protos[y] + rng.randn(len(y), t, f) * 0.5).astype(numpy.float32)
    return x[:n_valid], y[:n_valid], x[n_valid:], y[n_valid:]


def layers(kind):
    return [{"type": kind, "hidden_size": 8, "return_sequences": False,
             **HYPER},
            {"type": "softmax", "output_sample_shape": CLASSES, **HYPER}]


def build_jax(kind, arrays, fuse=False, epochs=1):
    sw = JaxWorkflow(
        JaxLauncher(), layers=layers(kind),
        loader_factory=lambda w: JaxArraysLoader(
            w, arrays, minibatch_size=24,
            prng=jax_prng.RandomGenerator("loader", seed=1)),
        decision_config=dict(max_epochs=epochs))
    if fuse:
        sw.fuse()
    jax_prng.get().seed(SEED)
    sw.initialize(device=JaxDevice(backend="cpu"))
    return sw


def build_torch(kind, arrays, fuse=False, epochs=1):
    sw = StandardWorkflow(
        DummyLauncher(), layers=layers(kind),
        loader_factory=lambda w: TorchArraysLoader(
            w, arrays, minibatch_size=24,
            prng=torch_prng.RandomGenerator("loader", seed=1)),
        decision_config=dict(max_epochs=epochs))
    if fuse:
        sw.fuse()
    torch_prng.get().seed(SEED)
    sw.initialize(device=CPU)
    return sw


def _fused_jax_state(jsw):
    jsw.fused_trainer.sync()
    return jax_state(jsw)


@pytest.mark.parametrize("kind", ["rnn", "lstm"])
def test_workflow_builds_with_jax_weights(kind):
    arrays = sequences()
    tsw, jsw = build_torch(kind, arrays), build_jax(kind, arrays)
    assert type(tsw.forwards[0]).__name__ == kind.upper()
    assert type(tsw.gds[0]).__name__ == "GD" + kind.upper()
    for g, w in zip(torch_state(tsw), jax_state(jsw)):
        for key in w:
            if w[key] is not None:
                assert g[key].tobytes() == w[key].tobytes(), key


@pytest.mark.parametrize("kind", ["rnn", "lstm"])
def test_per_unit_steps_from_one_state_match_jax(kind):
    arrays = sequences()
    jsw, tsw = build_jax(kind, arrays), build_torch(kind, arrays)
    trained = 0
    for _ in range(4):  # the validation minibatch, then 3 train ones
        adopt_workflow_state(tsw, jax_state(jsw))
        unit_step(jsw)
        unit_step(tsw)
        assert jsw.loader.minibatch_class == tsw.loader.minibatch_class
        trained += tsw.loader.minibatch_class == 2
        assert_states_close(torch_state(tsw), jax_state(jsw), 1e-4)
        jerr = numpy.asarray(jsw.evaluator.err_output.devmem)
        terr = tsw.evaluator.err_output.devmem.numpy()
        assert max_rel(terr, jerr) <= 1e-5
        assert int(tsw.evaluator.n_err) == int(jsw.evaluator.n_err)
    assert trained == 3


@pytest.mark.parametrize("kind", ["rnn", "lstm"])
def test_fused_steps_match_jax(kind):
    arrays = sequences()
    jsw = build_jax(kind, arrays, fuse=True)
    tsw = build_torch(kind, arrays, fuse=True)
    trained = 0
    for _ in range(4):
        fused_step(jsw)
        fused_step(tsw)
        assert jsw.loader.minibatch_class == tsw.loader.minibatch_class
        if tsw.loader.minibatch_class != 2:
            continue
        trained += 1
        assert float(tsw.fused_trainer.last_loss) == pytest.approx(
            float(jsw.fused_trainer.last_loss), rel=1e-5)
        assert_states_close(torch_state(tsw), _fused_jax_state(jsw), 1e-4)
    assert trained == 3


@pytest.mark.parametrize("kind", ["rnn", "lstm"])
def test_per_unit_steps_match_fused_steps(kind):
    arrays = sequences()
    unit, fused = build_torch(kind, arrays), \
        build_torch(kind, arrays, fuse=True)
    for _ in range(4):
        adopt_workflow_state(fused, torch_state(unit))
        unit_step(unit)
        fused_step(fused)
        assert_states_close(torch_state(fused), torch_state(unit), 1e-5)
        assert int(fused.fused_trainer.n_err) == int(unit.evaluator.n_err)


# -- one snapshot format ---------------------------------------------------


_SEQ_LOADER = '''
import numpy
from {loader} import FullBatchLoader


class SeqBlobs(FullBatchLoader):
    def load_data(self):
        rng = numpy.random.RandomState(2)
        protos = rng.randn(4, 6, 5)
        y = rng.randint(0, 4, 96).astype(numpy.int32)
        x = (protos[y] + rng.randn(96, 6, 5) * 0.5).astype(numpy.float32)
        self.original_data = x
        self.original_labels = y
        self.class_lengths[0] = 0
        self.class_lengths[1] = 24
        self.class_lengths[2] = 72
'''


def _seq_workflow(package, module, epochs):
    if package == "jax":
        jax_prng.get().seed(SEED)
        sw = JaxWorkflow(
            JaxLauncher(), layers=layers("lstm"),
            loader_factory=lambda w: module.SeqBlobs(
                w, minibatch_size=24,
                prng=jax_prng.RandomGenerator("seq", seed=4)),
            decision_config=dict(max_epochs=epochs))
        sw.initialize(device=JaxDevice(backend="cpu"))
        return sw
    torch_prng.get().seed(SEED)
    sw = StandardWorkflow(
        DummyLauncher(), layers=layers("lstm"),
        loader_factory=lambda w: module.SeqBlobs(
            w, minibatch_size=24,
            prng=torch_prng.RandomGenerator("seq", seed=4)),
        decision_config=dict(max_epochs=epochs))
    sw.initialize(device=CPU)
    return sw


def _train_on(sw, epochs):
    sw.decision.max_epochs = epochs
    sw.decision.complete <<= False
    sw.run()


def test_lstm_snapshot_from_jax_restores_in_the_port(tmp_path):
    from test_torch_snapshot import (_cli_blobs, _jax_snapshotter,
                                     _model_state)
    from veles_tpu_torch.workflow import restore_workflow
    with _cli_blobs(tmp_path, "jax", "seq_blobs", _SEQ_LOADER) as module:
        jsw = _seq_workflow("jax", module, epochs=2)
        jsw.run()
        snap = _jax_snapshotter().Snapshotter(
            jsw, directory=str(tmp_path), prefix="jax", interval=1,
            time_interval=0)
        snap.initialize()
        snap.export()
        saved = _model_state(jsw)
        _train_on(jsw, 4)
    with _cli_blobs(tmp_path, "torch", "seq_blobs", _SEQ_LOADER):
        tsw = restore_workflow(snap.destination, DummyLauncher())
        assert type(tsw.forwards[0]) is rnn.LSTM
        tsw.initialize(device=CPU)
        assert max_rel_state(_model_state(tsw), saved) == 0.0
        _train_on(tsw, 4)
    assert max_rel_state(_model_state(tsw), _model_state(jsw)) <= 1e-4


def test_lstm_snapshot_from_the_port_loads_in_jax(tmp_path):
    from test_torch_snapshot import _PortToJax, _cli_blobs, _model_state
    from veles_tpu_torch.snapshotter import Snapshotter
    with _cli_blobs(tmp_path, "torch", "seq_blobs", _SEQ_LOADER) \
            as module:
        tsw = _seq_workflow("torch", module, epochs=2)
        tsw.run()
        snap = Snapshotter(tsw, directory=str(tmp_path), prefix="port",
                           interval=1, time_interval=0, compression="gz")
        snap.initialize()
        snap.export()
        saved = _model_state(tsw)
        _train_on(tsw, 4)
    with _cli_blobs(tmp_path, "jax", "seq_blobs", _SEQ_LOADER):
        with gzip.open(snap.destination) as fin:
            jsw = _PortToJax(fin).load()
        assert type(jsw.forwards[0]) is _jax_rnn().LSTM
        jsw.workflow = JaxLauncher()
        jsw.restored_from_snapshot_ = True
        jsw.initialize(device=JaxDevice(backend="cpu"))
        assert max_rel_state(_model_state(jsw), saved) == 0.0
        _train_on(jsw, 4)
    assert max_rel_state(_model_state(jsw), _model_state(tsw)) <= 1e-4


def max_rel_state(got, want):
    return max(max_rel(got[key], leaf) for key, leaf in want.items())
