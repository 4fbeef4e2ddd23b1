"""The port's StandardWorkflow (veles_tpu_torch/models: nn_units,
all2all, gd, evaluator, decision, nn_workflow, fused; compiler's
workflow_plan / extract_state / adopt_state; convert's
adopt_workflow_state) against the JAX package's, on the CPU.

Both packages build the same 2-layer softmax MLP over the same seeded
data, the JAX one per unit on its CPU device:

- the initial weights are bit-equal from the same seeds;
- each step (one minibatch through loader, forwards, evaluator,
  decision and the GD chain), started from one state, agrees on every
  leaf within max-rel 1e-5 (the backwards sum in other orders);
- one chained epoch agrees within 1e-4, and the per-class error counts
  within 1 sample;
- the port's graph with a MeanDispNormalizer unit in front of the first
  layer (uint8 data) equals its graph over host-normalized float32 data
  bit for bit;
- the port's per-unit steps and fused steps agree within 1e-5 (the GD
  units differentiate through the outputs, the fused step through
  autograd);
- auto-fuse on a CUDA device, the opt-out, none on the CPU;
- the conv, pooling, dropout and transformer layers draw the JAX
  weights bit for bit and train fused (a convnet's 3 chained fused
  steps within 1e-4 of JAX's; the dropout masks follow the trainer's
  seed);
- every layer family runs per unit: 3 chained per-unit steps of a
  convnet, a transformer, a dropout MLP, a pooling mix, a chain of
  standalone activations and the conv autoencoder (conv, avg pooling,
  depooling, deconv; mse) agree with the JAX package's per-unit run
  within 1e-4 (JAX on its Pallas backward in interpret mode), and, where
  there is no dropout, with the port's fused run within 1e-4;
- a per-unit convnet-with-dropout snapshot written by the port loads
  and trains on in the JAX package, and the other way round (1e-4);
- an InputJoiner DAG's forward agrees with JAX's within 1e-6;
- the mse path (FullBatchLoaderMSE, EvaluatorMSE, DecisionMSE) agrees
  with JAX's over one epoch;
- the real-digits anchor (the JAX package's ``digits_arrays``) reaches
  a best validation error at or under 2.0 % (JAX: 1.389 %,
  QUALITY.json)."""

import numpy
import pytest
import torch

import veles_tpu.compiler as jax_compiler
import veles_tpu.loader.fullbatch as jax_fullbatch
import veles_tpu.prng as jax_prng
import veles_tpu_torch.loader.fullbatch as torch_fullbatch
import veles_tpu_torch.prng as torch_prng
from veles_tpu.backends import Device as JaxDevice
from veles_tpu.dummy import DummyLauncher as JaxLauncher
from veles_tpu.models.nn_workflow import StandardWorkflow as JaxWorkflow
from veles_tpu_torch.backends import Device
from veles_tpu_torch.compiler import extract_state, workflow_plan
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import adopt_workflow_state, state_to_numpy
from veles_tpu_torch.dummy import DummyLauncher, DummyUnit, DummyWorkflow
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.normalization import MeanDispersionNormalizer
from veles_tpu_torch.service_units import InputJoiner, MeanDispNormalizer

from test_torch_loader import (JaxArraysLoader, TorchArraysLoader,
                               loader_class)

CPU = Device(backend="cpu")
SEED = 11
CLASSES = 4




def blobs(n_valid=30, n_train=85, features=12, dtype=numpy.float32,
          seed=2):
    """One prototype per class plus noise: learnable.  uint8 pixels
    (0..255) when asked, else the same pixels scaled to [0, 1] (raw
    0..255 inputs saturate the tanh layer, whose derivative through its
    output then amplifies rounding differences step after step)."""
    rng = numpy.random.RandomState(seed)
    protos = rng.rand(CLASSES, features) * 160 + 40
    y = rng.randint(0, CLASSES, n_valid + n_train).astype(numpy.int32)
    x = numpy.clip(protos[y] + rng.randn(len(y), features) * 30, 0, 255)
    x = x.round().astype(numpy.uint8)
    if dtype != numpy.uint8:
        x = (x / numpy.float32(255)).astype(dtype)
    return x[:n_valid], y[:n_valid], x[n_valid:], y[n_valid:]


def layers(hidden=16, lr=0.1):
    hyper = {"learning_rate": lr, "gradient_moment": 0.9,
             "weights_decay": 5e-5}
    return [dict(type="all2all_tanh", output_sample_shape=hidden, **hyper),
            dict(type="softmax", output_sample_shape=CLASSES, **hyper)]


def build_jax(arrays, batch=20, epochs=1, **loader_kwargs):
    sw = JaxWorkflow(
        JaxLauncher(), layers=layers(),
        loader_factory=lambda w: JaxArraysLoader(
            w, arrays, minibatch_size=batch,
            prng=jax_prng.RandomGenerator("loader", seed=1),
            **loader_kwargs),
        decision_config=dict(max_epochs=epochs))
    jax_prng.get().seed(SEED)
    sw.initialize(device=JaxDevice(backend="cpu"))
    return sw


def build_torch(arrays, batch=20, epochs=1, device=CPU, fuse=False,
                hidden=16, lr=0.1, initialize=True, **loader_kwargs):
    sw = StandardWorkflow(
        DummyLauncher(), layers=layers(hidden, lr),
        loader_factory=lambda w: TorchArraysLoader(
            w, arrays, minibatch_size=batch,
            prng=torch_prng.RandomGenerator("loader", seed=1),
            **loader_kwargs),
        decision_config=dict(max_epochs=epochs))
    if fuse:
        sw.fuse()
    if initialize:
        torch_prng.get().seed(SEED)
        sw.initialize(device=device)
    return sw


def jax_state(sw):
    return [{k: None if v is None else numpy.asarray(v)
             for k, v in entry.items()}
            for entry in jax_compiler.extract_state(sw)]


def torch_state(sw):
    return state_to_numpy(extract_state(sw))


def max_rel(got, want):
    got = numpy.asarray(got, numpy.float64)
    want = numpy.asarray(want, numpy.float64)
    return float(numpy.abs(got - want).max() /
                 max(numpy.abs(want).max(), 1e-30))


def assert_states_close(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            if w[key] is None:
                assert g[key] is None, (i, key)
                continue
            rel = max_rel(g[key], w[key])
            assert rel <= tol, (i, key, rel)


def unit_step(sw):
    """One minibatch through the per-unit chain, in the order the
    workflow's worklist runs it (the GD chain last layer first, skipped
    on evaluation minibatches)."""
    sw.loader.run()
    for fwd in sw.forwards:
        fwd.run()
    sw.evaluator.run()
    sw.decision.run()
    if not bool(sw.decision.gd_skip):
        for gd in reversed(sw.gds):
            gd.run()


def fused_step(sw):
    sw.loader.run()
    sw.fused_trainer.run()
    sw.decision.run()


def epoch_errors(sw):
    """Wrap the decision's epoch end to record each epoch's error
    counts (validation, train)."""
    record = []
    dec = sw.decision
    inner = dec._on_epoch_ended

    def hook():
        record.append(tuple(
            None if dec.epoch_metrics[c] is None else
            round(dec.epoch_metrics[c] * dec.class_lengths[c] / 100.0)
            for c in (1, 2)))
        inner()
    dec._on_epoch_ended = hook
    return record


def test_initial_weights_bit_equal():
    arrays = blobs()
    got, want = torch_state(build_torch(arrays)), jax_state(build_jax(arrays))
    for g, w in zip(got, want):
        for key in w:
            if w[key] is None:
                assert g[key] is None
            else:
                assert g[key].dtype == w[key].dtype
                assert g[key].tobytes() == w[key].tobytes(), key


def test_workflow_plan_matches_jax():
    arrays = blobs()
    got = workflow_plan(build_torch(arrays))
    want = jax_compiler.workflow_plan(build_jax(arrays))
    for g, w in zip(got, want):
        assert g.forward_cls.MAPPING == w.forward_cls.MAPPING
        assert (g.solver, g.include_bias) == (w.solver, w.include_bias)
        assert g.hyper_full() == w.hyper_full()


def test_each_step_from_one_state_matches_jax():
    arrays = blobs()
    jsw, tsw = build_jax(arrays), build_torch(arrays)
    # validation (2), then train steps
    for step in range(8):
        adopt_workflow_state(tsw, jax_state(jsw))
        unit_step(jsw)
        unit_step(tsw)
        assert jsw.loader.minibatch_class == tsw.loader.minibatch_class
        assert_states_close(torch_state(tsw), jax_state(jsw), 1e-5)
        jerr = numpy.asarray(jsw.evaluator.err_output.devmem)
        terr = tsw.evaluator.err_output.devmem.numpy()
        assert max_rel(terr, jerr) <= 1e-5, step
        assert int(tsw.evaluator.n_err) == int(jsw.evaluator.n_err)


def test_chained_epochs_match_jax():
    arrays = blobs()
    jsw = build_jax(arrays, epochs=3)
    tsw = build_torch(arrays, epochs=3)
    jerrs, terrs = epoch_errors(jsw), epoch_errors(tsw)
    jsw.run()
    tsw.run()
    # an epoch ends at each validation class end: epoch 0's precedes
    # any training
    assert len(terrs) == len(jerrs) == 4
    for (tv, tt), (jv, jt) in zip(terrs, jerrs):
        assert abs(tv - jv) <= 1
        assert tt is None or abs(tt - jt) <= 1
    assert tsw.loader.epoch_number == jsw.loader.epoch_number
    assert_states_close(torch_state(tsw), jax_state(jsw), 1e-4)


def test_chained_epoch_within_1e4_of_jax():
    arrays = blobs(n_valid=40, n_train=160)
    jsw = build_jax(arrays, epochs=1)
    tsw = build_torch(arrays, epochs=1)
    jsw.run()
    tsw.run()
    assert tsw.decision.epoch_metrics[1] == pytest.approx(
        jsw.decision.epoch_metrics[1], abs=100.0 / 40 + 1e-9)
    assert_states_close(torch_state(tsw), jax_state(jsw), 1e-4)


def normalizer_fronted(arrays_u8, stats, epochs):
    """The per-unit graph over uint8 minibatches with a
    MeanDispNormalizer relinked in front of forwards[0], wired through
    the public link_from / link_attrs."""
    sw = build_torch(arrays_u8, epochs=epochs, dtype=numpy.uint8,
                     initialize=False)
    norm = MeanDispNormalizer(sw, name="normalizer")
    norm.link_attrs(sw.loader, ("input", "minibatch_data"))
    norm.mean = stats.mean
    norm.rdisp = stats.rdisp
    first = sw.forwards[0]
    first.unlink_from(sw.loader)
    norm.link_from(sw.loader)
    first.link_from(norm)
    first.link_attrs(norm, ("input", "output"))
    torch_prng.get().seed(SEED)
    sw.initialize(device=CPU)
    return sw, norm


def test_normalizer_unit_equals_host_normalization():
    arrays_u8 = blobs(dtype=numpy.uint8)
    arrays_f32 = tuple(a.astype(numpy.float32) if a.dtype == numpy.uint8
                       else a for a in arrays_u8)    # 0..255, as floats
    stats = MeanDispersionNormalizer()
    stats.analyze(arrays_u8[2])       # the train class
    fronted, norm = normalizer_fronted(arrays_u8, stats, epochs=2)
    host = build_torch(arrays_f32, epochs=2,
                       normalization_type="mean_disp")
    ferrs, herrs = epoch_errors(fronted), epoch_errors(host)
    fronted.run()
    host.run()
    assert norm.run_calls == host.loader.run_calls > 0
    assert ferrs == herrs
    for g, w in zip(torch_state(fronted), torch_state(host)):
        for key in w:
            if w[key] is not None:
                assert g[key].tobytes() == w[key].tobytes(), key


def test_per_unit_steps_match_fused_steps():
    arrays = blobs()
    unit = build_torch(arrays)
    fused = build_torch(arrays, fuse=True)
    assert fused.fused_trainer is not None
    for step in range(8):
        adopt_workflow_state(fused, torch_state(unit))
        unit_step(unit)
        fused_step(fused)
        assert_states_close(torch_state(fused), torch_state(unit), 1e-5)
        assert int(fused.fused_trainer.n_err) == int(unit.evaluator.n_err)


def test_fused_workflow_trains_and_keeps_units_current():
    arrays = blobs(n_valid=40, n_train=160)
    sw = build_torch(arrays, epochs=4, fuse=True)
    start = torch_state(sw)
    sw.run()
    assert bool(sw.decision.complete)
    assert sw.forwards[0].run_calls == 0
    assert sw.fused_trainer.run_calls > 0
    assert sw.decision.best_metric < 100.0 * (1 - 1.0 / CLASSES)
    # the units' Arrays hold the trained state
    assert max_rel(torch_state(sw)[0]["weights"], start[0]["weights"]) > 0


def test_auto_fuse_on_cuda_device():
    """A device that is a CUDA card fuses at initialize (claimed here by
    a CPU device, as the JAX package's test claims a TPU)."""
    device = Device(backend="cpu")
    device.backend = "cuda"
    sw = build_torch(blobs(), epochs=2, device=device)
    assert sw.fused_trainer is not None
    sw.run()
    assert bool(sw.decision.complete)
    assert sw.fused_trainer.run_calls > 0
    assert sw.forwards[0].run_calls == 0


def test_auto_fuse_opt_out():
    device = Device(backend="cpu")
    device.backend = "cuda"
    root.common.engine.auto_fuse = False
    try:
        sw = build_torch(blobs(), epochs=2, device=device)
    finally:
        root.common.engine.auto_fuse = True
    assert getattr(sw, "fused_trainer", None) is None
    sw.run()
    assert sw.forwards[0].run_calls > 0


def test_no_auto_fuse_on_cpu():
    sw = build_torch(blobs(), epochs=2)
    assert getattr(sw, "fused_trainer", None) is None
    sw.run()
    assert sw.forwards[0].run_calls > 0


def test_default_device_is_the_card():
    """initialize() with no device asks for Device(), the card: without
    one it raises instead of running on the CPU."""
    sw = build_torch(blobs(), initialize=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sw.initialize()


CONVNET = [
    {"type": "conv_str", "n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "conv_tanh", "n_kernels": 3, "kx": 3, "ky": 2,
     "sliding": (1, 2), "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "softmax", "output_sample_shape": CLASSES,
     "learning_rate": 0.05, "gradient_moment": 0.9}]
TRANSFORMER = [
    {"type": "transformer", "heads": 2, "hidden": 12,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "layer_norm", "learning_rate": 0.05},
    {"type": "softmax", "output_sample_shape": CLASSES,
     "learning_rate": 0.05, "gradient_moment": 0.9}]


def _build_pair(specs, sample_shape, fuse, epochs=1, loss="softmax",
                packages=("jax", "torch")):
    """The same spec list over the same images in both packages (or
    those named), fused or not, initialized on each package's CPU
    device.  ``loss="mse"`` feeds the images as their own targets."""
    arrays = blobs(features=int(numpy.prod(sample_shape)))
    arrays = tuple(a.reshape((len(a),) + sample_shape) if a.ndim == 2
                   else a for a in arrays)
    out = []
    for package in packages:
        if package == "jax":
            workflow, launcher, rng = JaxWorkflow, JaxLauncher, jax_prng
            loader = JaxArraysLoader if loss == "softmax" else \
                mse_loader_class(jax_fullbatch.FullBatchLoaderMSE)
            device = JaxDevice(backend="cpu")
        else:
            workflow, launcher, rng = StandardWorkflow, DummyLauncher, \
                torch_prng
            loader = TorchArraysLoader if loss == "softmax" else \
                mse_loader_class(torch_fullbatch.FullBatchLoaderMSE)
            device = CPU
        sw = workflow(
            launcher(), layers=specs, loss=loss,
            loader_factory=lambda w: loader(
                w, arrays, minibatch_size=20,
                prng=rng.RandomGenerator("loader", seed=1)),
            decision_config=dict(max_epochs=epochs))
        rng.get().seed(SEED)
        if fuse:
            sw.fuse()
        sw.initialize(device=device)
        out.append(sw)
    return out


@pytest.mark.parametrize("specs,sample_shape", [
    (CONVNET, (8, 8, 2)), (TRANSFORMER, (6, 8))],
    ids=["convnet", "transformer"])
def test_unit_halves_draw_the_jax_weights(specs, sample_shape):
    jsw, tsw = _build_pair(specs, sample_shape, fuse=True)
    for g, w in zip(torch_state(tsw), jax_state(jsw)):
        for key in w:
            if w[key] is None:
                assert g[key] is None, key
            else:
                assert g[key].tobytes() == w[key].tobytes(), key
    assert [f.output.shape for f in tsw.forwards] == \
        [f.output.shape for f in jsw.forwards]


DROPOUT_MLP = [
    dict(type="all2all_tanh", output_sample_shape=16, learning_rate=0.1,
         gradient_moment=0.9),
    {"type": "dropout", "dropout_ratio": 0.4},
    dict(type="all2all_relu", output_sample_shape=12, learning_rate=0.1,
         gradient_moment=0.9),
    {"type": "dropout", "dropout_ratio": 0.5},
    dict(type="softmax", output_sample_shape=CLASSES, learning_rate=0.1,
         gradient_moment=0.9)]
POOLS = [
    {"type": "conv_relu", "n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9,
     "weights_decay": 1e-3},
    {"type": "avg_pooling", "kx": 2, "ky": 2},
    {"type": "conv_sigmoid", "n_kernels": 3, "kx": 2, "ky": 2,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "maxabs_pooling", "kx": 2, "ky": 2, "sliding": (1, 1)},
    {"type": "conv", "n_kernels": 3, "kx": 1, "ky": 1,
     "learning_rate": 0.05},
    {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "softmax", "output_sample_shape": CLASSES,
     "learning_rate": 0.05, "gradient_moment": 0.9}]
ACTIVATIONS = [
    dict(type="all2all", output_sample_shape=16, learning_rate=0.05,
         gradient_moment=0.9),
    {"type": "activation_tanh"},
    dict(type="all2all", output_sample_shape=16, learning_rate=0.05),
    {"type": "activation_sigmoid"},
    {"type": "activation_log"},
    {"type": "activation_mul", "factor": 0.5},
    {"type": "activation_relu"},
    {"type": "activation_str"},
    dict(type="softmax", output_sample_shape=CLASSES, learning_rate=0.05,
         gradient_moment=0.9)]
#: examples/conv_autoencoder.py's layers (mse on the images themselves)
CONV_AE = [
    dict(type="conv_tanh", n_kernels=8, kx=3, ky=3, padding=1,
         learning_rate=0.02, gradient_moment=0.5),
    dict(type="avg_pooling", kx=2, ky=2, learning_rate=0.02,
         gradient_moment=0.5),
    dict(type="depooling", kx=2, ky=2, learning_rate=0.02,
         gradient_moment=0.5),
    dict(type="deconv", n_output_channels=1, kx=3, ky=3, padding=1,
         learning_rate=0.02, gradient_moment=0.5)]
PER_UNIT = {"convnet": (CONVNET, (8, 8, 2), "softmax"),
            "transformer": (TRANSFORMER, (6, 8), "softmax"),
            "dropout_mlp": (DROPOUT_MLP, (12,), "softmax"),
            "pools": (POOLS, (8, 8, 2), "softmax"),
            "activations": (ACTIVATIONS, (12,), "softmax"),
            "conv_autoencoder": (CONV_AE, (8, 8, 1), "mse")}


def _train_steps(sw, steps, step=unit_step):
    """Serve the validation minibatches, then ``steps`` train steps."""
    done = 0
    while done < steps:
        step(sw)
        if not bool(sw.decision.gd_skip) and sw.loader.minibatch_class == 2:
            done += 1


@pytest.mark.parametrize("name", sorted(PER_UNIT))
def test_per_unit_steps_match_jax(name, monkeypatch):
    """3 chained per-unit train steps (after the validation minibatches)
    in both packages, every leaf within 1e-4; the JAX package runs its
    Pallas backward in interpret mode.  Every layer's weights moved."""
    from veles_tpu.ops import common
    monkeypatch.setattr(common, "PALLAS_BWD_ENV", "1")
    specs, shape, loss = PER_UNIT[name]
    jsw, tsw = _build_pair(specs, shape, fuse=False, loss=loss)
    assert getattr(tsw, "fused_trainer", None) is None
    start = torch_state(tsw)
    for sw in (jsw, tsw):
        _train_steps(sw, 3)
    assert_states_close(torch_state(tsw), jax_state(jsw), 1e-4)
    for before, after in zip(start, torch_state(tsw)):
        if before["weights"] is not None:
            assert max_rel(after["weights"], before["weights"]) > 0


@pytest.mark.parametrize("name", ["convnet", "transformer", "pools",
                                  "activations", "conv_autoencoder"])
def test_per_unit_steps_match_fused_steps(name):
    """The port per unit against the port fused: 3 chained train steps
    from one state, every leaf within 1e-4."""
    specs, shape, loss = PER_UNIT[name]
    per_unit, = _build_pair(specs, shape, fuse=False, loss=loss,
                            packages=("torch",))
    fused, = _build_pair(specs, shape, fuse=True, loss=loss,
                         packages=("torch",))
    _train_steps(per_unit, 3)
    _train_steps(fused, 3, step=fused_step)
    assert_states_close(torch_state(fused), torch_state(per_unit), 1e-4)


def test_per_unit_convnet_trains():
    """Two per-unit epochs of the convnet on the CPU: the decision
    completes and the train error falls under chance."""
    sw, = _build_pair(CONVNET, (8, 8, 2), fuse=False, epochs=4,
                      packages=("torch",))
    sw.run()
    assert bool(sw.decision.complete)
    assert sw.gds[0].run_calls > 0
    assert sw.decision.epoch_metrics[2] < 100.0 * (1 - 1.0 / CLASSES)


def test_fused_convnet_steps_match_jax():
    """3 chained fused train steps of a convnet: every leaf within 1e-4
    of the JAX package's fused step."""
    jsw, tsw = _build_pair(CONVNET, (8, 8, 2), fuse=True)
    for sw in (jsw, tsw):
        for _ in range(2):           # the validation minibatches
            sw.loader.run()
    for _ in range(3):
        for sw in (jsw, tsw):
            fused_step(sw)
    want = [{k: None if v is None else numpy.asarray(v)
             for k, v in entry.items()}
            for entry in jsw.fused_trainer._state]
    assert_states_close(torch_state(tsw), want, 1e-4)


def test_fused_dropout_masks_follow_the_seed():
    specs = [dict(type="all2all_tanh", output_sample_shape=16,
                  learning_rate=0.1),
             {"type": "dropout", "dropout_ratio": 0.5},
             dict(type="softmax", output_sample_shape=CLASSES,
                  learning_rate=0.1)]
    runs = []
    for seed in (3, 3, 4):
        sw = StandardWorkflow(
            DummyLauncher(), layers=specs,
            loader_factory=lambda w: TorchArraysLoader(
                w, blobs(), minibatch_size=20,
                prng=torch_prng.RandomGenerator("loader", seed=1)),
            decision_config=dict(max_epochs=1))
        sw.fuse(dropout_seed=seed)
        torch_prng.get().seed(SEED)
        sw.initialize(device=CPU)
        sw.run()
        runs.append(torch_state(sw)[0]["weights"])
    assert runs[0].tobytes() == runs[1].tobytes()
    assert runs[0].tobytes() != runs[2].tobytes()


def mse_loader_class(base):
    """An autoencoder feed for either package: targets = the inputs."""

    class TargetsLoader(loader_class(base)):
        def load_data(self):
            super(TargetsLoader, self).load_data()
            self.original_targets = numpy.array(self.original_data.mem)

    return TargetsLoader


def test_mse_workflow_matches_jax():
    """FullBatchLoaderMSE, EvaluatorMSE and DecisionMSE: one chained
    epoch per unit within 1e-4 of JAX, the same RMSE per class to 1e-5
    relative; the fused port within 1e-4 of its per-unit run."""
    arrays = blobs(n_valid=20, n_train=80)
    specs = [dict(type="all2all_tanh", output_sample_shape=6,
                  learning_rate=0.05, gradient_moment=0.9),
             dict(type="all2all", output_sample_shape=12,
                  learning_rate=0.05, gradient_moment=0.9)]
    jsw = JaxWorkflow(
        JaxLauncher(), layers=specs, loss="mse",
        loader_factory=lambda w: mse_loader_class(
            jax_fullbatch.FullBatchLoaderMSE)(
                w, arrays, minibatch_size=20,
                prng=jax_prng.RandomGenerator("loader", seed=1)),
        decision_config=dict(max_epochs=1))
    jax_prng.get().seed(SEED)
    jsw.initialize(device=JaxDevice(backend="cpu"))
    jsw.run()
    runs = []
    for fuse in (False, True):
        sw = StandardWorkflow(
            DummyLauncher(), layers=specs, loss="mse",
            loader_factory=lambda w: mse_loader_class(
                torch_fullbatch.FullBatchLoaderMSE)(
                    w, arrays, minibatch_size=20,
                    prng=torch_prng.RandomGenerator("loader", seed=1)),
            decision_config=dict(max_epochs=1))
        if fuse:
            sw.fuse()
        torch_prng.get().seed(SEED)
        sw.initialize(device=CPU)
        sw.run()
        runs.append(sw)
    per_unit, fused = runs
    assert_states_close(torch_state(per_unit), jax_state(jsw), 1e-4)
    assert_states_close(torch_state(fused), torch_state(per_unit), 1e-4)
    for c in (1, 2):
        assert per_unit.decision.epoch_metrics[c] == pytest.approx(
            jsw.decision.epoch_metrics[c], rel=1e-5)
        assert fused.decision.epoch_metrics[c] == pytest.approx(
            per_unit.decision.epoch_metrics[c], rel=1e-4)


def test_unknown_layer_type_raises():
    with pytest.raises(ValueError, match="not ported"):
        StandardWorkflow(
            DummyLauncher(), layers=[{"type": "lstm"}],
            loader_factory=lambda w: TorchArraysLoader(w, blobs()))


def _dag(package, x):
    """Two branches from one input joined by InputJoiner, then a
    softmax head (tests/test_native.py's construction)."""
    if package == "jax":
        from veles_tpu.dummy import DummyUnit as Unit, DummyWorkflow as Wf
        from veles_tpu.memory import Array as Arr
        from veles_tpu.models.all2all import (All2AllRELU, All2AllSoftmax,
                                              All2AllTanh)
        from veles_tpu.service_units import InputJoiner as Joiner
        device = JaxDevice(backend="cpu")
        jax_prng.get().seed(SEED)
    else:
        Unit, Wf, Arr, Joiner = DummyUnit, DummyWorkflow, Array, InputJoiner
        from veles_tpu_torch.models.all2all import (All2AllRELU,
                                                    All2AllSoftmax,
                                                    All2AllTanh)
        device = CPU
        torch_prng.get().seed(SEED)
    wf = Wf()
    src = Unit(wf, minibatch_data=Arr(x))
    branch_a = All2AllTanh(wf, output_sample_shape=8)
    branch_a.link_attrs(src, ("input", "minibatch_data"))
    branch_a.initialize(device=device)
    branch_b = All2AllRELU(wf, output_sample_shape=12)
    branch_b.link_attrs(src, ("input", "minibatch_data"))
    branch_b.initialize(device=device)
    joiner = Joiner(wf)
    joiner.link_inputs((branch_a, "output"), (branch_b, "output"))
    joiner.initialize(device=device)
    head = All2AllSoftmax(wf, output_sample_shape=4)
    head.link_attrs(joiner, ("input", "output"))
    branch_a.run()
    branch_b.run()
    joiner.run()
    head.initialize(device=device)
    head.run()
    head.output.map_read()
    head.weights.map_read()
    return numpy.asarray(head.output.mem), numpy.asarray(head.weights.mem)


def test_input_joiner_dag_matches_jax():
    x = numpy.random.RandomState(4).rand(10, 6).astype(numpy.float32)
    got, got_w = _dag("torch", x)
    want, want_w = _dag("jax", x)
    assert got_w.tobytes() == want_w.tobytes()
    assert got.shape == want.shape == (10, 4)
    assert max_rel(got, want) <= 1e-6


def test_digits_anchor():
    """sklearn's real 8x8 digits through the port's per-unit graph at
    examples/digits.py's settings: best validation error <= 2.0 %."""
    pytest.importorskip("sklearn")
    from veles_tpu.datasets import digits_arrays
    train_x, train_y, valid_x, valid_y = digits_arrays()
    hyper = {"learning_rate": 0.08, "gradient_moment": 0.9,
             "weights_decay": 1e-4}
    sw = StandardWorkflow(
        DummyLauncher(),
        layers=[dict(type="all2all_tanh", output_sample_shape=64, **hyper),
                dict(type="softmax", output_sample_shape=10, **hyper)],
        loader_factory=lambda w: TorchArraysLoader(
            w, (valid_x, valid_y, train_x, train_y), minibatch_size=48,
            prng=torch_prng.RandomGenerator("digits", seed=2)),
        decision_config=dict(max_epochs=60, fail_iterations=20))
    torch_prng.get().seed(1234567890)
    sw.initialize(device=CPU)
    sw.run()
    assert sw.decision.best_metric <= 2.0, sw.decision.best_metric
