"""The port's host pseudo-device (``NumpyDevice``, ``-d numpy``) against
the JAX package's numpy path, on the CPU.

Both packages run on their own ``Device(backend="numpy")``: each unit
takes its host run over the Arrays' host buffers (JAX: ``_numpy_run``
under ``host_compute_context``, with its Pallas backward in interpret
mode; the port: the same class-level math over CPU tensors copied from
``mem``).

- Every layer family (tests/test_torch_workflow.py's ``PER_UNIT`` plus
  ``rnn`` and ``lstm``): 3 chained per-unit train steps after the
  validation minibatches agree with JAX's on every leaf within 1e-4,
  the bound the port's CPU device is held to there; the port's Arrays
  stay host-only.
- The same steps on the port's ``NumpyDevice`` and on its
  ``Device("cpu")`` give bit-equal leaves: both run the same PyTorch
  CPU math on equal tensors.  So does a workflow fused explicitly on
  the ``NumpyDevice`` against one fused on the CPU device.
- The counterpart of tests/test_models.py's ``test_numpy_backend_
  parity``: the blobs MLP on the port's ``NumpyDevice`` and on JAX's
  end within 3.0 validation points.
- Each unit's host run against JAX's: ``All2AllSoftmax``'s ``max_idx``
  (equal), the evaluators' ``err_output`` (1e-6) and confusion matrix
  (equal), the dropout masks (bit-equal) and their pass-through on an
  evaluation minibatch, the SOM's winners (tests/test_torch_kohonen.py's
  gap rule), the RBM's steps (1e-5), and ``InputJoiner``,
  ``MeanDispNormalizer`` and ``Avatar`` (bit-equal).  The loader serves
  by host fill and the service units run numpy: neither reaches a
  kernel wrapper (kernels 1, 5 and 11).
- A GD chain's host run under the ``step.grad`` chaos point skips the
  step with JAX's ``skip_count`` / ``consecutive_skips``.
- Device selection: ``Device(backend="numpy")`` and ``-d numpy`` give a
  ``NumpyDevice``, rated with ``numpy.dot``; without a card,
  ``Device()`` and the launcher without ``-d`` raise ``no CUDA device``;
  ``auto`` is refused; a ``-d numpy`` run (results, snapshots, resume)
  neither asks for CUDA nor initializes it.  A JAX ``NumpyDevice`` in a
  snapshot restores as the port's.
- A snapshot written on the port's ``NumpyDevice`` loads in the JAX
  package, and the other way round: predictions within 1e-6.
"""

import glob
import gzip
import json
import os
import pickle

import numpy
import pytest
import torch

import veles_tpu.loader.fullbatch as jax_fullbatch
import veles_tpu.prng as jax_prng
import veles_tpu_torch.loader.fullbatch as torch_fullbatch
import veles_tpu_torch.prng as torch_prng
from veles_tpu.backends import Device as JaxDevice
from veles_tpu.dummy import DummyLauncher as JaxLauncher
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.models.nn_workflow import StandardWorkflow as JaxWorkflow
from veles_tpu_torch import chaos
from veles_tpu_torch.backends import Device, NumpyDevice
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.snapshotter import Snapshotter
from veles_tpu_torch.workflow import restore_workflow

import test_torch_rnn
from test_torch_cli import in_process, wf_file  # noqa: F401
from test_torch_kohonen import assert_winners_match
from test_torch_loader import JaxArraysLoader, TorchArraysLoader
from test_torch_snapshot import _CLI_LAYERS, _PortToJax, _cli_blobs
from test_torch_workflow import (CLASSES, PER_UNIT, SEED, _train_steps,
                                 assert_states_close, blobs, max_rel,
                                 mse_loader_class, unit_step)

NUMPY = Device(backend="numpy")
CPU = Device(backend="cpu")
STATE_KEYS = ("weights", "bias", "accum_weights", "accum_bias",
              "accum2_weights", "accum2_bias")


def _family(name):
    """(layer specs, seeded arrays, loss, minibatch size) of one layer
    family: tests/test_torch_workflow.py's ``PER_UNIT`` entries over its
    blobs, and tests/test_torch_rnn.py's recurrent nets over its
    sequences."""
    if name in ("rnn", "lstm"):
        return test_torch_rnn.layers(name), test_torch_rnn.sequences(), \
            "softmax", 24
    specs, shape, loss = PER_UNIT[name]
    arrays = blobs(features=int(numpy.prod(shape)))
    arrays = tuple(a.reshape((len(a),) + shape) if a.ndim == 2 else a
                   for a in arrays)
    return specs, arrays, loss, 20


FAMILIES = sorted(PER_UNIT) + ["lstm", "rnn"]


def _build(package, device, specs, arrays, loss="softmax", batch=20,
           epochs=1, fuse=False):
    """A StandardWorkflow of ``package`` over ``arrays``, initialized on
    ``device`` from SEED."""
    if package == "jax":
        workflow, launcher, rng = JaxWorkflow, JaxLauncher, jax_prng
        loader = JaxArraysLoader if loss == "softmax" else \
            mse_loader_class(jax_fullbatch.FullBatchLoaderMSE)
    else:
        workflow, launcher, rng = StandardWorkflow, DummyLauncher, \
            torch_prng
        loader = TorchArraysLoader if loss == "softmax" else \
            mse_loader_class(torch_fullbatch.FullBatchLoaderMSE)
    sw = workflow(
        launcher(), layers=[dict(s) for s in specs], loss=loss,
        loader_factory=lambda w: loader(
            w, arrays, minibatch_size=batch,
            prng=rng.RandomGenerator("loader", seed=1)),
        decision_config=dict(max_epochs=epochs))
    rng.get().seed(SEED)
    if fuse:
        sw.fuse()
    sw.initialize(device=device)
    return sw


def host_state(sw):
    """Each layer's leaves read from the host buffers (either package;
    a NumpyDevice run keeps no device copy)."""
    out = []
    for fwd, gd in zip(sw.forwards, sw.gds):
        entry = {}
        for key, arr in zip(STATE_KEYS, (
                fwd.weights, fwd.bias, gd.accum_weights, gd.accum_bias,
                gd.accum2_weights, gd.accum2_bias)):
            entry[key] = None
            if arr:
                arr.map_read()
                entry[key] = numpy.array(arr.mem)
        out.append(entry)
    return out


def assert_bit_equal(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        for key in STATE_KEYS:
            if w[key] is None:
                assert g[key] is None, (i, key)
            else:
                assert g[key].dtype == w[key].dtype, (i, key)
                assert g[key].tobytes() == w[key].tobytes(), (i, key)


def _host_only(sw):
    """No Array of the port's units holds a device tensor."""
    for unit in list(sw.forwards) + list(sw.gds) + [sw.evaluator,
                                                    sw.loader]:
        for value in vars(unit).values():
            if isinstance(value, Array):
                assert value.device is None and value._devmem_ is None, \
                    (unit, value)


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX conv backward at the port's level 0 (its Pallas kernel in
    interpret mode), as tests/test_torch_workflow.py runs it."""
    from veles_tpu.ops import common
    monkeypatch.setattr(common, "PALLAS_BWD_ENV", "1")


# -- every layer family per unit --------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_per_unit_steps_match_jax_numpy_device(name, jax_pallas):
    specs, arrays, loss, batch = _family(name)
    jsw = _build("jax", JaxDevice(backend="numpy"), specs, arrays, loss,
                 batch)
    tsw = _build("torch", NUMPY, specs, arrays, loss, batch)
    assert getattr(tsw, "fused_trainer", None) is None
    start = host_state(tsw)
    assert_bit_equal(start, host_state(jsw))
    for sw in (jsw, tsw):
        _train_steps(sw, 3)
    assert_states_close(host_state(tsw), host_state(jsw), 1e-4)
    for before, after in zip(start, host_state(tsw)):
        if before["weights"] is not None:
            assert max_rel(after["weights"], before["weights"]) > 0
    _host_only(tsw)


@pytest.mark.parametrize("name", FAMILIES)
def test_host_run_is_bit_equal_to_the_cpu_device(name):
    specs, arrays, loss, batch = _family(name)
    runs = []
    for device in (NUMPY, CPU):
        sw = _build("torch", device, specs, arrays, loss, batch)
        _train_steps(sw, 3)
        runs.append(host_state(sw))
    assert_bit_equal(*runs)


def test_fused_on_the_numpy_device_runs_on_the_cpu():
    """A workflow fused explicitly on the NumpyDevice runs its step on
    the CPU, bit-equal to one fused on the CPU device, without the
    input pipeline; its Arrays stay host-only."""
    specs, arrays, loss, batch = _family("convnet")
    runs = []
    for device in (NUMPY, CPU):
        sw = _build("torch", device, specs, arrays, loss, batch, epochs=2,
                    fuse=True)
        sw.run()
        runs.append((host_state(sw), sw.decision.epoch_metrics))
        if device is NUMPY:
            assert sw.fused_trainer.prefetcher is None
            _host_only(sw)
    assert_bit_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


def test_numpy_device_never_fuses_on_its_own(monkeypatch):
    """Auto-fuse takes the card, or a torch.distributed world on a
    device that exists: the host pseudo-device keeps the per-unit graph
    even in a world, as the JAX package's auto-fuse takes only its
    accelerator."""
    import torch.distributed as dist
    from veles_tpu_torch.config import root
    assert root.common.engine.get("auto_fuse", True)
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    specs, arrays, loss, batch = _family("dropout_mlp")
    sw = _build("torch", NUMPY, specs, arrays, loss, batch)
    assert getattr(sw, "fused_trainer", None) is None
    _host_only(sw)


# -- test_models.py's numpy backend parity ----------------------------------


class PortBlobs(torch_fullbatch.FullBatchLoader):
    """tests/test_models.py's BlobsLoader on the port."""

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


def test_numpy_backend_parity():
    """tests/test_models.py's ``build_mnist_like`` (the same blobs, net,
    seeds and 10 epochs) on both packages' NumpyDevice: validation
    errors within the reference's 3.0 points."""
    from test_models import build_mnist_like
    jsw = build_mnist_like(JaxDevice(backend="numpy"))
    jsw.run()
    wf = DummyWorkflow()
    tsw = StandardWorkflow(
        wf.workflow,
        layers=[{"type": "all2all_tanh", "output_sample_shape": 32,
                 "learning_rate": 0.05, "gradient_moment": 0.9},
                {"type": "softmax", "output_sample_shape": 4,
                 "learning_rate": 0.05, "gradient_moment": 0.9}],
        loader_factory=lambda w: PortBlobs(
            w, minibatch_size=64,
            prng=torch_prng.RandomGenerator("blobs", seed=7)),
        decision_config=dict(max_epochs=10))
    tsw.initialize(device=NUMPY)
    tsw.run()
    assert bool(tsw.decision.complete)
    assert abs(tsw.decision.epoch_metrics[1] -
               jsw.decision.epoch_metrics[1]) < 3.0
    assert tsw.decision.epoch_metrics[1] < 5.0


# -- each unit's host run ----------------------------------------------------


def _pair(port_cls, jax_cls, *args, **kwargs):
    """One unit of each package in a dummy workflow."""
    return (port_cls(DummyWorkflow(), *args, **kwargs),
            jax_cls(JaxDummyWorkflow(), *args, **kwargs))


def _jax_array(value):
    from veles_tpu.memory import Array as JaxArray
    return JaxArray(numpy.array(value))


def _host(arr):
    arr.map_read()
    return numpy.array(arr.mem)


def test_softmax_max_idx_equals_jax():
    from veles_tpu.models.all2all import All2AllSoftmax as JaxSoftmax
    from veles_tpu_torch.models.all2all import All2AllSoftmax
    rng = numpy.random.RandomState(5)
    x = rng.randn(37, 12).astype(numpy.float32)
    weights = rng.randn(12, 9).astype(numpy.float32)
    bias = rng.randn(9).astype(numpy.float32)
    port, jax = _pair(All2AllSoftmax, JaxSoftmax, output_sample_shape=9)
    for unit, array, device in ((port, Array, NUMPY),
                                (jax, _jax_array, JaxDevice(
                                    backend="numpy"))):
        unit.input = array(x)
        unit.weights.mem = weights
        unit.bias.mem = bias
        unit.initialize(device=device)
        unit.run()
    assert max_rel(_host(port.output), _host(jax.output)) <= 1e-6
    assert _host(port.max_idx).dtype == numpy.int32
    assert (_host(port.max_idx) == _host(jax.max_idx)).all()
    assert port.output.device is None and port.max_idx.device is None


def _probs(rng, batch, classes):
    z = rng.randn(batch, classes).astype(numpy.float32)
    z = numpy.exp(z - z.max(axis=1, keepdims=True))
    return (z / z.sum(axis=1, keepdims=True)).astype(numpy.float32)


def test_softmax_evaluator_host_run_matches_jax():
    """Two minibatches, the second padded (labels -1): err_output within
    1e-6, the same error counts and the confusion matrix summed over
    both, equal."""
    from veles_tpu.models.evaluator import EvaluatorSoftmax as JaxEval
    from veles_tpu_torch.models.evaluator import EvaluatorSoftmax
    rng = numpy.random.RandomState(3)
    batches = []
    for padded in (0, 7):
        probs = _probs(rng, 20, CLASSES)
        labels = rng.randint(0, CLASSES, 20).astype(numpy.int32)
        if padded:
            labels[-padded:] = -1
        batches.append((probs, labels, 20 - padded))
    port, jax = _pair(EvaluatorSoftmax, JaxEval)
    for unit, array, device in ((port, Array, NUMPY),
                                (jax, _jax_array, JaxDevice(
                                    backend="numpy"))):
        unit.output, unit.labels = array(batches[0][0]), \
            array(batches[0][1])
        unit.batch_size = 20
        unit.initialize(device=device)
    assert port.on_device() is False
    for probs, labels, size in batches:
        for unit in (port, jax):
            unit.output.map_invalidate()
            unit.output.mem = probs
            unit.labels.map_invalidate()
            unit.labels.mem = labels
            unit.batch_size = size
            unit.run()
        assert max_rel(_host(port.err_output),
                       _host(jax.err_output)) <= 1e-6
        assert isinstance(port.n_err, int) and port.n_err == jax.n_err
    assert _host(port.confusion_matrix).dtype == numpy.int32
    assert (_host(port.confusion_matrix) ==
            _host(jax.confusion_matrix)).all()
    assert _host(port.confusion_matrix).sum() == 20 + 13
    assert port.err_output.device is None


def test_mse_evaluator_host_run_matches_jax():
    from veles_tpu.models.evaluator import EvaluatorMSE as JaxEval
    from veles_tpu_torch.models.evaluator import EvaluatorMSE
    rng = numpy.random.RandomState(4)
    y = rng.randn(16, 6).astype(numpy.float32)
    target = rng.randn(16, 6).astype(numpy.float32)
    port, jax = _pair(EvaluatorMSE, JaxEval)
    for unit, array, device in ((port, Array, NUMPY),
                                (jax, _jax_array, JaxDevice(
                                    backend="numpy"))):
        unit.output, unit.target = array(y), array(target)
        unit.batch_size = 11
        unit.initialize(device=device)
        unit.run()
    assert max_rel(_host(port.err_output), _host(jax.err_output)) <= 1e-6
    assert isinstance(port.mse_sum, float)
    assert port.mse_sum == pytest.approx(jax.mse_sum, rel=1e-6)
    assert port.n_samples == jax.n_samples == 11


def test_dropout_host_masks_bit_equal_jax():
    """Train minibatches: masks, outputs and the backward's err_input
    bit-equal to JAX's host run for the same seed and step; an
    evaluation minibatch passes both ways through and resets the
    mask."""
    from veles_tpu.models.dropout import DropoutBackward as JaxBackward
    from veles_tpu.models.dropout import DropoutForward as JaxForward
    from veles_tpu_torch.models.dropout import (DropoutBackward,
                                                DropoutForward)
    rng = numpy.random.RandomState(8)
    x = rng.randn(20, 4, 6).astype(numpy.float32)
    err = rng.randn(20, 4, 6).astype(numpy.float32)
    fwd, jfwd = DropoutForward(DummyWorkflow(), dropout_ratio=0.4,
                               prng=torch_prng.RandomGenerator("d", 21)), \
        JaxForward(JaxDummyWorkflow(), dropout_ratio=0.4,
                   prng=jax_prng.RandomGenerator("d", 21))
    bwd, jbwd = _pair(DropoutBackward, JaxBackward)
    for f, b, array, device in (
            (fwd, bwd, Array, NUMPY),
            (jfwd, jbwd, _jax_array, JaxDevice(backend="numpy"))):
        f.input, f.minibatch_class = array(x), 2
        f.initialize(device=device)
        b.mask, b.err_output = f.mask, array(err)
        b.initialize(device=device)
    for step, cls in enumerate((2, 2, 1, 2)):
        for f, b in ((fwd, bwd), (jfwd, jbwd)):
            f.minibatch_class = cls
            f.run()
            b.run()
        assert fwd._step == jfwd._step == step + 1
        if cls == 2:
            mask = _host(fwd.mask)
            assert mask.tobytes() == _host(jfwd.mask).tobytes()
            assert 0 < (mask == 0).sum() < mask.size
        else:
            assert not fwd.mask and not jfwd.mask
            assert _host(fwd.output).tobytes() == x.tobytes()
            assert _host(bwd.err_input).tobytes() == err.tobytes()
        assert _host(fwd.output).tobytes() == _host(jfwd.output).tobytes()
        assert _host(bwd.err_input).tobytes() == \
            _host(jbwd.err_input).tobytes()
    assert fwd.output.device is None and bwd.err_input.device is None


def test_som_host_run_matches_jax():
    """The SOM trainer's 3 host runs (1e-5) and the forward's winners
    on the trained weights (JAX's, or a near-tie)."""
    from veles_tpu.models import kohonen as jax_kohonen
    from veles_tpu_torch.datasets import digits_arrays
    from veles_tpu_torch.models import kohonen
    x = digits_arrays(360, 4)[0]
    trainers = []
    for module, rng, array, device in (
            (kohonen, torch_prng, Array, NUMPY),
            (jax_kohonen, jax_prng, _jax_array,
             JaxDevice(backend="numpy"))):
        workflow = (DummyWorkflow if module is kohonen
                    else JaxDummyWorkflow)()
        trainer = module.KohonenTrainer(
            workflow, shape=(6, 6), alpha=0.3,
            prng=rng.RandomGenerator("kohonen", seed=9))
        trainer.input = array(x)
        trainer.initialize(device=device)
        for _ in range(3):
            trainer.run()
        trainers.append(trainer)
    port, jax = trainers
    assert port.weights.device is None
    weights = _host(jax.weights)
    assert max_rel(_host(port.weights), weights) <= 1e-5
    fwd = kohonen.KohonenForward(DummyWorkflow(), shape=(6, 6))
    fwd.input, fwd.weights = Array(x), Array(weights)
    fwd.initialize(device=NUMPY)
    fwd.run()
    got = _host(fwd.output)
    assert got.dtype == numpy.int32 and got.shape == (len(x),)
    assert_winners_match(got, weights, x)


def test_rbm_host_steps_match_jax():
    from veles_tpu.models.rbm import RBM as JaxRBM
    from veles_tpu_torch.datasets import digits_arrays
    from veles_tpu_torch.models.rbm import RBM
    x = digits_arrays(360, 4)[0]
    port = RBM(DummyWorkflow(), hidden_size=32, learning_rate=0.1,
               prng=torch_prng.RandomGenerator("rbm", seed=13))
    jax = JaxRBM(JaxDummyWorkflow(), hidden_size=32, learning_rate=0.1,
                 prng=jax_prng.RandomGenerator("rbm", seed=13))
    for unit, array, device in ((port, Array, NUMPY),
                                (jax, _jax_array, JaxDevice(
                                    backend="numpy"))):
        unit.input = array(x)
        unit.initialize(device=device)
    for _ in range(3):
        port.run()
        jax.run()
        for name in ("weights", "hidden_bias", "visible_bias"):
            assert max_rel(_host(getattr(port, name)),
                           _host(getattr(jax, name))) <= 1e-5, name
        assert port.reconstruction_error == pytest.approx(
            jax.reconstruction_error, rel=1e-5)
    assert port.weights.device is None
    assert port.reconstruct_error(x[:50]) == pytest.approx(
        jax.reconstruct_error(x[:50]), rel=1e-5)


def test_service_units_host_runs_bit_equal_jax(monkeypatch):
    """InputJoiner, MeanDispNormalizer (float32 and float64 statistics;
    the port rounds to its float32 output as JAX's next layer does) and
    Avatar on the host: bit-equal to JAX's, and no kernel wrapper is
    called."""
    import veles_tpu.service_units as jax_service
    import veles_tpu_torch.service_units as service

    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on the host device")
    monkeypatch.setattr(service, "join", no_kernel)
    monkeypatch.setattr(service, "mean_disp_normalize", no_kernel)
    jax_device = JaxDevice(backend="numpy")
    rng = numpy.random.RandomState(6)
    parts = [rng.randn(9, 3).astype(numpy.float32),
             rng.randn(9, 2, 2).astype(numpy.float32)]
    joiner, jjoiner = _pair(service.InputJoiner, jax_service.InputJoiner)
    joiner.inputs = [Array(p) for p in parts]
    jjoiner.inputs = [_jax_array(p) for p in parts]
    joiner.initialize(device=NUMPY)
    jjoiner.initialize(device=jax_device)
    joiner.run()
    jjoiner.run()
    assert _host(joiner.output).tobytes() == _host(jjoiner.output).tobytes()
    x = (rng.rand(9, 4, 2) * 255).astype(numpy.float32)
    for dtype in (numpy.float32, numpy.float64):
        mean = rng.rand(8).astype(dtype) * 100
        rdisp = (1.0 / (rng.rand(8) + 0.5)).astype(dtype)
        norm, jnorm = _pair(service.MeanDispNormalizer,
                            jax_service.MeanDispNormalizer)
        for unit, array, device in ((norm, Array, NUMPY),
                                    (jnorm, _jax_array, jax_device)):
            unit.input, unit.mean, unit.rdisp = array(x), mean, rdisp
            unit.initialize(device=device)
            unit.run()
        got, want = _host(norm.output), _host(jnorm.output)
        assert got.dtype == numpy.float32 and got.shape == x.shape
        assert got.tobytes() == want.astype(numpy.float32).tobytes()
    avatar, javatar = _pair(service.Avatar, jax_service.Avatar)
    avatar.clone(joiner, "output")
    javatar.clone(jjoiner, "output")
    avatar.initialize(device=NUMPY)
    javatar.initialize(device=jax_device)
    avatar.run()
    javatar.run()
    assert _host(avatar.output).tobytes() == \
        _host(javatar.output).tobytes()
    assert avatar.output.mem is not joiner.output.mem
    assert joiner.output.device is None and avatar.output.device is None


def test_loader_serves_by_host_fill(monkeypatch):
    """On the NumpyDevice the loader takes its host fill: the gather
    wrappers (kernel 1) are never called, and the minibatches equal
    the CPU device's gathered ones."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("the gather ran on the host device")
    specs, arrays, loss, batch = _family("dropout_mlp")
    served = {}
    for device in (CPU, NUMPY):
        if device is NUMPY:
            monkeypatch.setattr(torch_fullbatch, "gather_minibatch",
                                no_kernel)
            monkeypatch.setattr(torch_fullbatch, "gather_labels",
                                no_kernel)
        sw = _build("torch", device, specs, arrays, loss, batch)
        assert sw.loader._use_device_path() is (device is CPU)
        out = []
        for _ in range(4):
            sw.loader.run()
            out.append((_host(sw.loader.minibatch_data),
                        _host(sw.loader.minibatch_labels)))
        served[device.backend] = out
    for (data, labels), (jdata, jlabels) in zip(served["numpy"],
                                                 served["cpu"]):
        assert data.tobytes() == jdata.tobytes()
        assert labels.tobytes() == jlabels.tobytes()


# -- the step.grad chaos point on the host -----------------------------------


def test_poisoned_host_step_skips_like_jax():
    """One poisoned GD run on both packages' NumpyDevice: the whole
    chain skips that step with JAX's skip counters, the leaves stay as
    they were, and the next step trains and resets the consecutive
    count."""
    import veles_tpu.chaos as jax_chaos
    specs, arrays, loss, batch = _family("activations")
    runs = {}
    for package, device, module in (
            ("jax", JaxDevice(backend="numpy"), jax_chaos),
            ("torch", NUMPY, chaos)):
        sw = _build(package, device, specs, arrays, loss, batch)
        while sw.loader.minibatch_class != 2 or bool(sw.decision.gd_skip):
            unit_step(sw)
        before = host_state(sw)
        module.install(module.FaultPlan.from_spec("step.grad=nan:n1"))
        try:
            unit_step(sw)
        finally:
            module.uninstall()
        assert_bit_equal(host_state(sw), before)
        # the parametrized GD units count skips (an activation's
        # backward has no update to skip)
        gds = [gd for gd in sw.gds if gd.weights]
        counts = [(int(gd.skip_count), int(gd.consecutive_skips))
                  for gd in gds]
        unit_step(sw)
        after = [(int(gd.skip_count), int(gd.consecutive_skips))
                 for gd in gds]
        runs[package] = (counts, after, host_state(sw), before)
    assert runs["torch"][:2] == runs["jax"][:2]
    counts, after, state, before = runs["torch"]
    assert set(counts) == {(1, 1)} and set(after) == {(1, 0)}
    assert state[0]["weights"].tobytes() != before[0]["weights"].tobytes()
    assert all(isinstance(gd.skip_count, int) for gd in
               _build("torch", NUMPY, specs, arrays, loss, batch).gds)


# -- device selection --------------------------------------------------------


def test_numpy_device_is_asked_for_and_rated_with_numpy_dot():
    from veles_tpu_torch.launcher import _resolve_device
    device = Device(backend="numpy")
    assert isinstance(device, NumpyDevice) and device.backend == "numpy"
    assert device.exists is False and device.torch_device.type == "cpu"
    assert device.matmul_fn() is numpy.dot
    assert device.computing_power > 0
    assert isinstance(_resolve_device("numpy"), NumpyDevice)
    restored = pickle.loads(pickle.dumps(device))
    assert isinstance(restored, NumpyDevice) and not restored.exists
    assert type(Device(backend="cpu")) is Device
    with pytest.raises(ValueError, match="auto"):
        _resolve_device("auto")


def test_no_card_still_raises_without_a_host_device(monkeypatch):
    """NumpyDevice is never chosen in place of a missing card."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import _resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VELES_BACKEND", raising=False)
    monkeypatch.setattr(root.common.engine, "backend", None,
                        raising=False)
    for make in (Device, lambda: Device(backend="cuda"), _resolve_device):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_jax_numpy_device_restores_as_the_ports(tmp_path):
    from veles_tpu_torch.snapshotter import SnapshotterBase
    path = tmp_path / "device.pickle"
    path.write_bytes(pickle.dumps(JaxDevice(backend="numpy")))
    device = SnapshotterBase.import_file(str(path))
    assert isinstance(device, NumpyDevice) and not device.exists


def test_cli_numpy_run_never_touches_cuda(in_process, wf_file,
                                          monkeypatch, tmp_path):
    """``-d numpy`` trains the CLI workflow on the NumpyDevice with
    snapshots, a result file and a resume, without asking for CUDA or
    initializing it (tests/test_torch_cli.py's ``-b`` check); its
    results equal a ``-d cpu`` run's."""
    asked = []
    real = torch.cuda.is_available
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: asked.append(1) or real())
    results = {}
    for backend in ("numpy", "cpu"):
        result = str(tmp_path / ("%s.json" % backend))
        snaps = str(tmp_path / ("snaps_" + backend))
        code, main = in_process(
            wf_file, "-", "-d", backend, "-r", "5", "--result-file", result,
            "--snapshot-dir", snaps, "--snapshot-time-interval", "0",
            "root.cli_test.max_epochs=3")
        assert code == 0
        workflow = main.workflow
        assert isinstance(workflow.forwards[0].device, NumpyDevice) is \
            (backend == "numpy")
        results[backend] = json.load(open(result))
        if backend == "numpy":
            assert not asked and not torch.cuda.is_initialized()
            _host_only(workflow)
            newest = sorted(glob.glob(os.path.join(snaps, "*.pickle.gz")))
            resumed = str(tmp_path / "resumed.json")
            code, main = in_process(
                wf_file, "-", "-d", "numpy", "-r", "5", "-w", newest[-1],
                "--result-file", resumed)
            assert code == 0
            assert main.workflow.decision.epoch_number == 3
            assert not asked and not torch.cuda.is_initialized()
            assert json.load(open(resumed)) == results["numpy"]
    assert results["numpy"] == results["cpu"]


def test_master_and_slave_on_the_numpy_device(monkeypatch):
    """``-l`` / ``-m`` on the host: a master and a sync slave, both on
    the NumpyDevice, train the blobs MLP for 3 epochs bit-equal to the
    same pair on the CPU device; the slave's handshake reports the
    NumpyDevice's ``numpy.dot`` rating; every Array stays host-only."""
    from tests.torch_master_slave import build, start_server, weights
    from veles_tpu_torch.client import Client
    from veles_tpu_torch.ops import benchmark
    runs = {}
    for device in (NUMPY, CPU):
        if device is NUMPY:
            monkeypatch.setattr(
                benchmark, "estimate_computing_power",
                lambda *a, **k: pytest.fail("the host was rated by the "
                                            "matmul wrapper"))
        else:
            monkeypatch.undo()
        master = build("master", "net_m", device=device)
        slave = build("slave", "net_s", device=device)
        server, _ = start_server(master)
        client = Client("127.0.0.1:%d" % server.port, slave)
        client.run()
        assert server._done.wait(10)
        assert client.jobs_done > 0 and bool(master.decision.complete)
        runs[device.backend] = (weights(master), master.decision.
                                epoch_metrics, client.power_rating)
        if device is NUMPY:
            assert client.power_rating == NUMPY.computing_power > 0
            _host_only(master)
            _host_only(slave)
    (got, metrics, _), (want, want_metrics, _) = runs["numpy"], runs["cpu"]
    assert metrics == want_metrics
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


# -- one snapshot format -----------------------------------------------------


def _predict_port(sw, x):
    from veles_tpu_torch.compiler import build_forward, workflow_plan
    params = [{"weights": torch.tensor(s["weights"]),
               "bias": torch.tensor(s["bias"])} for s in host_state(sw)]
    with torch.no_grad():
        return build_forward(workflow_plan(sw))(
            params, torch.tensor(x)).numpy()


def _predict_jax(sw, x):
    from veles_tpu.compiler import build_forward, workflow_plan
    params = [{"weights": s["weights"], "bias": s["bias"]}
              for s in host_state(sw)]
    return numpy.asarray(build_forward(workflow_plan(sw))(params, x))


def _cli_workflow(package, module, device):
    rng = jax_prng if package == "jax" else torch_prng
    workflow, launcher = (JaxWorkflow, JaxLauncher) if package == "jax" \
        else (StandardWorkflow, DummyLauncher)
    rng.get().seed(7)
    sw = workflow(
        launcher(), layers=[dict(s) for s in _CLI_LAYERS],
        loader_factory=lambda w: module.CliBlobs(
            w, minibatch_size=32, prng=rng.RandomGenerator("cli", seed=4)),
        decision_config=dict(max_epochs=2))
    sw.initialize(device=device)
    return sw


X = numpy.random.RandomState(12).randn(40, 8).astype(numpy.float32)


def test_numpy_device_snapshot_loads_in_jax(tmp_path):
    with _cli_blobs(tmp_path, "torch") as module:
        tsw = _cli_workflow("torch", module, NUMPY)
        tsw.run()
        snap = Snapshotter(tsw, directory=str(tmp_path), prefix="np",
                           interval=1, time_interval=0, compression="gz")
        snap.initialize()
        snap.export()
        want = _predict_port(tsw, X)
    with _cli_blobs(tmp_path, "jax"):
        with gzip.open(snap.destination) as fin:
            jsw = _PortToJax(fin).load()
        from veles_tpu.backends import NumpyDevice as JaxNumpyDevice
        assert isinstance(jsw.forwards[0].device, JaxNumpyDevice)
        jsw.workflow = JaxLauncher()
        jsw.restored_from_snapshot_ = True
        jsw.initialize(device=JaxDevice(backend="numpy"))
        assert_bit_equal(host_state(jsw), host_state(tsw))
        got = _predict_jax(jsw, X)
    assert numpy.abs(got - want).max() <= 1e-6


def test_jax_numpy_snapshot_loads_in_the_port(tmp_path):
    from test_torch_snapshot import _jax_snapshotter
    with _cli_blobs(tmp_path, "jax") as module:
        jsw = _cli_workflow("jax", module, JaxDevice(backend="numpy"))
        jsw.run()
        snap = _jax_snapshotter().Snapshotter(
            jsw, directory=str(tmp_path), prefix="jaxnp", interval=1,
            time_interval=0)
        snap.initialize()
        snap.export()
        want = _predict_jax(jsw, X)
    with _cli_blobs(tmp_path, "torch"):
        tsw = restore_workflow(snap.destination, DummyLauncher())
        assert isinstance(tsw.forwards[0].device, NumpyDevice)
        tsw.initialize(device=NUMPY)
        assert_bit_equal(host_state(tsw), host_state(jsw))
        got = _predict_port(tsw, X)
        tsw.decision.max_epochs = 3
        tsw.decision.complete <<= False
        tsw.run()
        assert tsw.decision.epoch_number == 3
        _host_only(tsw)
    assert numpy.abs(got - want).max() <= 1e-6
