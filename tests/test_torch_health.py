"""Numerics health and divergence recovery of the port
(veles_tpu_torch/health.py, chaos.py, the decision's watchdog,
StandardWorkflow.on_divergence, Snapshotter.rollback,
FusedTrainer.reset_after_rollback, the VELES_DEBUG_NONFINITE guards)
against the JAX package's, on the CPU.

- The counterparts of tests/test_chaos.py's rollback tests: sustained
  NaN gradients (``FaultPlan().add("step.grad", "nan", after=4,
  times=8)``) trip the consecutive-skip budget twice; each time the run
  rolls back to its last verified snapshot and halves the learning
  rates, so it ends with ``rollbacks == 2``, the rates x 0.25, finite
  weights and ``complete``, as the JAX package's same run does, and
  its final weights agree with that run's within 1e-4 (max-rel, the
  workflow tests' epoch limit).  A spent budget raises
  RollbackExhausted in both packages; no snapshotter raises
  DivergenceError.
- After a rollback the fused trainer re-keys its dropout stream as the
  JAX package's does, and the next step's mask is bit-equal to JAX's.
- The counterparts of tests/test_health.py's watchdog pieces:
  ``is_finite_metric``, ``all_finite``, ``EmaSpikeWatch`` give the JAX
  package's answers on the same inputs; the chaos spec parser fires on
  the same hits.
- ``VELES_DEBUG_NONFINITE`` (``ops.common.DEBUG_NONFINITE``): an inf
  operand raises FloatingPointError in ``matmul``, ``conv_wgrad`` and
  ``flash_attention`` on the plain path, as in the JAX package; the
  ``cuda``-marked cases do the same on the card.  Off, nothing raises.
"""

import math

import numpy
import pytest
import torch

from veles_tpu_torch import chaos, health, prng, threefry
from veles_tpu_torch.backends import Device
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.models.dropout import DropoutForward
from veles_tpu_torch.models.nn_workflow import StandardWorkflow
from veles_tpu_torch.ops import common

CPU = Device(backend="cpu")
#: the workflow tests' epoch limit (tests/test_torch_workflow.py)
EPOCH_TOL = 1e-4


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """The JAX package's flight recorder dumps into the working
    directory at each divergence and rollback."""
    monkeypatch.chdir(tmp_path)


def _noisy_blobs(self):
    """tests/test_chaos.py's NoisyBlobsLoader: overlapping blobs, so at
    a small learning rate every epoch improves and snapshots."""
    self.class_lengths[:] = [0, 64, 256]
    self._calc_class_end_offsets()
    self.create_originals((16,))
    rng = numpy.random.RandomState(5)
    centers = rng.randn(4, 16) * 1.2
    for i in range(self.total_samples):
        label = i % 4
        self.original_data.mem[i] = centers[label] + rng.randn(16) * 1.5
        self.original_labels[i] = label


class TorchNoisyBlobs(FullBatchLoader):
    load_data = _noisy_blobs


def _jax():
    """The JAX package's pieces, imported in the tests that need them
    (the card's machine has no JAX: the ``cuda`` tests import none).
    Its loader class is made here and kept in this module, where the
    snapshots find it."""
    import veles_tpu.chaos as jax_chaos
    import veles_tpu.health as jax_health
    import veles_tpu.prng as jax_prng
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.config import root as jax_root
    from veles_tpu.dummy import DummyLauncher as JaxLauncher
    from veles_tpu.loader.fullbatch import FullBatchLoader as JaxLoader
    from veles_tpu.models.nn_workflow import StandardWorkflow as JaxWorkflow
    if "JaxNoisyBlobs" not in globals():
        globals()["JaxNoisyBlobs"] = type(
            "JaxNoisyBlobs", (JaxLoader,),
            {"load_data": _noisy_blobs, "__module__": __name__})
    return dict(chaos=jax_chaos, health=jax_health, prng=jax_prng,
                root=jax_root, device=lambda: JaxDevice(backend="cpu"),
                launcher=JaxLauncher, workflow=JaxWorkflow,
                loader=globals()["JaxNoisyBlobs"])


_LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 16,
     "learning_rate": 0.004, "gradient_moment": 0.9},
    {"type": "softmax", "output_sample_shape": 4,
     "learning_rate": 0.004, "gradient_moment": 0.9},
]



def _package(name):
    if name == "jax":
        return _jax()
    return dict(chaos=chaos, health=health, prng=prng, root=root,
                device=lambda: CPU, launcher=DummyLauncher,
                workflow=StandardWorkflow, loader=TorchNoisyBlobs)


def _resume_run(package, directory, plan_spec, max_epochs=6, budget=None,
                snapshots=True):
    """tests/test_chaos.py's fused ``_build_resume`` workflow with a
    snapshot directory, run under the chaos plan ``plan_spec`` (a
    VELES_CHAOS string).  Returns (workflow, exception or None)."""
    pkg = _package(package)
    cfg, rng, harness = pkg["root"], pkg["prng"], pkg["chaos"]
    saved = (cfg.common.snapshot.get("dir"),
             cfg.common.snapshot.get("time_interval", 15))
    cfg.common.snapshot.update({"dir": str(directory) if snapshots else "",
                                "time_interval": 0})
    try:
        rng.get().seed(4242)
        sw = pkg["workflow"](
            pkg["launcher"](), layers=[dict(s) for s in _LAYERS],
            loader_factory=lambda w: pkg["loader"](
                w, minibatch_size=64,
                prng=rng.RandomGenerator("chaos_resume", seed=7)),
            decision_config=dict(max_epochs=max_epochs, skip_budget=4))
        sw.fuse()
        sw.initialize(device=pkg["device"]())
    finally:
        cfg.common.snapshot.update({"dir": saved[0],
                                    "time_interval": saved[1]})
    if budget is not None:
        sw.snapshotter.rollback_budget = budget
    harness.install(harness.FaultPlan.from_spec(plan_spec))
    try:
        sw.run()
        error = None
    except Exception as exc:
        error = exc
    finally:
        harness.uninstall()
    return sw, error


def _weights(sw):
    # the JAX trainer's unit Arrays lag its step state until a sync
    sw.fused_trainer.sync()
    out = []
    for unit in sw.forwards:
        for arr in (unit.weights, unit.bias):
            arr.map_read()
            out.append(numpy.array(arr.mem, numpy.float64))
    return out


#: 4 train steps an epoch: epoch 1 clean (its snapshot lands), epochs
#: 2-3 poisoned whole (a trip and a rollback each), then clean again
SUSTAINED = "seed=1;step.grad=nan:a4:x8"


def test_sustained_nan_rolls_back_twice_like_jax(tmp_path):
    runs = {}
    for package in ("jax", "torch"):
        sw, error = _resume_run(package, tmp_path / package, SUSTAINED)
        assert error is None, (package, error)
        runs[package] = sw
    for package, sw in runs.items():
        assert bool(sw.decision.complete), package
        assert sw.snapshotter.rollbacks == 2, package
        assert not bool(sw.decision.diverged), package
        for gd in sw.gds:
            assert gd.learning_rate == pytest.approx(0.004 * 0.25)
            assert gd.learning_rate_bias == pytest.approx(0.004 * 0.25)
        for w in _weights(sw):
            assert numpy.isfinite(w).all(), package
    tsw, jsw = runs["torch"], runs["jax"]
    assert tsw.fused_trainer.dropout_base_key == \
        jsw.fused_trainer._dropout_base_key
    assert tsw.fused_trainer.iteration == jsw.fused_trainer._iteration
    assert tsw.decision.epoch_number == jsw.decision.epoch_number == 6
    for got, want in zip(_weights(tsw), _weights(jsw)):
        rel = numpy.abs(got - want).max() / numpy.abs(want).max()
        assert rel <= EPOCH_TOL, rel
    assert tsw.decision.best_epoch == jsw.decision.best_epoch


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_rollback_budget_exhaustion_raises(tmp_path, package):
    """Epoch 1 clean, then NaN forever with a budget of 1: the second
    trip raises RollbackExhausted, in both packages."""
    sw, error = _resume_run(package, tmp_path, "step.grad=nan:a4",
                            max_epochs=8, budget=1)
    exhausted = _package(package)["health"].RollbackExhausted
    assert isinstance(error, exhausted), error
    assert sw.snapshotter.rollbacks == 2  # the failing attempt
    assert not bool(sw.decision.complete)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_divergence_without_snapshotter_raises(tmp_path, package):
    sw, error = _resume_run(package, tmp_path, "step.grad=nan:a4",
                            max_epochs=4, snapshots=False)
    diverged = _package(package)["health"].DivergenceError
    assert sw.snapshotter is None
    assert isinstance(error, diverged), error
    assert "no snapshotter" in str(error)


def test_loss_poison_skips_the_step_like_jax(tmp_path):
    """``step.loss`` poisons the loss only: the step is skipped, the
    counters say so, and the run goes on."""
    runs = {p: _resume_run(p, tmp_path / p, "step.loss=nan:n6",
                           max_epochs=2)
            for p in ("jax", "torch")}
    for package, (sw, error) in runs.items():
        assert error is None
        assert int(sw.fused_trainer.skip_count) == 1, package
        assert sw.snapshotter.rollbacks == 0
    for got, want in zip(_weights(runs["torch"][0]),
                         _weights(runs["jax"][0])):
        assert numpy.abs(got - want).max() <= \
            EPOCH_TOL * numpy.abs(want).max()


# -- the dropout stream after a rollback -----------------------------------


@pytest.mark.parametrize("rollbacks", [1, 2])
def test_rekeyed_dropout_mask_bit_equal_to_jax(rollbacks):
    import jax
    from test_torch_workflow import (_build_pair, assert_states_close,
                                     fused_step, torch_state)
    specs = [dict(type="all2all_tanh", output_sample_shape=16,
                  learning_rate=0.1, gradient_moment=0.9),
             {"type": "dropout", "dropout_ratio": 0.4},
             dict(type="softmax", output_sample_shape=4, learning_rate=0.1,
                  gradient_moment=0.9)]
    jsw, tsw = _build_pair(specs, (12,), fuse=True)
    for sw in (jsw, tsw):
        for _ in range(2):           # the validation minibatches
            sw.loader.run()
        for _ in range(2):
            fused_step(sw)
        # the unit Arrays hold the state, as after adopt_model_state
        sw.fused_trainer.sync()
        sw.fused_trainer.reset_after_rollback(rollbacks)
    base = tsw.fused_trainer.dropout_base_key
    assert base == jsw.fused_trainer._dropout_base_key == \
        (tsw.fused_trainer.dropout_seed + rollbacks * 0x9E3779B1) & \
        0x7FFFFFFF
    assert base != tsw.fused_trainer.dropout_seed
    # the next step (iteration 3) draws layer 1's mask from
    # fold_in(fold_in(key(base), 3), 1), in both packages
    shape = (20, 16)
    got = DropoutForward.make_mask(
        threefry.fold_in(threefry.fold_in(threefry.key(base), 3), 1),
        shape, 0.4, torch.float32, "cpu")
    want = numpy.asarray(jax.random.bernoulli(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(base), 3),
                           1), 0.6, shape))
    assert numpy.array_equal(got.numpy() != 0, want)
    for sw in (jsw, tsw):
        fused_step(sw)
    assert tsw.fused_trainer.iteration == jsw.fused_trainer._iteration == 3
    jstate = [{k: None if v is None else numpy.asarray(v)
               for k, v in entry.items()}
              for entry in jsw.fused_trainer._state]
    assert_states_close(torch_state(tsw), jstate, 1e-5)


# -- the shared health pieces ----------------------------------------------


@pytest.mark.parametrize("value", [None, float("nan"), float("inf"), "x",
                                   1.5, 0, numpy.float32(2.0)])
def test_is_finite_metric_like_jax(value):
    assert health.is_finite_metric(value) == \
        _jax()["health"].is_finite_metric(value)


def test_all_finite_like_jax():
    trees = [
        {"a": numpy.ones(3), "b": [1, 2.0, "s", None]},
        {"a": numpy.array([1.0, numpy.nan])},
        [numpy.arange(4), (numpy.float32(numpy.inf),)],
        {"deep": {"x": [numpy.zeros((2, 2), numpy.float32)]}},
    ]
    for tree in trees:
        assert health.all_finite(tree) == \
            _jax()["health"].all_finite(tree)
    assert not health.all_finite({"t": torch.tensor([1.0, math.inf])})
    assert health.all_finite({"t": torch.tensor([1, 2])})


def test_ema_spike_watch_like_jax():
    series = [1.0, 1.2, 0.9, 50.0, 1.1, 0.2, 0.01, 30.0, 0.3]
    ours = health.EmaSpikeWatch(spike_factor=5.0, spike_floor=0.5)
    theirs = _jax()["health"].EmaSpikeWatch(spike_factor=5.0,
                                            spike_floor=0.5)
    for value in series:
        assert ours.update(value) == theirs.update(value)
        assert ours.ema == theirs.ema
    ours.reset()
    assert ours.ema is None


def test_decision_watchdog_reset_after_rollback():
    from veles_tpu_torch.models.decision import DecisionGD
    decision = DecisionGD(DummyLauncher(), skip_budget=2)
    decision.diverged <<= True
    decision._skips_seen = 7
    decision._spike_watch.observe(3.0)
    decision.reset_divergence()
    assert not bool(decision.diverged)
    assert decision._skips_seen == 0 and decision._spike_watch.ema is None


@pytest.mark.parametrize("spec", [
    "seed=1;step.grad=nan:a4:x8", "step.loss=nan:n3",
    "seed=3;step.grad=nan:p0.5:x5", "snapshot.write=crash:n2;step.grad=nan:2.5"])
def test_fault_plan_fires_like_jax(spec):
    ours, theirs = chaos.FaultPlan.from_spec(spec), \
        _jax()["chaos"].FaultPlan.from_spec(spec)
    for _ in range(20):
        for point in ("step.grad", "step.loss", "snapshot.write"):
            a, b = ours.fire(point), theirs.fire(point)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.action, a.param) == (b.action, b.param)
    assert ours.log == theirs.log


def test_chaos_installs_from_the_environment(monkeypatch):
    monkeypatch.setenv("VELES_CHAOS", "seed=2;step.grad=nan:n1")
    try:
        plan = chaos.install_from_env()
        assert chaos.plan is plan and plan.fire("step.grad") is not None
    finally:
        chaos.uninstall()
    monkeypatch.delenv("VELES_CHAOS")
    assert chaos.install_from_env() is None and chaos.plan is None
    poisoned = chaos.poison_tree({"w": numpy.ones(2, numpy.float32),
                                  "n": numpy.arange(2), "s": "x"})
    assert numpy.isnan(poisoned["w"]).all()
    assert poisoned["n"].tolist() == [0, 1] and poisoned["s"] == "x"


# -- the VELES_DEBUG_NONFINITE guards --------------------------------------


def _inf_operands(device):
    rng = numpy.random.RandomState(3)
    mat = rng.randn(6, 8).astype(numpy.float32)
    mat[2, 3] = numpy.inf
    x = rng.randn(2, 5, 5, 3).astype(numpy.float32)
    x[0, 1, 1, 0] = numpy.inf
    y = rng.randn(2, 5, 5, 4).astype(numpy.float32)
    dy = rng.randn(2, 5, 5, 4).astype(numpy.float32)
    q = rng.randn(2, 9, 8).astype(numpy.float32)
    q[1, 4, 2] = numpy.inf
    kv = rng.randn(2, 9, 8).astype(numpy.float32)
    return {"mat": mat, "rhs": rng.randn(8, 4).astype(numpy.float32),
            "x": x, "y": y, "dy": dy, "w": rng.randn(3, 3, 3, 4).astype(
                numpy.float32), "q": q, "kv": kv}


def _torch_guarded_calls(ops, device):
    from veles_tpu_torch.ops.attention import flash_attention
    from veles_tpu_torch.ops.conv_vjp import conv_wgrad
    from veles_tpu_torch.ops.matmul import matmul

    def t(name):
        return torch.from_numpy(ops[name]).to(device)

    return {
        "matmul": lambda: matmul(t("mat"), t("rhs")),
        "conv_wgrad": lambda: conv_wgrad(
            t("x"), t("y"), t("dy"), activation="linear", ksize=(3, 3),
            padding=(1, 1, 1, 1)),
        "flash_attention": lambda: flash_attention(t("q"), t("kv"),
                                                   t("kv")),
    }


def _jax_guarded_calls(ops):
    import jax.numpy as jnp
    from veles_tpu.ops.attention import flash_attention
    from veles_tpu.ops.conv_vjp import fused_conv_vjp
    from veles_tpu.ops.matmul import matmul
    return {
        "matmul": lambda: matmul(jnp.asarray(ops["mat"]),
                                 jnp.asarray(ops["rhs"])),
        "conv_wgrad": lambda: fused_conv_vjp(
            jnp.asarray(ops["x"]), jnp.asarray(ops["w"]),
            jnp.asarray(ops["y"]), jnp.asarray(ops["dy"]),
            activation="linear", padding=(1, 1, 1, 1), sliding=(1, 1)),
        "flash_attention": lambda: flash_attention(
            jnp.asarray(ops["q"]), jnp.asarray(ops["kv"]),
            jnp.asarray(ops["kv"])),
    }


GUARDED = ["matmul", "conv_wgrad", "flash_attention"]


@pytest.mark.parametrize("name", GUARDED)
def test_debug_nonfinite_raises_like_jax(monkeypatch, name):
    import veles_tpu.ops.common as jax_common
    ops = _inf_operands("cpu")
    monkeypatch.setattr(jax_common, "DEBUG_NONFINITE", True)
    monkeypatch.setattr(jax_common, "PALLAS_BWD_ENV", "1")
    with pytest.raises(FloatingPointError):
        _jax_guarded_calls(ops)[name]()
    call = _torch_guarded_calls(ops, "cpu")[name]
    monkeypatch.setattr(common, "DEBUG_NONFINITE", False)
    call()  # off by default: nothing raises
    monkeypatch.setattr(common, "DEBUG_NONFINITE", True)
    with pytest.raises(FloatingPointError) as err:
        call()
    assert "non-finite" in str(err.value)
    assert "1 non-finite" in str(err.value)  # the operand's statistics


@pytest.mark.parametrize("name", GUARDED)
def test_debug_nonfinite_passes_finite_operands(monkeypatch, name):
    ops = _inf_operands("cpu")
    for key in ("mat", "x", "q"):
        ops[key] = numpy.nan_to_num(ops[key], posinf=1.0)
    monkeypatch.setattr(common, "DEBUG_NONFINITE", True)
    out = _torch_guarded_calls(ops, "cpu")[name]()
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", GUARDED)
def test_cuda_debug_nonfinite_raises(monkeypatch, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops = _inf_operands("cuda")
    monkeypatch.setattr(common, "DEBUG_NONFINITE", True)
    with pytest.raises(FloatingPointError):
        _torch_guarded_calls(ops, "cuda")[name]()
