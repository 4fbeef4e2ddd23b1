"""The port's annotation path, the fused trainer's mesh, the comm
receipt, ``collective_bytes`` and the multi-process CLI start, against
the JAX package's (``veles_tpu/compiler.py``'s ``state_shardings``
path, ``veles_tpu/models/fused.py``'s SPMD mesh).

The JAX side runs in this process on the conftest's virtual CPU
devices; the port's in spawned gloo worlds (``tests/torch_spawn.py``).
Limits: the annotation step (DP over 4 ranks, and TP x DP over data 2 x
model 2 with the MLP split column then row) within max-rel 1e-5 of
JAX's same mesh after one step and of the port's one-rank step, the
loss within 1e-5 rel; the fused trainer on a data-2 mesh gives JAX's
fused trainer's epoch error counts and its weights within 1e-4 after 2
epochs; ``collective_bytes`` counts the gradients' bytes plus the two
metric sums exactly.  The CLI test starts ``python -m veles_tpu_torch``
twice under ``VELES_COORDINATOR`` (gloo, ``-d cpu``)."""

import os
import socket
import subprocess
import sys

import numpy
import pytest

import jax

from tests import torch_ranks
from tests.test_torch_bucketed import (X, Y, _assert_close, _host,
                                       _mlp_state, _plans)
from tests.torch_spawn import spawn
from veles_tpu.compiler import build_train_step
from veles_tpu.parallel import (batch_sharding, make_mesh,
                                mlp_state_shardings)

pytestmark = pytest.mark.dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = _mlp_state(numpy.random.RandomState(4))
SMALL_RNG = numpy.random.RandomState(0)
SMALL = ([{"weights": SMALL_RNG.rand(16, 8).astype(numpy.float32),
           "bias": numpy.zeros(8, numpy.float32),
           "accum_weights": numpy.zeros((16, 8), numpy.float32),
           "accum_bias": numpy.zeros(8, numpy.float32),
           "accum2_weights": None, "accum2_bias": None},
          {"weights": SMALL_RNG.rand(8, 4).astype(numpy.float32),
           "bias": numpy.zeros(4, numpy.float32),
           "accum_weights": numpy.zeros((8, 4), numpy.float32),
           "accum_bias": numpy.zeros(4, numpy.float32),
           "accum2_weights": None, "accum2_bias": None}],
         SMALL_RNG.rand(8, 16).astype(numpy.float32),
         SMALL_RNG.randint(0, 4, 8).astype(numpy.int32))


def _blobs():
    from tests.test_torch_workflow import blobs
    return blobs()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(torch_ranks.annotation_world4, 4,
                 tmp_path_factory.mktemp("annot4"), STATE, X, Y, SMALL)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn(torch_ranks.fused_world2, 2,
                 tmp_path_factory.mktemp("fused2"), _blobs(), 2)


def _jax_annotated(axes, model_axis):
    n = int(numpy.prod(list(axes.values())))
    mesh = make_mesh(axes, jax.devices()[:n])
    shardings = mlp_state_shardings(mesh, STATE, model_axis=model_axis)
    bsh = batch_sharding(mesh)
    step = build_train_step(_plans(), mesh=mesh, state_shardings=shardings,
                            batch_sharding=bsh, donate=False)
    dstate = jax.tree.map(
        lambda leaf, sh: None if leaf is None else jax.device_put(leaf, sh),
        STATE, shardings, is_leaf=lambda v: v is None)
    s, m = step(dstate, jax.device_put(X, bsh), jax.device_put(Y, bsh),
                numpy.float32(64))
    return _host(s), m


@pytest.mark.parametrize("name, axes, model", [
    ("dp", {"data": 4}, None),
    ("tp_dp", {"data": 2, "model": 2}, "model")])
def test_annotation_path_agrees_with_jax(world4, name, axes, model):
    want, jm = _jax_annotated(axes, model)
    ref = build_train_step(_plans(), donate=False)
    rs, rm = ref([dict(e) for e in STATE], X, Y, numpy.float32(64))
    for rank in world4:
        state, m = rank[name]
        _assert_close(state, want, 1e-5)
        _assert_close(state, _host(rs), 1e-5)
        assert abs(m["loss"] - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
        assert m["n_err"] == int(jm["n_err"])
        assert abs(m["grad_norm"] - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])


def test_annotation_shardings_equal_jax():
    from veles_tpu_torch.parallel import mlp_state_shardings as port_specs
    mesh = make_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    want = mlp_state_shardings(mesh, STATE, model_axis="model")
    got = port_specs(None, STATE, model_axis="model")
    for g, w in zip(got, want):
        assert {k: tuple(v) for k, v in g.items()} == \
            {k: tuple(v.spec) for k, v in w.items()}


def test_collective_bytes_counts_the_gradients(world4):
    from veles_tpu.parallel.analysis import collective_bytes as jax_bytes
    from jax.sharding import NamedSharding, PartitionSpec as P
    param_bytes = 4 * (16 * 8 + 8 + 8 * 4 + 4)
    mesh = make_mesh({"data": 4}, jax.devices()[:4])
    repl = NamedSharding(mesh, P())
    bsh = NamedSharding(mesh, P("data"))
    step = build_train_step(_plans({"learning_rate": 0.1}), mesh=mesh,
                            state_shardings=jax.tree.map(
                                lambda leaf: None if leaf is None else repl,
                                SMALL[0], is_leaf=lambda v: v is None),
                            batch_sharding=bsh, donate=False)
    state = jax.tree.map(
        lambda leaf: None if leaf is None else jax.device_put(leaf, repl),
        SMALL[0], is_leaf=lambda v: v is None)
    want = jax_bytes(jax.jit(step), state, jax.device_put(SMALL[1], bsh),
                     jax.device_put(SMALL[2], bsh), numpy.float32(8), None)
    for rank in world4:
        got = rank["bytes"]
        # the gradients, the loss and the error count: exactly
        assert got["all-reduce"] == param_bytes + 8 == got["total"]
        assert set(want) - {"total"} <= set(got)
        # JAX's band: at least the gradients, at most 4 KiB more
        assert param_bytes <= want["all-reduce"] <= param_bytes + 4096


def _jax_fused(arrays, epochs):
    import veles_tpu.prng as jax_prng
    from tests.test_torch_loader import JaxArraysLoader
    from tests.test_torch_workflow import layers
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyLauncher as JaxLauncher
    from veles_tpu.models.nn_workflow import StandardWorkflow as JaxWorkflow
    sw = JaxWorkflow(
        JaxLauncher(), layers=layers(),
        loader_factory=lambda w: JaxArraysLoader(
            w, arrays, minibatch_size=20,
            prng=jax_prng.RandomGenerator("loader", seed=1)),
        decision_config=dict(max_epochs=epochs))
    sw.fuse(mesh=make_mesh({"data": 2}, jax.devices()[:2]),
            grad_bucket_mb=0.001)
    jax_prng.get().seed(11)
    sw.initialize(device=JaxDevice(backend="cpu"))
    errors = []
    dec = sw.decision
    inner = dec._on_epoch_ended

    def hook():
        errors.append(tuple(
            None if dec.epoch_metrics[c] is None else
            round(dec.epoch_metrics[c] * dec.class_lengths[c] / 100.0)
            for c in (1, 2)))
        inner()
    dec._on_epoch_ended = hook
    sw.run()
    sw.fused_trainer.sync()
    from tests.test_torch_workflow import jax_state
    return errors, jax_state(sw)


def test_fused_mesh_epochs_agree_with_jax(world2):
    errors, state = _jax_fused(_blobs(), 2)
    for rank in world2:
        assert rank["errors"] == errors
        _assert_close(rank["state"], state, 1e-4)
        assert rank["update_validation"] == "inline"
    _assert_close(world2[1]["state"], world2[0]["state"], 0.0)


def test_fused_mesh_publishes_the_comm_receipt(world2):
    from veles_tpu.parallel.bucketed import comm_receipt
    for rank in world2:
        receipt = rank["receipt"]
        leaves = [numpy.zeros(s, numpy.float32)
                  for s in ((16,), (12, 16), (4,), (16, 4))]
        want = comm_receipt(leaves, 2, bucket_bytes=0.001 * 2.0 ** 20)
        assert receipt["bucket_bytes"] == want["bucket_bytes"]
        assert receipt["allreduce_bytes"] == want["allreduce_bytes"]
        gauges = rank["gauges"]
        assert gauges["comm.buckets"] == len(receipt["bucket_bytes"]) >= 2
        assert gauges["comm.allreduce_bytes"] == 4 * (16 + 12 * 16 + 4 + 64)


def test_bf16_falls_back_to_f32_after_a_poisoned_step(world2):
    for rank in world2:
        compress, skips, fallbacks, finite = rank["fallback"]
        # epoch 0 validates only; epoch 1 trained through the poisoned
        # step, and its health sync fell back to f32
        assert compress == ["bf16", None, None]
        assert skips == 1 and fallbacks == 1 and finite


def test_meshed_trainer_state_restores_in_both_packages(world2):
    from veles_tpu.models.fused import FusedTrainer as JaxTrainer
    for rank in world2:
        fields, restored, respanned, refused = rank["restore"]
        assert fields["_spmd_axes_"] == {"data": 2}
        assert fields["mesh"] is None and fields["grad_bucket_mb"] == 0.001
        assert restored == {"data": 2} == respanned and refused
    bare = JaxTrainer.__new__(JaxTrainer)
    bare.__dict__.update(world2[0]["restore"][0])
    bare.warning = lambda *a, **k: None
    bare._restore_mesh()
    # 8 virtual devices: the one-axis mesh re-spans them
    assert dict(bare.mesh.shape) == {"data": len(jax.devices())}


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_cli_world_of_two_under_veles_coordinator(tmp_path):
    """``init_multihost`` joins a gloo world from VELES_COORDINATOR, the
    workflow fuses with a data-parallel mesh, ``--grad-bucket-mb``
    sizes its buckets, and both ranks end on the same epoch metrics."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               VELES_COORDINATOR="127.0.0.1:%d" % port,
               VELES_NUM_PROCESSES="2")
    env.pop("VELES_BACKEND", None)
    procs = []
    for rank in range(2):
        env["VELES_PROCESS_ID"] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch",
             os.path.join(ROOT, "veles_tpu_torch", "examples", "digits.py"),
             "-", "-d", "cpu", "--grad-bucket-mb", "0.001",
             "root.digits.max_epochs=1"],
            cwd=str(tmp_path), env=dict(env), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=120)
            logs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
        assert "a world of 2 processes" in log
        assert "SPMD comm: 19 bucket(s)" in log
    metrics = [[line.split(": ", 1)[1] for line in log.splitlines()
                if "Epoch 1 metrics" in line] for log in logs]
    assert metrics[0] and metrics[0] == metrics[1]
