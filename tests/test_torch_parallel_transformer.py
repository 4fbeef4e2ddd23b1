"""The port's tensor-parallel and pipeline-parallel transformer steps
(``veles_tpu_torch/parallel/tensor.py``, ``parallel/pipeline.py``)
against the JAX package's, mirroring tests/test_parallel_transformer.py
on its model (2 pre-LN blocks, D 8, 4 or 2 heads, MLP 16, T 8, batch
16, 10 classes; the port's attention on its kernels' plain path).

The JAX side runs in this process on the conftest's virtual CPU
devices; the port's in spawned gloo worlds of 2 (model 2; pipe 2) and 4
(data 2 x model 2; pipe 4).  Limits, the reference's passing bounds:
the TP step over 3 chained steps within ``ULP_BOUND_3_STEPS`` (max-rel
1e-3) of the single-device step and of JAX's TP step, the losses within
1e-5 rel; TP with a data axis within the bound of TP alone; a poisoned
step leaves every rank's state bit for bit as it was; the microbatched
pipeline within the bound.  The reference's 2-stage pipeline is pinned
bit-identical to its unsplit step (red on the JAX side, ROADMAP.md
Queue 3); the port's is held bit for bit to the PORT's unsplit step,
prefix layer included, and to JAX's within the bound."""

import numpy
import pytest

import jax
import jax.numpy as jnp

from tests import torch_ranks
from tests.test_torch_bucketed import _assert_equal, _host
from tests.torch_spawn import spawn
from veles_tpu.compiler import build_train_step
from veles_tpu.models.zoo import build_plans_and_state, transformer_layers
from veles_tpu.parallel.mesh import make_mesh
from veles_tpu.parallel.pipeline import (build_pipeline_train_step,
                                         stack_pipeline_state,
                                         unstack_pipeline_state)
from veles_tpu.parallel.tensor import (build_tp_train_step,
                                       gather_tp_state, place_tp_state)

pytestmark = [pytest.mark.transformer, pytest.mark.dist]

#: tests/test_parallel_transformer.py's receipted bound
ULP_BOUND_3_STEPS = 1e-3


def _setup(seed=3, heads=4):
    specs = transformer_layers(blocks=2, heads=heads, hidden=16,
                               classes=10)
    _, state, _ = build_plans_and_state(specs, (8, 8), seed=seed)
    rng = numpy.random.RandomState(5)
    x = rng.rand(16, 8, 8).astype(numpy.float32)
    y = rng.randint(0, 10, 16).astype(numpy.int32)
    return specs, _host(state), x, y


def _prefix():
    specs = ([{"type": "layer_norm", "learning_rate": 0.05,
               "gradient_moment": 0.9}] +
             transformer_layers(blocks=2, heads=2, hidden=16, classes=10,
                                lr=0.05))
    _, state, _ = build_plans_and_state(specs, (8, 8), seed=4)
    rng = numpy.random.RandomState(6)
    return (specs, (8, 8), _host(state),
            rng.rand(16, 8, 8).astype(numpy.float32),
            rng.randint(0, 10, 16).astype(numpy.int32))


TP = _setup()
PIPE = _setup(heads=2)


def _stages():
    from veles_tpu.models.transformer import init_block_params
    rng = numpy.random.RandomState(11)
    stages = []
    for _ in range(4):
        w, b = init_block_params(8, 16, rng)
        stages.append({"weights": numpy.asarray(w),
                       "bias": numpy.asarray(b)})
    return stages, rng.randn(8, 6, 8).astype(numpy.float32)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    specs, state, x, y = TP
    return spawn(torch_ranks.transformer_world2, 2,
                 tmp_path_factory.mktemp("tf2"), specs, (8, 8), state, x, y,
                 None, "tp")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    specs, state, x, y = TP
    stages, sx = _stages()
    return spawn(torch_ranks.transformer_world4, 4,
                 tmp_path_factory.mktemp("tf4"), specs, (8, 8), state, x,
                 y, stages, sx)


def _maxrel(ref, got):
    worst = 0.0
    for re, ge in zip(ref, got):
        for key in re:
            if re[key] is None or ge.get(key) is None:
                continue
            a = numpy.asarray(re[key], numpy.float64)
            b = numpy.asarray(ge[key], numpy.float64)
            worst = max(worst, float(numpy.abs(a - b).max() /
                                     max(numpy.abs(a).max(), 1e-9)))
    return worst


def _run3(step, state, x, y):
    losses = []
    for _ in range(3):
        state, m = step(state, x, y, numpy.float32(16))
        losses.append(float(m["loss"]))
    return state, losses


def _jax_plans(specs):
    plans, _, _ = build_plans_and_state(specs, (8, 8), seed=0)
    return plans


@pytest.fixture(scope="module")
def jax_tp():
    specs, state, x, y = TP
    plans = _jax_plans(specs)
    mesh = make_mesh({"model": 2}, devices=jax.devices()[:2])
    step = build_tp_train_step(plans, mesh=mesh, donate=False)
    ts, losses = _run3(step, place_tp_state(mesh, plans, state),
                       jnp.asarray(x), jnp.asarray(y))
    return gather_tp_state(plans, ts), losses


def test_tp_step_over_3_chained_steps(world2, jax_tp):
    want, jlosses = jax_tp
    for rank in world2:
        ref_state, ref_losses = rank["reference"]
        got, losses, m = rank["tp"]
        assert m["finite"]
        for a, b, c in zip(ref_losses, losses, jlosses):
            assert abs(a - b) <= 1e-5 * abs(a)
            assert abs(c - b) <= 1e-5 * abs(c)
        assert _maxrel(ref_state, got) < ULP_BOUND_3_STEPS
        assert _maxrel(want, got) < ULP_BOUND_3_STEPS
    _assert_equal(world2[1]["tp"][0], world2[0]["tp"][0])


def test_tp_composes_with_a_data_axis(world2, world4):
    tp_state, tp_losses, _ = world2[0]["tp"]
    for rank in world4:
        got, losses, m = rank["tp_dp"]
        assert m["finite"]
        for a, b in zip(tp_losses, losses):
            assert abs(a - b) <= 1e-5 * abs(a)
        assert _maxrel(tp_state, got) < ULP_BOUND_3_STEPS


def test_tp_step_is_freed_without_the_cyclic_collector(world4):
    # see test_torch_bucketed.py: no cycle may keep a dropped step alive
    assert all(rank["freed"] for rank in world4)


def test_tp_poisoned_step_skips_on_every_rank(world2):
    for rank in world2:
        got, m = rank["tp_poison"]
        assert m["skipped"] == 1 and not m["finite"]
        _assert_equal(got, TP[1])


def _jax_pipeline(microbatches):
    specs, state, x, y = PIPE
    plans = _jax_plans(specs)
    mesh = make_mesh({"pipe": 2}, devices=jax.devices()[:2])
    ps, layout = stack_pipeline_state(mesh, plans, state)
    step = build_pipeline_train_step(plans, mesh=mesh,
                                     microbatches=microbatches, donate=False)
    ps, losses = _run3(step, ps, jnp.asarray(x), jnp.asarray(y))
    return unstack_pipeline_state(ps, layout), losses


@pytest.fixture(scope="module")
def pipe2(tmp_path_factory):
    specs, state, x, y = PIPE
    return spawn(torch_ranks.transformer_world2, 2,
                 tmp_path_factory.mktemp("pipe2"), specs, (8, 8), state, x,
                 y, _prefix(), "pipe")


def test_pipeline_split_equals_the_ports_unsplit_step(pipe2):
    for rank in pipe2:
        ref_state, ref_losses = rank["reference"]
        got, losses, m = rank["pipe_1"]
        assert losses == ref_losses
        _assert_equal(got, ref_state)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_pipeline_agrees_with_jax(pipe2, microbatches):
    want, jlosses = _jax_pipeline(microbatches)
    for rank in pipe2:
        got, losses, m = rank["pipe_%d" % microbatches]
        assert m["finite"]
        for a, b in zip(jlosses, losses):
            assert abs(a - b) <= 1e-5 * abs(a)
        assert _maxrel(want, got) < ULP_BOUND_3_STEPS
        if microbatches == 2:
            ref_state = rank["reference"][0]
            assert 0 < _maxrel(ref_state, got) < ULP_BOUND_3_STEPS


def test_pipeline_poisoned_step_skips_on_every_stage(pipe2):
    for rank in pipe2:
        got, m = rank["pipe_poison"]
        assert m["skipped"] == 1
        _assert_equal(got, PIPE[1])


def test_pipeline_prefix_layer_updates_the_same_on_every_rank(pipe2):
    state = _prefix()[2]
    for rank in pipe2:
        ref_state, ref_losses, prefix, got, losses = rank["prefix"]
        assert losses == ref_losses
        _assert_equal(got, ref_state)
        assert not numpy.array_equal(prefix[0]["weights"],
                                     state[0]["weights"])
    _assert_equal(pipe2[1]["prefix"][2], pipe2[0]["prefix"][2])


def test_pipeline_forward_drives_transformer_block_stages(world4):
    from veles_tpu.models.transformer import TransformerBlock
    stages, x = _stages()
    want = jnp.asarray(x)
    for s in stages:
        want = TransformerBlock.apply(
            {"weights": jnp.asarray(s["weights"]),
             "bias": jnp.asarray(s["bias"])}, want, heads=2, hidden=16)
    for rank in world4:
        numpy.testing.assert_allclose(rank["forward"], numpy.asarray(want),
                                      rtol=1e-5, atol=1e-5)
