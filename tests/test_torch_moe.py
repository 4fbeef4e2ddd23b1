"""The port's expert parallelism and pipeline wavefront
(``veles_tpu_torch/parallel/moe.py``, ``parallel/pipeline.py``'s
``pipeline_forward``) against the JAX package's and their sequential
oracles, mirroring tests/test_pipeline_moe.py at 4 ranks: an expert
axis of 4 and data 2 x expert 2 for the MoE layer (top-k 1, 2 and 4:
the dense dispatch is exact), 4 pipeline stages at 1, 2 and 4
microbatches, their gradients, and data 2 x pipe 2.  Limits: the
reference's (MoE rtol 1e-4, atol 1e-5; pipeline rtol 1e-5, atol 1e-6;
pipeline gradients rtol 1e-4, atol 1e-5)."""

import numpy
import pytest

import jax
import jax.numpy as jnp

from tests import torch_ranks
from tests.torch_spawn import spawn
from veles_tpu.parallel.mesh import make_mesh
from veles_tpu.parallel.moe import (init_moe_params, moe_apply,
                                    moe_reference, shard_moe_params)

pytestmark = pytest.mark.dist


def _stage_fn(params, x):
    return jnp.tanh(jnp.dot(x, params["w"],
                            preferred_element_type=jnp.float32) +
                    params["b"]).astype(x.dtype)


def _stages(rng, n_stages, width):
    return [{"w": (rng.randn(width, width) * 0.3).astype(numpy.float32),
             "b": numpy.zeros(width, numpy.float32)}
            for _ in range(n_stages)]


def _moe_case(seed, experts=4, features=12, tokens=10):
    rng = numpy.random.RandomState(seed)
    params = init_moe_params(rng, n_experts=experts, features=features,
                             hidden=16, out_features=6)
    return params, rng.randn(tokens, features).astype(numpy.float32)


MOE_DP = _moe_case(6, tokens=16)
MOE = {1: _moe_case(2), 2: MOE_DP, 4: _moe_case(2)}
PIPE_RNG = numpy.random.RandomState(0)
STAGES = _stages(PIPE_RNG, 4, 16)
X = PIPE_RNG.randn(32, 16).astype(numpy.float32)
DP_RNG = numpy.random.RandomState(5)
DP = (_stages(DP_RNG, 2, 16), DP_RNG.randn(16, 16).astype(numpy.float32))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(torch_ranks.moe_world4, 4, tmp_path_factory.mktemp("m4"),
                 MOE, STAGES, X, DP)


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_matches_jax_and_the_oracle(world4, top_k):
    params, x = MOE[top_k]
    want = numpy.asarray(moe_reference(params, x, top_k=top_k))
    mesh = make_mesh({"expert": 4}, jax.devices()[:4])
    jax_out = numpy.asarray(moe_apply(shard_moe_params(mesh, params), x,
                                      mesh, top_k=top_k))
    for rank in world4:
        got = rank[("moe", top_k)]
        numpy.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        numpy.testing.assert_allclose(got, jax_out, rtol=1e-4, atol=1e-5)


def test_moe_data_axis_shards_tokens(world4):
    params, x = MOE_DP
    want = numpy.asarray(moe_reference(params, x, top_k=2))
    for r, rank in enumerate(world4):
        rows = slice((r // 2) * 8, (r // 2 + 1) * 8)
        numpy.testing.assert_allclose(rank["moe_dp"], want[rows],
                                      rtol=1e-4, atol=1e-5)


def _sequential(stages, x):
    for s in stages:
        x = numpy.asarray(_stage_fn(s, x))
    return x


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_pipeline_matches_sequential(world4, microbatches):
    want = _sequential(STAGES, X)
    for rank in world4:
        numpy.testing.assert_allclose(rank[("pipe", microbatches)], want,
                                      rtol=1e-5, atol=1e-6)


def test_pipeline_gradients_match_sequential(world4):
    from veles_tpu.parallel.pipeline import stack_stage_params
    stacked = stack_stage_params(STAGES)

    def loss_seq(params):
        h = X
        for i in range(4):
            h = _stage_fn(jax.tree.map(lambda l: l[i], params), h)
        return jnp.sum(h ** 2)
    want = jax.grad(loss_seq)(stacked)
    for r, rank in enumerate(world4):
        for got, key in zip(rank["pipe_grads"], ("w", "b")):
            numpy.testing.assert_allclose(
                got, numpy.asarray(want[key])[r:r + 1], rtol=1e-4,
                atol=1e-5)


def test_pipeline_data_axis_shards_batch(world4):
    stages, x = DP
    want = _sequential(stages, x)
    for r, rank in enumerate(world4):
        rows = slice((r // 2) * 8, (r // 2 + 1) * 8)
        numpy.testing.assert_allclose(rank["pipe_dp"], want[rows],
                                      rtol=1e-5, atol=1e-6)
