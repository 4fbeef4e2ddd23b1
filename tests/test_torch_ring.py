"""The port's ring and Ulysses sequence-parallel attention
(``veles_tpu_torch/parallel/ring.py``) against the JAX package's and its
single-device oracle, mirroring tests/test_ring.py: a seq axis of 4
ranks, a data 2 x seq 2 mesh, and one spawn of 8 ranks for data 2 x
seq 2 x model 2.  Each rank computes its shard; the test compares it
with the matching block of JAX's global result.  Limits: the
reference's (rtol 2e-4, atol 2e-5; gradients rtol 2e-3, atol 2e-4; bf16
2e-2)."""

import numpy
import pytest

import jax
import jax.numpy as jnp

from tests import torch_ranks
from tests.torch_spawn import spawn
from veles_tpu.parallel.mesh import make_mesh
from veles_tpu.parallel.ring import (attention_reference, ring_attention,
                                     ulysses_attention)

pytestmark = pytest.mark.dist


def _qkv(rng, batch=2, seq=64, heads=8, depth=16):
    shape = (batch, seq, heads, depth)
    return tuple(rng.randn(*shape).astype(numpy.float32) for _ in range(3))


QKV = _qkv(numpy.random.RandomState(0), seq=32)
SMALL = _qkv(numpy.random.RandomState(4), batch=2, seq=32, heads=4, depth=8)
BF16 = _qkv(numpy.random.RandomState(6), batch=2, seq=32, heads=4, depth=8)
DP = _qkv(numpy.random.RandomState(2), batch=4, seq=32, heads=4)
THREE_D = _qkv(numpy.random.RandomState(5), batch=4, seq=16, heads=2,
               depth=8)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(torch_ranks.ring_world4, 4, tmp_path_factory.mktemp("r4"),
                 QKV, SMALL, BF16, DP)


def _block(array, rank, splits):
    """Rank ``rank``'s block of a global array: splits is a list of
    (dim, axis size), the last axis varying fastest."""
    coords, rest = [], rank
    for _, size in reversed(splits):
        coords.append(rest % size)
        rest //= size
    coords.reverse()
    for (dim, size), c in zip(splits, coords):
        step = array.shape[dim] // size
        array = numpy.take(array, range(c * step, (c + 1) * step), axis=dim)
    return array


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_attention_matches_jax_and_the_oracle(world4, kind, causal):
    mesh = make_mesh({"seq": 4}, jax.devices()[:4])
    fn = ring_attention if kind == "ring" else ulysses_attention
    jax_out = numpy.asarray(fn(*QKV, mesh, causal=causal))
    want = numpy.asarray(attention_reference(*QKV, causal=causal))
    for r, rank in enumerate(world4):
        got = rank[(kind, causal)]
        numpy.testing.assert_allclose(got, _block(want, r, [(1, 4)]),
                                      rtol=2e-4, atol=2e-5)
        numpy.testing.assert_allclose(got, _block(jax_out, r, [(1, 4)]),
                                      rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["grads", "ulysses_grads"])
def test_attention_gradients_match_the_oracle(world4, kind):
    def loss_ref(q, k, v):
        return (attention_reference(q, k, v, causal=True) ** 2).sum()
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(*SMALL)
    for rank in world4:
        for g, w in zip(rank[kind], want):
            numpy.testing.assert_allclose(g, numpy.asarray(w), rtol=2e-3,
                                          atol=2e-4)


def test_ring_attention_bf16_matches_the_oracle(world4):
    qb, kb, vb = (jnp.asarray(t, jnp.bfloat16) for t in BF16)
    want = numpy.asarray(attention_reference(qb, kb, vb, causal=True)
                         .astype(jnp.float32))
    for r, rank in enumerate(world4):
        numpy.testing.assert_allclose(rank["bf16"],
                                      _block(want, r, [(1, 4)]),
                                      rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["dp_ring", "dp_ulysses"])
def test_data_axis_shards_the_batch(world4, kind):
    want = numpy.asarray(attention_reference(*DP, causal=True))
    for r, rank in enumerate(world4):
        numpy.testing.assert_allclose(
            rank[kind], _block(want, r, [(0, 2), (1, 2)]), rtol=2e-4,
            atol=2e-5)


def test_ring_attention_3d_mesh_dp_sp_tp(tmp_path):
    ranks = spawn(torch_ranks.ring_world8, 8, tmp_path, THREE_D)
    want = numpy.asarray(attention_reference(*THREE_D, causal=True))
    for r, got in enumerate(ranks):
        numpy.testing.assert_allclose(
            got, _block(want, r, [(0, 2), (1, 2), (2, 2)]), rtol=2e-4,
            atol=2e-5)
