"""The port's SPMD data plane (``veles_tpu_torch/parallel/bucketed.py``,
``compiler.build_train_step(mesh=..., grad_bucket_mb=...)``) against the
JAX package's, on the same seeded numpy inputs.

The JAX side runs in this process on the conftest's virtual CPU devices
(a mesh of the first 2 or 4); the port's in spawned gloo worlds of 2 and
4 ranks (``tests/torch_spawn.py``), each rank passing its rows of the
batch.  Limits: ``plan_buckets`` and ``comm_receipt`` equal JAX's
exactly (pure Python over shapes); any bucketing equals the flat bucket
bit for bit at world 2 (a sum of two terms does not depend on the
split); the SPMD step against JAX's: loss within 1e-5 rel, every leaf
within max-rel 1e-5 after one step and 1e-4 after three; the keyed
step's rank-r dropout mask equals JAX's ``fold_in(key, r)`` mask bit for
bit; the bf16-compressed sum of the same input gradients equals JAX's
bit for bit (both round each bf16 sum of two bf16 values once)."""

import math

import numpy
import pytest

import jax
from jax.sharding import PartitionSpec as P

from tests import torch_ranks
from tests.torch_spawn import spawn
from veles_tpu.compiler import LayerPlan, build_train_step
from veles_tpu.models.all2all import All2AllSoftmax, All2AllTanh
from veles_tpu.models.dropout import DropoutForward
from veles_tpu.parallel import bucketed as jbucketed
from veles_tpu.parallel import make_mesh
from veles_tpu.parallel.mesh import shard_map
from veles_tpu_torch.parallel import bucketed as tbucketed

pytestmark = pytest.mark.dist

HYPER = {"learning_rate": 0.1, "gradient_moment": 0.9}


def _plans(hyper=HYPER):
    return [LayerPlan(All2AllTanh, hyper=dict(hyper)),
            LayerPlan(All2AllSoftmax, hyper=dict(hyper))]


def _mlp_state(rng, dims=(16, 32, 4)):
    out = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        out.append({
            "weights": rng.randn(fi, fo).astype(numpy.float32) * 0.1,
            "bias": rng.randn(fo).astype(numpy.float32) * 0.01,
            "accum_weights": numpy.zeros((fi, fo), numpy.float32),
            "accum_bias": numpy.zeros(fo, numpy.float32),
            "accum2_weights": None, "accum2_bias": None})
    return out


def _batch(rng, n=64, fan_in=16, classes=4):
    labels = (numpy.arange(n) % classes).astype(numpy.int32)
    centers = rng.randn(classes, fan_in).astype(numpy.float32) * 2
    x = centers[labels] + rng.randn(n, fan_in).astype(numpy.float32) * 0.2
    return x.astype(numpy.float32), labels


def _host(state):
    return [{k: None if v is None else numpy.asarray(v)
             for k, v in e.items()} for e in state]


def _max_rel(a, b):
    a = numpy.asarray(a, numpy.float64)
    b = numpy.asarray(b, numpy.float64)
    return float(numpy.abs(a - b).max() / max(numpy.abs(b).max(), 1e-12))


def _assert_close(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            if w[key] is None:
                assert g[key] is None
                continue
            assert _max_rel(g[key], w[key]) <= tol, (i, key)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        for key in w:
            if w[key] is not None:
                numpy.testing.assert_array_equal(g[key], w[key],
                                                 err_msg=key)


STATE = _mlp_state(numpy.random.RandomState(5))
X, Y = _batch(numpy.random.RandomState(6))
GRAD_RNG = numpy.random.RandomState(8)
#: per-rank input gradients of the compression check
GRADS = [[{"weights": GRAD_RNG.randn(16, 32).astype(numpy.float32),
           "bias": GRAD_RNG.randn(32).astype(numpy.float32)},
          {"weights": GRAD_RNG.randn(32, 4).astype(numpy.float32),
           "bias": GRAD_RNG.randn(4).astype(numpy.float32)}]
         for _ in range(2)]
RING_ROWS = [numpy.random.RandomState(2).randn(2, n).astype(numpy.float32)
             for n in (1000, 1001, 7)]
KSTATE = [_mlp_state(numpy.random.RandomState(9))[0], {
    "weights": None, "bias": None, "accum_weights": None,
    "accum_bias": None, "accum2_weights": None, "accum2_bias": None},
    _mlp_state(numpy.random.RandomState(10))[1]]
KSEED = 7
MSE_RNG = numpy.random.RandomState(9)
MSE = ([{"weights": MSE_RNG.randn(8, 8).astype(numpy.float32) * 0.1,
         "bias": numpy.zeros(8, numpy.float32),
         "accum_weights": numpy.zeros((8, 8), numpy.float32),
         "accum_bias": numpy.zeros(8, numpy.float32),
         "accum2_weights": None, "accum2_bias": None}],
       MSE_RNG.randn(16, 8).astype(numpy.float32),
       MSE_RNG.randn(16, 8).astype(numpy.float32))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn(torch_ranks.bucketed_world, 2,
                 tmp_path_factory.mktemp("bucketed2"), STATE, X, Y, GRADS,
                 RING_ROWS, (HYPER, KSTATE, X, Y, KSEED), MSE)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(torch_ranks.bucketed_world, 4,
                 tmp_path_factory.mktemp("bucketed4"), STATE, X, Y, None,
                 None, None, None)


def _jax_spmd(n, steps, **kw):
    mesh = make_mesh({"data": n}, jax.devices()[:n])
    step = build_train_step(_plans(), mesh=mesh, grad_bucket_mb=0.001,
                            donate=False, **kw)
    s, losses = [dict(e) for e in STATE], []
    for _ in range(steps):
        s, m = step(s, X, Y, numpy.float32(64))
        losses.append(float(m["loss"]))
    return _host(s), losses, m


# -- the plan (pure Python over shapes) -------------------------------------


class _Leaf(object):
    def __init__(self, shape):
        self.shape = shape
        self.dtype = numpy.dtype(numpy.float32)


def _vgg16_grad_leaves():
    """VGG16 (config D)'s 32 parameter leaves in JAX's pytree order."""
    leaves, ci = [], 3
    for co in (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
               512):
        leaves += [_Leaf((co,)), _Leaf((3, 3, ci, co))]
        ci = co
    for fi, fo in ((25088, 4096), (4096, 4096), (4096, 1000)):
        leaves += [_Leaf((fo,)), _Leaf((fi, fo))]
    return leaves


@pytest.mark.parametrize("mb", [0.001, 25.0, float("inf")])
def test_plan_buckets_equals_jax_on_vgg16(mb):
    leaves = _vgg16_grad_leaves()
    assert len(leaves) == 32
    target = mb if math.isinf(mb) else mb * 2.0 ** 20
    got = tbucketed.plan_buckets(leaves, target)
    want = jbucketed.plan_buckets(leaves, target)
    assert [b.slices for b in got.buckets] == \
        [b.slices for b in want.buckets]
    assert (got.n_leaves, got.total_elems, got.total_bytes) == \
        (want.n_leaves, want.total_elems, want.total_bytes)
    assert [b.nbytes for b in got.buckets] == \
        [b.nbytes for b in want.buckets]


def test_grad_leaves_follow_jax_pytree_order():
    from veles_tpu_torch.compiler import _grad_order
    state = [{"weights": 1, "bias": 2}, {"weights": None, "bias": None},
             {"weights": 3, "bias": None}]
    assert _grad_order(state) == [(0, "bias"), (0, "weights"),
                                  (2, "weights")]
    assert [leaf for leaf in jax.tree_util.tree_leaves(
        [{"weights": s["weights"], "bias": s["bias"]} for s in state])] == \
        [leaf for _, leaf in tbucketed.grad_leaves(
            [{"weights": s["weights"], "bias": s["bias"]} for s in state])]


@pytest.mark.parametrize("kw", [
    dict(n_devices=8), dict(n_devices=4, bucket_bytes=1000.0),
    dict(n_devices=2, step_seconds=0.05, compress="bf16"),
    dict(n_devices=16, bucket_bytes=25 * 2.0 ** 20, step_seconds=0.3)])
def test_comm_receipt_equals_jax(kw):
    leaves = _vgg16_grad_leaves()
    assert tbucketed.comm_receipt(leaves, **kw) == \
        jbucketed.comm_receipt(leaves, **kw)


def test_publish_comm_receipt_sets_the_gauges():
    from veles_tpu_torch.observe.metrics import MetricsRegistry
    reg = MetricsRegistry()
    receipt = tbucketed.comm_receipt(_vgg16_grad_leaves(), 4,
                                     step_seconds=0.1)
    tbucketed.publish_comm_receipt(receipt, registry=reg)
    assert reg.peek("comm.buckets").value == len(receipt["bucket_bytes"])
    assert reg.peek("comm.allreduce_bytes").value == \
        receipt["allreduce_bytes"]
    assert reg.peek("comm.overlap_pct").value == \
        receipt["model"]["overlap_pct"]


# -- world 2 -------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(torch_ranks.BUCKET_CASES))
def test_bucketed_equals_flat_bit_for_bit(world2, case):
    for rank in world2:
        flat_state, flat_losses, flat_err, _ = rank["case_inf"]
        state, losses, n_err, buckets = rank["case_" + case]
        _assert_equal(state, flat_state)
        assert losses == flat_losses and n_err == flat_err
        want = len(tbucketed.plan_buckets(
            [numpy.zeros(s, numpy.float32)
             for s in ((32,), (16, 32), (4,), (32, 4))],
            torch_ranks.BUCKET_CASES[case] * 2.0 ** 20).buckets)
        assert buckets == want
    # every rank holds the same state
    _assert_equal(world2[1]["case_" + case][0], world2[0]["case_" + case][0])


@pytest.mark.parametrize("world", [2, 4])
def test_spmd_step_agrees_with_jax(world, world2, world4):
    ranks = world2 if world == 2 else world4
    j1, jl1, jm1 = _jax_spmd(world, 1)
    j3, jl3, _ = _jax_spmd(world, 3)
    for rank in ranks:
        s1, losses, m1, s3 = rank["spmd"]
        _assert_close(s1, j1, 1e-5)
        _assert_close(s3, j3, 1e-4)
        for got, want in zip(losses, jl3):
            assert abs(got - want) <= 1e-5 * abs(want)
        assert m1["n_err"] == int(jm1["n_err"])
        assert abs(m1["grad_norm"] - float(jm1["grad_norm"])) <= \
            1e-5 * float(jm1["grad_norm"])


@pytest.mark.parametrize("world", [2, 4])
def test_one_all_reduce_a_bucket(world, world2, world4):
    """A step issues one all-reduce a bucket, plus the loss and the
    error count's sums."""
    for rank in (world2 if world == 2 else world4):
        counts, buckets = rank["counts"]
        assert counts["all-reduce"] == buckets + 2 == counts["total"]
        assert buckets == len(tbucketed.plan_buckets(
            [numpy.zeros(s, numpy.float32)
             for s in ((32,), (16, 32), (4,), (32, 4))],
            0.001 * 2.0 ** 20).buckets) == 3


def test_bf16_sum_equals_jax(world2):
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    stacked = jax.tree.map(lambda *leaves: numpy.stack(leaves), *GRADS)

    def reduce(grads):
        grads = jax.tree.map(lambda g: g[0], grads)
        return jbucketed.bucketed_all_reduce(
            grads, "data", bucket_bytes=256, compress="bf16", axis_size=2)
    fn = shard_map(reduce, mesh=mesh, in_specs=(P("data"),),
                   out_specs=P(), check_vma=False)
    want = _host(fn(stacked))
    for rank in world2:
        _assert_equal(rank["bf16_reduce"], want)


def test_bf16_step_trains_and_skips_poison_bit_exactly(world2):
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    jstep = build_train_step(_plans(), mesh=mesh, grad_bucket_mb=0.001,
                             grad_compress="bf16", donate=False)
    js, jm = jstep([dict(e) for e in STATE], X, Y, numpy.float32(64))
    for rank in world2:
        state, m, poisoned, pm = rank["bf16_step"]
        assert m["finite"] and abs(m["loss"] - float(jm["loss"])) <= \
            1e-5 * float(jm["loss"])
        _assert_close(state, _host(js), 1e-5)
        assert not pm["finite"] and pm["skipped"] == 1
        _assert_equal(poisoned, STATE)


def test_ring_impl_agrees_and_sums(world2):
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    jstep = build_train_step(_plans(), mesh=mesh, grad_bucket_mb=0.001,
                             grad_allreduce_impl="ring", donate=False)
    s = [dict(e) for e in STATE]
    for _ in range(3):
        s, _ = jstep(s, X, Y, numpy.float32(64))
    for rank in world2:
        _assert_close(rank["ring_step"], _host(s), 1e-4)
        for got, rows in zip(rank["ring_sums"], RING_ROWS):
            numpy.testing.assert_allclose(got, rows.sum(axis=0),
                                          rtol=1e-6, atol=1e-6)


def test_keyed_step_folds_the_rank_into_the_key(world2):
    import jax.numpy as jnp
    key = jax.random.PRNGKey(KSEED)
    jplans = [LayerPlan(All2AllTanh, hyper=dict(HYPER)),
              LayerPlan(DropoutForward, static={"dropout_ratio": 0.5}),
              LayerPlan(All2AllSoftmax, hyper=dict(HYPER))]
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    jstep = build_train_step(jplans, mesh=mesh, grad_bucket_mb=0.001,
                             donate=False)
    js, jm = jstep([dict(e) for e in KSTATE], X, Y, numpy.float32(64), key)
    for r, rank in enumerate(world2):
        masks, state, m = rank["keyed"]
        assert len(masks) == 1
        want = numpy.asarray(DropoutForward.make_mask(
            jax.random.fold_in(jax.random.fold_in(key, r), 1), (32, 32),
            0.5, jnp.float32))
        numpy.testing.assert_array_equal(masks[0], want)
        _assert_close(state, _host(js), 1e-5)
        assert abs(m["loss"] - float(jm["loss"])) <= \
            1e-5 * float(jm["loss"])
    # two ranks, two masks
    assert not numpy.array_equal(world2[0]["keyed"][0][0],
                                 world2[1]["keyed"][0][0])


def test_short_minibatch_mse_mask_is_global(world2):
    jplans = [LayerPlan(All2AllTanh, hyper={"learning_rate": 0.1})]
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    jstep = build_train_step(jplans, loss="mse", mesh=mesh,
                             grad_bucket_mb=0.001, donate=False)
    js, jm = jstep([dict(e) for e in MSE[0]], MSE[1], MSE[2],
                   numpy.float32(11))
    for rank in world2:
        state, m, ref_state, ref_m = rank["mse"]
        _assert_close(state, ref_state, 1e-5)
        _assert_close(state, _host(js), 1e-5)
        assert abs(m["mse_sum"] - ref_m["mse_sum"]) <= \
            1e-5 * ref_m["mse_sum"]
        assert abs(m["mse_sum"] - float(jm["mse_sum"])) <= \
            1e-5 * float(jm["mse_sum"])


def test_meshed_step_is_freed_without_the_cyclic_collector(world2, world4):
    # a step kept by a cycle (its gradient sync holding it back) would
    # keep its graphs' memory on the card until a collection: building
    # meshed steps in a loop ran the card out of memory
    for rank in world2 + world4:
        assert rank["freed"] == {True: True, False: True}
