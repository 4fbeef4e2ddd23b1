"""The port's ZeRO-1 layout and step, ``bwd_remat`` and the elastic
``MeshManager`` (``veles_tpu_torch/parallel/mesh.py``,
``compiler.build_train_step(zero=1)``) against the JAX package's.

The slot tables and the ZeRO-form state are pure numpy: equal to JAX's
exactly.  In spawned gloo worlds (``tests/torch_spawn.py``): at world 2
the ZeRO-1 step equals the flat all-reduce step bit for bit (a
reduce-scatter sums like an all-reduce; momentum and adadelta, one
shard a rank and 5 shards over 2 ranks) and ``bwd_remat`` equals no
remat bit for bit (meshed and on one rank); at world 4 the ZeRO-1 step
agrees with JAX's ZeRO-1 step (loss 1e-5 rel, leaves max-rel 1e-5 after
one step and 1e-4 after three), and a ``MeshManager`` through a 4 -> 3
-> 4 schedule moves the shards JAX's ``movement_plan`` names, keeps the
canonical state's digest through each reshard, agrees with JAX's
``MeshManager`` through the same schedule (1e-4), and resumes from its
snapshot with that snapshot's state bit for bit."""

import numpy
import pytest

import jax

from tests import torch_ranks
from tests.test_torch_bucketed import (HYPER, X, Y, _assert_close,
                                       _assert_equal, _host, _mlp_state,
                                       _plans)
from tests.torch_spawn import spawn
from veles_tpu import elastic as jel
from veles_tpu.compiler import build_train_step
from veles_tpu.parallel import make_mesh
from veles_tpu.parallel import mesh as jmesh
from veles_tpu_torch.parallel import mesh as tmesh

pytestmark = [pytest.mark.dist, pytest.mark.mesh]


def _adadelta_state(seed):
    state = _mlp_state(numpy.random.RandomState(seed))
    for entry in state:
        entry["accum2_weights"] = numpy.zeros_like(entry["weights"])
        entry["accum2_bias"] = numpy.zeros_like(entry["bias"])
    return state


STATES = {"momentum": _mlp_state(numpy.random.RandomState(3)),
          "adadelta": _adadelta_state(4)}
STATE = STATES["momentum"]
#: two convs and a pool (kernels 12 and 13's plain paths)
CONV_SPECS = [
    {"type": "conv_str", "n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "conv_tanh", "n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "softmax", "output_sample_shape": 5, "learning_rate": 0.05,
     "gradient_moment": 0.9}]
SCHEDULE = [((0, 1, 2, 3), 2), ((0, 1, 2), 2), ((0, 1, 2, 3), 2)]


def _conv():
    from veles_tpu.models.zoo import build_plans_and_state
    _, state, _ = build_plans_and_state(CONV_SPECS, (6, 6, 2), seed=2)
    rng = numpy.random.RandomState(1)
    x = rng.randn(16, 6, 6, 2).astype(numpy.float32)
    y = rng.randint(0, 5, 16).astype(numpy.int32)
    return CONV_SPECS, _host(state), x, y


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn(torch_ranks.zero_world2, 2, tmp_path_factory.mktemp("z2"),
                 STATES, X, Y, _conv())


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    path = tmp_path_factory.mktemp("z4")
    return spawn(torch_ranks.zero_world4, 4, path, STATE, X, Y, SCHEDULE,
                 str(path / "snapshots"))


# -- the layout (host numpy) -------------------------------------------------


@pytest.mark.parametrize("args", [(5, 2), (16, 4), (16, 3), (4, 4), (7, 3)])
def test_zero_slot_table_equals_jax(args):
    got = tmesh.zero_slot_table(*args)
    assert got.dtype == numpy.int32
    numpy.testing.assert_array_equal(got, jmesh.zero_slot_table(*args))


def test_zero_slot_table_with_owners_equals_jax():
    owners = jel.shard_owners(16, ["r0", "r1", "r2"])
    index = {"r0": 0, "r1": 1, "r2": 2}
    owned = {s: index[m] for s, m in owners.items()}
    numpy.testing.assert_array_equal(tmesh.zero_slot_table(16, 3, owned),
                                     jmesh.zero_slot_table(16, 3, owned))
    with pytest.raises(ValueError):
        tmesh.zero_slot_table(4, 2, owners={0: 0, 1: 0, 2: 0, 3: 1})


@pytest.mark.parametrize("n_devices, n_shards", [(8, 16), (2, None),
                                                 (3, 7), (4, 4)])
def test_zero_state_and_unzero_equal_jax(n_devices, n_shards):
    state = _adadelta_state(5)
    rng = numpy.random.RandomState(7)
    for entry in state:
        for key in tmesh.ZERO_SHARDED_KEYS:
            entry[key] = rng.randn(*entry[key].shape).astype(numpy.float32)
    got = tmesh.zero_state(state, n_devices, n_shards=n_shards)
    want = jmesh.zero_state(state, n_devices, n_shards=n_shards)
    _assert_equal(got, want)
    m = n_shards or n_devices
    _assert_equal(tmesh.unzero_state(got, m), jmesh.unzero_state(want, m))
    _assert_equal(tmesh.unzero_state(got, m), state)
    # a rank's rows are its k slots of the whole matrices
    k = got[0]["zero_slots"].shape[0] // n_devices
    for r in range(n_devices):
        mine = tmesh.zero_state(state, n_devices, n_shards=n_shards,
                                rank=r)
        for e_r, e in zip(mine, got):
            numpy.testing.assert_array_equal(
                e_r["accum_weights"], e["accum_weights"][r * k:(r + 1) * k])


# -- world 2 -------------------------------------------------------------------


@pytest.mark.parametrize("solver, n_shards", [
    ("momentum", None), ("momentum", 5), ("adadelta", None),
    ("adadelta", 5)])
def test_zero1_step_equals_flat_bit_for_bit(world2, solver, n_shards):
    for rank in world2:
        (flat, flat_losses, flat_err, zero, losses, n_err, k,
         rows) = rank[(solver, n_shards)]
        _assert_equal(zero, flat)
        assert losses == flat_losses and n_err == flat_err
        assert rows == k == -(-(n_shards or 2) // 2)


def test_bwd_remat_equals_no_remat(world2):
    for rank in world2:
        runs = rank["remat"]
        _assert_equal(runs[("mesh", True)], runs[("mesh", False)])
        _assert_equal(runs[("one", True)], runs[("one", False)])
    _assert_close(world2[0]["remat"][("mesh", False)],
                  world2[0]["remat"][("one", False)], 1e-5)


# -- world 4 -------------------------------------------------------------------


def test_zero1_step_agrees_with_jax(world4):
    mesh = make_mesh({"data": 4}, jax.devices()[:4])
    step = build_train_step(_plans(), mesh=mesh, zero=1, donate=False)
    s = jmesh.zero_state(STATE, 4)
    s, m = step(s, X, Y, numpy.float32(64))
    one = jmesh.unzero_state(s, 4)
    losses = [float(m["loss"])]
    for _ in range(2):
        s, m = step(s, X, Y, numpy.float32(64))
        losses.append(float(m["loss"]))
    three = jmesh.unzero_state(s, 4)
    for rank in world4:
        full1, got_losses, full3 = rank["zero"]
        _assert_close(full1, one, 1e-5)
        _assert_close(full3, three, 1e-4)
        for got, want in zip(got_losses, losses):
            assert abs(got - want) <= 1e-5 * abs(want)


def _jax_manager():
    manager = jmesh.MeshManager(_plans(), [dict(e) for e in STATE],
                                devices=jax.devices()[:4], n_shards=16,
                                donate=False)
    losses = []
    for members, steps in SCHEDULE:
        manager.submit_membership([jax.devices()[i] for i in members])
        for _ in range(steps):
            losses.append(float(manager.step(
                X[:48], Y[:48], numpy.float32(48))["loss"]))
    return manager.canonical_state(), losses


def test_mesh_manager_reshards_4_3_4_as_jax(world4):
    keys = {n: ["r%d" % r for r in range(n)] for n in (3, 4)}
    prev = jel.shard_owners(16, keys[4])
    plans = []
    for members, _ in SCHEDULE[1:]:
        now = jel.shard_owners(16, keys[len(members)], previous=prev)
        plans.append((jel.movement_plan(prev, now), now))
        prev = now
    want_state, want_losses = _jax_manager()
    digests = set()
    for r, rank in enumerate(world4):
        log, losses, final, digest, shard_bytes, gauges = rank["manager"]
        assert len(log) == 2
        for (before, after, moved, nbytes, size, cached, owners,
             _), (plan, now) in zip(log, plans):
            assert before == after          # a reshard moves rows only
            assert moved == plan["n_moved"] and owners == now
            assert nbytes == moved * shard_bytes
        assert [entry[4] for entry in log] == [3, 4]
        # rejoining the first member set reuses its step
        assert [entry[5] for entry in log] == [False, True]
        got = [loss for loss in losses if loss is not None]
        assert len(got) == (6 if r < 3 else 4)
        if r < 3:
            for a, b in zip(got, want_losses):
                assert abs(a - b) <= 1e-5 * abs(b)
        _assert_close(final, want_state, 1e-4)
        digests.add(digest)
        assert gauges["size"] == 4 and gauges["epoch"] == 2
        assert gauges["reshards"] == 2
    assert len(digests) == 1            # every rank holds one state


def test_mesh_manager_resumes_from_its_snapshot(world4):
    for rank in world4:
        log = rank["manager"][0]
        restored, applied, epoch, loss = rank["resumed"]
        assert restored == log[-1][0]
        assert applied == log[-1][7] and epoch == 1
        assert loss is not None and numpy.isfinite(loss)
