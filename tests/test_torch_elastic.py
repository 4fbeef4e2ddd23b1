"""The port's elastic-fleet bookkeeping (``veles_tpu_torch/elastic.py``)
against the JAX package's (``veles_tpu/elastic.py``): pure Python, so
every function must return the same values on the same arguments,
exactly.  Mirrors tests/test_elastic.py's math and FleetView tests and
tests/test_mesh.py's ownership tests; the server's tests there are
tests/test_torch_elastic_server.py's, the farm's
tests/test_torch_jobfarm.py's."""

import math

import pytest

from veles_tpu import elastic as jel
from veles_tpu_torch import elastic as tel

SICK = (0.0, -3.0, float("nan"), float("inf"), float("-inf"), None,
        "garbage", [1], 2.5, 1e-9, 1e9)


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("power", SICK, ids=repr)
def test_effective_power_equals_jax(power):
    assert _same(tel.effective_power(power), jel.effective_power(power))


@pytest.mark.parametrize("total, powers", [
    (100, {"a": 3.0, "b": 1.0}),
    (10, {"a": 1.0, "b": 1.0, "c": 1.0}),
    (100, {}), (None, {"a": 1.0}), (-5, {"a": 1.0}),
    (0, {"a": 1.0, "b": 2.0}),
    (9, {"a": 0.0, "b": -1.0, "c": float("nan")}),
    (4, {"a": 0.0, "b": 3.0}),
    (1797, {"s%d" % i: 0.5 + 0.37 * i for i in range(7)}),
])
def test_power_shares_equals_jax(total, powers):
    got = tel.power_shares(total, powers)
    assert got == jel.power_shares(total, powers)
    if powers and total is not None and total >= 0:
        assert sum(got.values()) == total


@pytest.mark.parametrize("args, kwargs", [
    ((10.0, 2.0, 5.0), {}), ((0.01, 2.0, 5.0), {}),
    ((float("nan"), 2.0, 5.0), {}), ((-3.0, 2.0, 5.0), {}),
    ((None, 2.0, 5.0), {}), (("x", 2.0, 5.0), {}),
    ((10.0, 2.0, 0.1), dict(owner_power=1.0, fleet_powers=(1.0, 1.0, 4.0))),
    ((10.0, 2.0, 0.1), dict(owner_power=4.0, fleet_powers=(1.0, 1.0, 4.0))),
    ((10.0, 1.0, 0.1), dict(owner_power=1e-9, fleet_powers=(1e-9, 1e3))),
    ((10.0, 1.0, 5.0), dict(owner_power=1e9, fleet_powers=(1e9, 1.0))),
    ((1.0, 2.0, 0.5), dict(owner_power=0.0, fleet_powers=(-1.0, 0.0))),
    ((10.0, 2.0, 0.1), dict(owner_power=3.0, fleet_powers=(3.0,))),
    ((10.0, 2.0, 0.1), dict(owner_power=2.0, mean_power=5.0)),
])
def test_speculation_threshold_equals_jax(args, kwargs):
    assert _same(tel.speculation_threshold(*args, **kwargs),
                 jel.speculation_threshold(*args, **kwargs))


def test_fleet_mean_power_and_bound_equal_jax():
    assert tel.POWER_SCALE_BOUND == jel.POWER_SCALE_BOUND
    for fleet in ((), (0.0,), (1.0, 3.0), (float("nan"), 2.0)):
        assert tel.fleet_mean_power(fleet) == jel.fleet_mean_power(fleet)


def _drive_fleet(mod):
    """One scripted FleetView history; every observable after each
    step."""
    fleet = mod.FleetView(throughput_alpha=0.5)
    seen = []

    def snap():
        seen.append((fleet.membership_epoch, len(fleet),
                     sorted(fleet.powers()), fleet.shares(30),
                     fleet.shares(100, by="throughput"),
                     fleet.throughputs(), fleet.throughput("ghost", None)))
    snap()
    for op in (("join", "a", 2.0), ("join", "b", 1.0),
               ("obs", "a", 300.0), ("obs", "a", 100.0),
               ("obs", "a", 100.0), ("obs", "b", 50.0),
               ("obs", "b", float("nan")), ("obs", "b", "junk"),
               ("leave", "a"), ("leave", "a"), ("join", "a", 0.0),
               ("join", "c", float("inf")), ("obs", "c", -5.0)):
        if op[0] == "join":
            seen.append(fleet.join(op[1], op[2]))
        elif op[0] == "leave":
            seen.append(fleet.leave(op[1]))
        else:
            seen.append(fleet.observe_throughput(op[1], op[2]))
        snap()
    return seen


def test_fleet_view_epochs_and_ema_equal_jax():
    got, want = _drive_fleet(tel), _drive_fleet(jel)
    assert got == want
    # the epochs move on joins and real leaves only
    assert [s for s in got if isinstance(s, int)][:4] == [1, 2, 3, 3]


@pytest.mark.parametrize("n_shards, members", [
    (16, ["d0", "d1", "d2", "d3"]), (16, ["d0", "d1", "d2"]),
    (7, ["r0", "r1", "r2"]), (32, ["r%d" % i for i in range(5)]),
    (4, ["x"]), (12, ["r0", "r1", "r2", "r3"])])
def test_shard_owners_equals_jax(n_shards, members):
    owners = tel.shard_owners(n_shards, members)
    assert owners == jel.shard_owners(n_shards, members)
    counts = [list(owners.values()).count(m) for m in members]
    assert max(counts) - min(counts) <= 1
    assert sorted(owners) == list(range(n_shards))


def test_churn_owners_and_movement_plan_equal_jax():
    """4 -> 3 -> 4 members and a swap, minimal-move from the previous
    owners each time: the same owners and movement plans."""
    schedule = (["r0", "r1", "r2", "r3"], ["r0", "r1", "r2"],
                ["r0", "r1", "r2", "r3"], ["r0", "r2", "r3", "r4"])
    prev = {"port": None, "jax": None}
    for members in schedule:
        got = tel.shard_owners(16, members, previous=prev["port"])
        want = jel.shard_owners(16, members, previous=prev["jax"])
        assert got == want
        assert tel.movement_plan(prev["port"], got) == \
            jel.movement_plan(prev["jax"], want)
        prev = {"port": got, "jax": want}
    # a leave moves only the departed member's shards
    four = tel.shard_owners(16, schedule[0])
    three = tel.shard_owners(16, schedule[1], previous=four)
    moved = tel.movement_plan(four, three)["moved"]
    assert moved == sorted(s for s, m in four.items() if m == "r3")


def test_fleet_snapshot_reads_the_port_registry():
    from veles_tpu_torch.observe.metrics import MetricsRegistry
    reg = MetricsRegistry()
    assert tel.fleet_snapshot(reg) == {}
    reg.gauge("elastic.membership_epoch").set(3)
    reg.counter("elastic.reshards").inc(2)
    assert tel.fleet_snapshot(reg) == {"membership_epoch": 3,
                                       "reshards": 2}
