"""The port's schedule autotuner (veles_tpu_torch/tune/) against the JAX
package's (veles_tpu/tune/), case by case where the behavior is shared:

- cache keys, the on-disk table, concurrent writers, corrupt files and
  malformed or out-of-bounds entries (a warning and the kernel's static
  plan, never an error), stale kernel versions, provenance, counters;
- the memoized consult in each of the five wrappers, before the call
  branches on the device: a planted schedule reaches the kernel's C
  entry (a recording fake library stands in for the card) and shows in
  its plan, ``record_specs`` records the call, an explicit ``blocks``
  skips the consult;
- tuned equals static bit for bit on representable operands, and the
  port's matmul under a planted ``bk`` agrees with JAX's under the same
  ``bk`` (interpret mode) within the matmul parity tolerance;
- the measurement discipline, the GA tuner (memo, quantization,
  feasibility before launch, cache hits, invalid hits, model fitness),
  ``sweep_candidates`` and ``autotune_matmul``;
- the walk of one raw train step against JAX's walk of the lowering;
- the farmed tuner (two in-process farm workers; a ``--worker`` joining
  a master), which takes the card unless ``-d cpu`` asks for the CPU;
- the CLI (``-d cpu``), the bank's publish, merge and watcher pickup,
  a JAX bank merged as invalid, the serve engine's ``tune`` receipt.

Every test sees a private empty cache in each package: the conftest
redirects ``VELES_SCHEDULE_CACHE`` to tmp, which both read.
"""

import json
import logging
import os
import sys
import threading

import numpy
import pytest
import torch

from veles_tpu_torch.ops import attention, conv_vjp, matmul_int8, pool_bwd
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.tune import cache as tcache
from veles_tpu_torch.tune import measure, spec as tspec
from veles_tpu_torch.tune.autotune import (PENALTY, ScheduleTuner,
                                           evaluate_candidate,
                                           sweep_candidates)

#: the module, not the function the package re-exports under its name
matmul_mod = sys.modules["veles_tpu_torch.ops.matmul"]

CPU = torch.device("cpu")


def _ints(rng, shape, lo=-3, hi=4):
    """Exactly representable f32 operands: every association sums them
    without rounding, so tuned against static may demand bit equality."""
    return torch.as_tensor(rng.randint(lo, hi, shape).astype(numpy.float32))


def _plant(spec, schedule, source="test", fitness=None, kind="cpu"):
    """One cache entry for ``spec``, keyed as the consult looks it up."""
    digest, payload = tcache.schedule_key(
        spec["op"], spec["shape"], spec["dtype"], spec["precision_level"],
        kind, spec["extra"])
    tcache.cache_for().put(digest, payload, schedule, source=source,
                           fitness=fitness)
    return digest


def _tuner(spec, **kwargs):
    kwargs.setdefault("fitness", "compile")
    kwargs.setdefault("device", "cpu")
    kwargs.setdefault("rng", RandomGenerator("t", seed=3))
    return ScheduleTuner(spec, **kwargs)


# -- one call of each family at a small shape --------------------------------

#: op -> (spec, the wrapper's call on seeded CPU operands, a planted
#: non-default schedule)
def _case(op, rng, device=CPU):
    def put(x):
        return x.to(device)
    if op == "matmul":
        a, b = put(_ints(rng, (24, 200))), put(_ints(rng, (200, 48)))
        return (tspec.matmul_spec(24, 200, 48, "float32", 0),
                lambda: matmul_mod.matmul(a, b), {"bk": 64, "splits": 2})
    if op == "matmul_int8":
        a = put(torch.as_tensor(rng.randint(-127, 128, (40, 96)),
                                dtype=torch.int8))
        b = put(torch.as_tensor(rng.randint(-127, 128, (96, 24)),
                                dtype=torch.int8))
        return (tspec.matmul_int8_spec(40, 96, 24),
                lambda: matmul_int8.matmul_int8(a, b, 1.0),
                {"config": 2, "splits": 2})
    if op == "conv_vjp":
        x = put(_ints(rng, (2, 6, 6, 3)))
        y, dy = put(torch.ones(2, 6, 6, 4)), put(_ints(rng, (2, 6, 6, 4)))
        return (tspec.conv_vjp_spec((2, 6, 6, 3), 3, 3, 4, (6, 6),
                                    "float32", 0, padding=(1, 1, 1, 1),
                                    activation="strict_relu"),
                lambda: conv_vjp.conv_wgrad(
                    x, y, dy, activation="strict_relu", ksize=(3, 3),
                    padding=(1, 1, 1, 1)),
                {"tile": [128, 64], "chunk": 32})
    if op == "attention":
        q, k, v = (put(torch.as_tensor(rng.randn(3, 40, 8).astype(
            numpy.float32))) for _ in range(3))
        return (tspec.attention_spec(3, 40, 8, "float32", 0),
                lambda: attention.attention_fwd(q, k, v, 0.35),
                {"grid": 2})
    from veles_tpu_torch.models.pooling import _pool
    x = put(_ints(rng, (2, 8, 8, 3), -5, 6))
    y = _pool(x, (2, 2), (2, 2), float("-inf"),
              torch.nn.functional.max_pool2d).contiguous()
    dy = put(_ints(rng, tuple(y.shape)))
    return (tspec.pool_bwd_spec((2, 8, 8, 3), (4, 4), (2, 2), (2, 2),
                                "float32"),
            lambda: pool_bwd.max_pool_bwd(x, y, dy, window=(2, 2),
                                          sliding=(2, 2)),
            {"design": "overlap", "lanes_x": 4})


OPS = ("matmul", "matmul_int8", "conv_vjp", "attention", "pool_bwd")


# -- cache keys ---------------------------------------------------------------


def test_schedule_key_invariance_and_sensitivity():
    """Same spec -> same digest; every coordinate (shape, dtype, level,
    device kind, kernel version, op) changes it; the payload names the
    torch version where JAX's names jax."""
    base = ("matmul", (64, 128, 128), "float32", 0, "cpu",
            {"kernel_version": 1})
    d0, payload = tcache.schedule_key(*base)
    assert d0 == tcache.schedule_key(*base)[0]
    assert payload["shape"] == [64, 128, 128]
    assert payload["torch"] == torch.__version__ and "jax" not in payload
    variants = [
        ("matmul", (64, 128, 256), "float32", 0, "cpu",
         {"kernel_version": 1}),
        ("matmul", (64, 128, 128), "bfloat16", 0, "cpu",
         {"kernel_version": 1}),
        ("matmul", (64, 128, 128), "float32", 1, "cpu",
         {"kernel_version": 1}),
        ("matmul", (64, 128, 128), "float32", 0, "NVIDIA H100 80GB HBM3",
         {"kernel_version": 1}),
        ("matmul", (64, 128, 128), "float32", 0, "cpu",
         {"kernel_version": 2}),
        ("conv_vjp", (64, 128, 128), "float32", 0, "cpu",
         {"kernel_version": 1}),
    ]
    digests = {tcache.schedule_key(*v)[0] for v in variants}
    assert d0 not in digests and len(digests) == len(variants)


def test_device_kind_is_the_operands_device():
    assert tcache.device_kind("cpu") == "cpu"
    assert tcache.device_kind(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_available():
        assert tcache.device_kind() == "cpu"


def test_specs_key_the_raw_dims_and_the_port_kernel_version():
    from veles_tpu_torch.ops.common import PORT_KERNEL_VERSIONS
    for op in OPS:
        spec, _, _ = _case(op, numpy.random.RandomState(0))
        assert spec["extra"] == {"kernel_version":
                                 PORT_KERNEL_VERSIONS[op]}
    assert tspec.matmul_spec(3, 5, 7, torch.float32, 0)["shape"] == [3, 5, 7]
    assert tspec.conv_vjp_spec((2, 6, 6, 3), 3, 3, 4, (6, 6), "float32",
                               0)["shape"] == [9, 72, 3, 4]


# -- the table ----------------------------------------------------------------


def test_cache_roundtrip_and_len(tmp_path):
    cache = tcache.ScheduleCache(str(tmp_path / "s.json"))
    assert len(cache) == 0 and cache.get("nope") is None
    cache.put("d1", {"op": "matmul"}, {"bk": 64, "splits": 1},
              fitness=-0.5, evals=3)
    reloaded = tcache.ScheduleCache(str(tmp_path / "s.json"))
    entry = reloaded.get("d1")
    assert entry["schedule"] == {"bk": 64, "splits": 1}
    assert entry["fitness"] == -0.5 and entry["evals"] == 3
    assert len(reloaded) == 1


def test_put_merges_concurrent_writers(tmp_path):
    """put() re-reads the file before its read-modify-write: another
    writer's entries survive our save."""
    path = str(tmp_path / "s.json")
    ours = tcache.ScheduleCache(path)
    assert len(ours) == 0
    theirs = tcache.ScheduleCache(path)
    for i in range(3):
        theirs.put("fleet-%d" % i, {"op": "matmul"}, {"bk": 64,
                                                      "splits": 1})
    ours.put("local", {"op": "matmul"}, {"bk": 128, "splits": 2})
    merged = tcache.ScheduleCache(path)
    assert len(merged) == 4 and merged.get("fleet-2") is not None
    assert merged.get("local")["schedule"] == {"bk": 128, "splits": 2}


def test_put_does_not_revert_concurrent_retune(tmp_path):
    path = str(tmp_path / "s.json")
    ours = tcache.ScheduleCache(path)
    ours.put("X", {"op": "matmul"}, {"bk": 64, "splits": 1})
    tcache.ScheduleCache(path).put("X", {"op": "matmul"},
                                   {"bk": 256, "splits": 4})
    ours.put("Y", {"op": "matmul"}, {"bk": 64, "splits": 1})
    final = tcache.ScheduleCache(path)
    assert final.get("X")["schedule"] == {"bk": 256, "splits": 4}
    assert final.get("Y") is not None


def test_threads_putting_at_once_lose_nothing(tmp_path):
    cache = tcache.ScheduleCache(str(tmp_path / "s.json"))

    def writer(i):
        for j in range(5):
            cache.put("d-%d-%d" % (i, j), {"op": "matmul"},
                      {"bk": 64, "splits": 1 + j})
    threads = [threading.Thread(target=writer, args=(i,)) for i in range(6)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert len(tcache.ScheduleCache(str(tmp_path / "s.json"))) == 30


# -- corrupt, malformed, stale ----------------------------------------------


def test_corrupt_cache_file_warns_and_serves_static(caplog):
    cache_dir = os.environ["VELES_SCHEDULE_CACHE"]
    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, "schedules.json"), "w") as fout:
        fout.write("{this is not json")
    rng = numpy.random.RandomState(0)
    a, b = _ints(rng, (16, 200)), _ints(rng, (200, 32))
    with caplog.at_level(logging.WARNING, logger="veles_tpu_torch.tune"):
        out = matmul_mod.matmul(a, b)
    assert any("unreadable" in r.getMessage() for r in caplog.records)
    assert torch.equal(out, matmul_mod.matmul(a, b, blocks=(0, 0, 512)))


@pytest.mark.parametrize("op", OPS)
def test_malformed_entry_warns_once_and_serves_static(op, caplog):
    """A structurally broken schedule is one warning and the static
    plan; the wrapper's answer is the static one."""
    spec, call, _ = _case(op, numpy.random.RandomState(1))
    want = call()
    _plant(spec, {"bogus": [7, 100, 3]})
    with caplog.at_level(logging.WARNING, logger="veles_tpu_torch.tune"):
        got, again = call(), call()
    notes = [r for r in caplog.records if "malformed" in r.getMessage()]
    assert len(notes) == 1
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, b)
    del again


@pytest.mark.parametrize("op,schedule", [
    ("matmul", {"bk": 4096, "splits": 1}),       # bk past ceil(K, 128)
    ("matmul", {"bk": 64, "splits": 99}),        # more splits than tiles
    ("matmul_int8", {"config": 1, "splits": 9}),  # more than the K-steps
    ("conv_vjp", {"tile": [128, 128], "chunk": 32}),  # Co % 128 != 0
    ("attention", {"grid": 10 ** 6}),            # more blocks than items
    ("pool_bwd", {"design": "cells", "lanes_x": 3}),  # not a power of 2
])
def test_entry_out_of_the_calls_bounds_serves_static(op, schedule, caplog):
    spec, _, _ = _case(op, numpy.random.RandomState(2))
    _plant(spec, schedule)
    with caplog.at_level(logging.WARNING, logger="veles_tpu_torch.tune"):
        assert tcache.consult(op, ("probe",), CPU, lambda: spec) is None
    assert any("malformed" in r.getMessage() for r in caplog.records)


def test_stale_kernel_version_is_a_miss(monkeypatch):
    """An entry keyed to an older port kernel version never serves the
    new design: bumping the version turns the planted hit into a miss."""
    from veles_tpu_torch.ops import common
    spec, call, planted = _case("matmul", numpy.random.RandomState(2))
    _plant(spec, planted)
    with tcache.record_specs():
        assert matmul_mod.tuned_schedule(24, 200, 48, "float32", 0,
                                         CPU) == planted
    monkeypatch.setitem(common.PORT_KERNEL_VERSIONS, "matmul",
                        common.PORT_KERNEL_VERSIONS["matmul"] + 1)
    tcache.invalidate()
    assert matmul_mod.tuned_schedule(24, 200, 48, "float32", 0, CPU) is None


def test_provenance_rejects_invalid_entry_like_the_consult(caplog):
    spec, _, _ = _case("matmul", numpy.random.RandomState(3))
    args = (spec["op"], spec["shape"], spec["dtype"],
            spec["precision_level"], spec["extra"])
    _plant(spec, {"bk": 5, "splits": 1})   # not a multiple of 64
    with caplog.at_level(logging.WARNING, logger="veles_tpu_torch.tune"):
        assert tcache.provenance(*args, device="cpu") == "static"


def test_provenance_and_counters():
    spec, _, planted = _case("matmul", numpy.random.RandomState(4))
    args = (spec["op"], spec["shape"], spec["dtype"],
            spec["precision_level"], spec["extra"])
    assert tcache.provenance(*args, device="cpu") == "static"
    _plant(spec, planted)
    assert tcache.provenance(*args, device="cpu") == "tuned"
    before = tcache.tune_counters()
    assert before["entries"] == 1
    assert tcache.schedule_for(*args, device="cpu") == planted
    after = tcache.tune_counters()
    assert after["cache_hits"] == before.get("cache_hits", 0) + 1


# -- the consult -------------------------------------------------------------


def test_consult_is_memoized_and_every_put_clears_the_memo(monkeypatch):
    """A repeated call pays no digest: the memo serves it; a put (or a
    bank merge) clears it, so the next call sees the new entry."""
    spec, _, planted = _case("matmul", numpy.random.RandomState(5))
    keys = []
    real = tcache.schedule_key

    def counting(*args, **kwargs):
        keys.append(args[0])
        return real(*args, **kwargs)
    monkeypatch.setattr(tcache, "schedule_key", counting)
    for _ in range(5):
        assert matmul_mod.tuned_schedule(24, 200, 48, "float32", 0,
                                         CPU) is None
    assert keys == ["matmul"]
    _plant(spec, planted)
    for _ in range(5):
        assert matmul_mod.tuned_schedule(24, 200, 48, "float32", 0,
                                         CPU) == planted
    assert keys == ["matmul", "matmul", "matmul"]   # the put keyed one


def test_consult_counts_hits_and_misses():
    from veles_tpu_torch.observe.metrics import registry
    spec, call, planted = _case("pool_bwd", numpy.random.RandomState(6))
    hits = registry.counter("tune.cache_hits").value
    misses = registry.counter("tune.cache_misses").value
    call()
    assert registry.counter("tune.cache_misses").value == misses + 1
    _plant(spec, planted)
    call()
    assert registry.counter("tune.cache_hits").value == hits + 1


def test_consult_never_raises(monkeypatch, caplog):
    def boom(path=None):
        raise OSError("disk on fire")
    monkeypatch.setattr(tcache, "cache_for", boom)
    spec, call, _ = _case("conv_vjp", numpy.random.RandomState(7))
    with caplog.at_level(logging.WARNING, logger="veles_tpu_torch.tune"):
        assert tcache.consult("conv_vjp", ("x",), CPU, lambda: spec) is None
        call()
    assert any("consult failed" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("op", OPS)
def test_record_specs_sees_cpu_calls(op):
    """Each wrapper consults before it branches on the device, so the
    walk's recording sees CPU calls too, keyed as the spec builder keys
    them."""
    spec, call, _ = _case(op, numpy.random.RandomState(8))
    with tcache.record_specs() as recorded:
        call()
        call()
    assert len(recorded) == 1
    rec = recorded[0]
    assert (rec["op"], rec["shape"], rec["dtype"], rec["device_kind"]) == \
        (op, spec["shape"], spec["dtype"], "cpu")
    assert rec["digest"] == tcache.schedule_key(
        op, spec["shape"], spec["dtype"], spec["precision_level"], "cpu",
        spec["extra"])[0]


def test_explicit_blocks_skip_the_consult():
    rng = numpy.random.RandomState(9)
    a, b = _ints(rng, (8, 128)), _ints(rng, (128, 8))
    q = torch.randn(2, 16, 8)
    with tcache.record_specs() as recorded:
        matmul_mod.matmul(a, b, blocks=(8, 128, 128))
        matmul_mod.matmul(a, b, schedule={"bk": 64, "splits": 1})
        attention.attention_fwd(q, q, q, 0.3, blocks=attention.DEFAULT_BLOCKS)
    assert recorded == []


# -- a planted schedule reaches the kernel ----------------------------------


def _recorded_launch(op, rng, monkeypatch, schedule):
    """Run ``op``'s card path (``_launch``) on CPU tensors against a
    recording fake library; returns (C args, last plan)."""
    from test_torch_gather import patch_recording_launch
    from veles_tpu_torch.ops import common
    calls = patch_recording_launch(monkeypatch)
    monkeypatch.setattr(common, "sm_count", lambda device: 132)
    if op == "matmul":
        monkeypatch.setattr(matmul_mod, "_kernel_function",
                            lambda: common.kernel_function("veles_matmul",
                                                           []))
        monkeypatch.setattr(matmul_mod._launch, "fn", None)
        a, b = torch.zeros(24, 200), torch.zeros(200, 48)
        matmul_mod._launch(a, b, 24, 200, 48, 256, 0, torch.float32,
                           schedule)
        return calls[0], matmul_mod.matmul.last_plan
    if op == "matmul_int8":
        monkeypatch.setattr(matmul_int8._launch, "fn", None)
        a = torch.zeros(40, 96, dtype=torch.int8)
        w_t = torch.zeros(24, 96, dtype=torch.int8)
        ones = torch.ones(24)
        matmul_int8._launch(a, w_t, ones, ones, schedule)
        return calls[0], matmul_int8.matmul_int8.last_plan
    if op == "conv_vjp":
        monkeypatch.setattr(conv_vjp._launch, "fn", None)
        x, y = torch.zeros(2, 6, 6, 3), torch.zeros(2, 6, 6, 4)
        geometry = conv_vjp._geometry(x, y, (3, 3), (1, 1, 1, 1), (1, 1))
        conv_vjp._launch(x, y, y, "strict_relu", geometry, 0, schedule)
        return calls[0], conv_vjp.conv_wgrad.last_plan
    if op == "attention":
        monkeypatch.setattr(attention._launch_fwd, "fn", None)
        q = torch.zeros(3, 40, 8)
        attention._launch_fwd(q, q, q, 0.35, 0, schedule)
        return calls[0], attention.attention_fwd.last_plan
    monkeypatch.setattr(pool_bwd._launch, "fn", None)
    x, y = torch.zeros(2, 8, 8, 3), torch.zeros(2, 4, 4, 3)
    pool_bwd._launch(x, y, y, 2, 2, 2, 2, schedule)
    return calls[0], pool_bwd.max_pool_bwd.last_plan


def _launch_genes(op, args):
    """The genes a recorded C call carries."""
    if op == "matmul":
        return {"bk": args[10], "splits": args[15]}
    if op == "matmul_int8":
        return {"config": args[9], "splits": args[10]}
    if op == "conv_vjp":
        return {"chunk": args[21], "splits": args[22], "cols": args[26]}
    if op == "attention":
        return {"grid": args[5]}
    return {"design": pool_bwd.PATHS[args[14]], "lanes_x": args[16]}


@pytest.mark.parametrize("op", OPS)
def test_planted_schedule_reaches_the_kernel_and_its_plan(op, monkeypatch):
    """The consult serves the planted schedule; the card path launches
    it (the C entry's arguments), and the plan shows it."""
    from veles_tpu_torch.ops import common
    spec, call, planted = _case(op, numpy.random.RandomState(10))
    _plant(spec, planted)
    with tcache.record_specs() as recorded:
        call()
    assert recorded[0]["op"] == op
    served = tcache.consult(op, ("direct",), CPU, lambda: spec)
    assert served == planted
    with common.record_plans() as plans:
        args, plan = _recorded_launch(op, numpy.random.RandomState(10),
                                      monkeypatch, served)
    assert plan["schedule"] == planted and plans == [(op, plan)]
    genes = _launch_genes(op, args)
    if op == "conv_vjp":
        assert genes == {"chunk": 32, "splits": 3, "cols": 64}
    else:
        assert genes == planted
    static_args, static_plan = _recorded_launch(
        op, numpy.random.RandomState(10), monkeypatch, None)
    assert static_plan["schedule"] is None


@pytest.mark.parametrize("op", OPS)
def test_malformed_entry_launches_the_static_plan(op, monkeypatch, caplog):
    """On the card path a malformed entry launches the static plan
    (the same C arguments as an empty cache), after one warning."""
    spec, _, _ = _case(op, numpy.random.RandomState(11))
    static_args, _ = _recorded_launch(op, numpy.random.RandomState(11),
                                      monkeypatch, None)
    _plant(spec, {"tile": "garbage"})
    with caplog.at_level(logging.WARNING, logger="veles_tpu_torch.tune"):
        served = tcache.consult(op, ("bad",), CPU, lambda: spec)
    assert served is None
    args, plan = _recorded_launch(op, numpy.random.RandomState(11),
                                  monkeypatch, served)
    assert _launch_genes(op, args) == _launch_genes(op, static_args)
    assert plan["schedule"] is None


# -- tuned equals static -----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_cuda_planted_schedule_launches_and_equals_static(op):
    """On the card: the wrapper launches the planted schedule (its plan
    shows it) and answers bit for bit as under the static plan on
    representable operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    card = torch.device("cuda", 0)
    spec, call, planted = _case(op, numpy.random.RandomState(12), card)
    want = call()
    wrapper = {"matmul": matmul_mod.matmul,
               "matmul_int8": matmul_int8.matmul_int8,
               "conv_vjp": conv_vjp.conv_wgrad,
               "attention": attention.attention_fwd,
               "pool_bwd": pool_bwd.max_pool_bwd}[op]
    assert wrapper.last_plan["schedule"] is None
    _plant(spec, planted, kind=tcache.device_kind(card))
    got = call()
    torch.cuda.synchronize()
    assert wrapper.last_plan["schedule"] == planted
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("op", OPS)
def test_tuned_equals_static_bit_for_bit_on_representable_operands(op):
    spec, call, planted = _case(op, numpy.random.RandomState(12))
    want = call()
    _plant(spec, planted)
    got = call()
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, b)


def _jax_plant(spec, schedule):
    from veles_tpu.tune.cache import cache_for, device_kind, schedule_key
    digest, payload = schedule_key(
        spec["op"], spec["shape"], spec["dtype"], spec["precision_level"],
        device_kind(), spec["extra"])
    cache_for().put(digest, payload, schedule, source="test")


@pytest.mark.parametrize("bk", [128, 256])
def test_matmul_planted_bk_matches_jax_and_static(bk):
    """The same planted bk in both caches: the port's plain version
    within the matmul parity tolerance of JAX's interpret-mode kernel,
    and in each package tuned equals static on representable operands."""
    import importlib

    import jax.numpy as jnp
    from veles_tpu.tune.spec import matmul_spec as jax_spec
    jax_mm = importlib.import_module("veles_tpu.ops.matmul")
    rng = numpy.random.RandomState(13)
    # the operands of the matmul parity tests (test_torch_matmul.py)
    a = rng.rand(24, 600).astype(numpy.float32)
    b = rng.rand(600, 40).astype(numpy.float32)
    ia, ib = _ints(rng, (24, 600)), _ints(rng, (600, 40))
    static_port = matmul_mod.matmul(ia, ib)
    static_jax = numpy.asarray(jax_mm.matmul(jnp.asarray(ia.numpy()),
                                             jnp.asarray(ib.numpy())))
    _plant(tspec.matmul_spec(24, 600, 40, "float32", 0),
           {"bk": bk, "splits": 2})
    _jax_plant(jax_spec(24, 600, 40, "float32", 0),
               {"blocks": [8, 128, bk]})
    got = matmul_mod.matmul(torch.as_tensor(a), torch.as_tensor(b))
    want = numpy.asarray(jax_mm.matmul(jnp.asarray(a), jnp.asarray(b)))
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(matmul_mod.matmul(ia, ib), static_port)
    numpy.testing.assert_array_equal(
        numpy.asarray(jax_mm.matmul(jnp.asarray(ia.numpy()),
                                    jnp.asarray(ib.numpy()))), static_jax)
    assert torch.equal(static_port, torch.as_tensor(static_jax.copy()))


# -- the measurement discipline ----------------------------------------------


@pytest.mark.parametrize("samples", [
    [1.0, 1.1, 0.9], [-1.0, -1.0, 0.001], [-1.0, -2.0, -3.0],
    [0.5, -0.1, 0.7, 0.6], [2.0], [], [0.0, 0.0, 1.0], [3e-4, 2e-4, -1e-6]])
def test_filter_passes_rank_and_median_match_jax(samples):
    from veles_tpu.tune import measure as jax_measure
    assert measure.filter_passes(samples) == \
        jax_measure.filter_passes(samples)
    assert measure.positive_majority_median(samples) == \
        jax_measure.positive_majority_median(samples)
    assert measure.rank({"k": samples}) == jax_measure.rank({"k": samples})


def test_interleaved_slopes_sample_every_candidate_each_round():
    order = []

    def runner(key):
        def run(n):
            order.append((key, n))
        return run
    samples = measure.interleaved_slopes({"a": runner("a"),
                                          "b": runner("b")}, 1, 3,
                                         rounds=2)
    assert [k for k, _ in order] == ["a", "a", "b", "b"] * 2
    assert {k: len(v) for k, v in samples.items()} == {"a": 2, "b": 2}


# -- quantization, feasibility, the GA ---------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_quantization_lands_on_legal_schedules(op):
    spec, _, _ = _case(op, numpy.random.RandomState(14))
    family = tspec.family_for(op)
    space = family.space(spec)
    rng = numpy.random.RandomState(15)
    for _ in range(50):
        genes = {name: tune.min + rng.rand() * (tune.max - tune.min)
                 for name, tune in space.items()}
        schedule = family.quantize(spec, genes)
        assert family.validate(schedule, spec) == schedule
        assert family.feasible(spec, schedule, tspec.card_limits())
        assert family.quantize(spec, family.genes_of(schedule)) == schedule
    assert family.validate(family.default(spec), spec) is not None


def test_family_bounds_follow_the_kernels():
    conv = tspec.family_for("conv_vjp")
    narrow = tspec.conv_vjp_spec((2, 6, 6, 3), 3, 3, 64, (6, 6),
                                 "float32", 0)
    wide = tspec.conv_vjp_spec((2, 6, 6, 3), 3, 3, 128, (6, 6),
                               "float32", 0)
    level1 = tspec.conv_vjp_spec((2, 6, 6, 3), 3, 3, 128, (6, 6),
                                 "float32", 1)
    tile128 = {"tile": [128, 128], "chunk": 32}
    assert conv.validate(tile128, narrow) is None
    assert conv.validate(tile128, wide) == tile128
    assert conv.validate(tile128, level1) is None
    assert conv.validate({"tile": [64, 64], "chunk": 32}, level1)
    pool = tspec.family_for("pool_bwd")
    overlap = tspec.pool_bwd_spec((2, 9, 9, 3), (4, 4), (3, 3), (2, 2),
                                  "float32")
    assert pool.validate({"design": "cells", "lanes_x": 4}, overlap) is None
    assert pool.validate({"design": "overlap", "lanes_x": 4}, overlap)
    att = tspec.family_for("attention")
    assert att.space(tspec.attention_spec(3, 40, 8, "float32", 1)) is None
    assert att.validate({"grid": 1},
                        tspec.attention_spec(3, 40, 8, "float32", 1)) is None
    mm = tspec.family_for("matmul")
    assert mm.space(tspec.matmul_spec(8, 32, 8, "float32", 0)) is None


def test_snap_collapses_clamp_identical_genomes():
    spec = tspec.matmul_spec(512, 512, 512, "float32", 0)
    tuner = _tuner(spec)
    snap = tuner._snap_genome(tuner.family.space(spec))
    # the GA's sorted gene order: (bk, splits)
    a, b = snap([130.2, 2.4]), snap([110.0, 1.6])
    numpy.testing.assert_array_equal(a, b)
    numpy.testing.assert_array_equal(a, [128.0, 2.0])


def test_infeasible_candidate_rejected_before_launch(monkeypatch):
    """A candidate past the card's limits (a split workspace over the
    cap) is a PENALTY without ever building a runner."""
    spec = tspec.matmul_spec(4096, 65536, 4096, "float32", 0)
    family = tspec.family_for("matmul")
    assert not family.feasible(spec, {"bk": 64, "splits": 1024},
                               tspec.card_limits())

    def boom(self, *args):
        raise AssertionError("launched an infeasible candidate")
    monkeypatch.setattr(tspec.MatmulFamily, "build_runner", boom)
    assert evaluate_candidate({
        "family": "matmul", "spec": spec,
        "genes": {"bk": 64, "splits": 1024}, "fitness_mode": "compile",
        "device": "cpu"}) == PENALTY


@pytest.mark.parametrize("op", OPS)
def test_tuner_ga_then_cache_hit(op):
    """First tune: the GA runs (compile fitness) and persists a legal
    winner; a second tune of the same spec is a hit with ZERO evals."""
    spec, _, _ = _case(op, numpy.random.RandomState(16))
    first = _tuner(spec, generations=2, population=4).tune()
    assert first["source"] == "ga" and first["evals"] >= 1
    assert first["genomes"] >= first["evals"]
    assert tspec.family_for(op).validate(first["schedule"], spec)
    second = _tuner(spec, generations=2, population=4).tune()
    assert second["source"] == "cache" and second["evals"] == 0
    assert second["schedule"] == first["schedule"]


def test_tuner_invalid_cache_hit_retunes():
    spec, _, _ = _case("matmul", numpy.random.RandomState(17))
    _plant(spec, {"bk": 5, "splits": 1})
    row = _tuner(spec, generations=1, population=4).tune()
    assert row["source"] == "ga" and row["schedule"]["bk"] % 64 == 0


def test_tuner_untunable_specs_persist_nothing():
    for spec in (tspec.matmul_spec(8, 32, 8, "float32", 0),
                 tspec.attention_spec(3, 40, 8, "float32", 1)):
        row = _tuner(spec).tune()
        assert row["source"] == "untunable" and row["schedule"] is None
    assert len(tcache.cache_for()) == 0


def test_model_fitness_thin_data_falls_back_to_base():
    spec = tspec.matmul_spec(16, 256, 48, "float32", 0)
    row = _tuner(spec, generations=1, population=4, fitness="model",
                 model_base="compile").tune()
    assert row["source"] == "ga" and row["evals"] >= 1
    assert row["model"]["fallback"] == "thin-data"
    assert row["model"]["predicted"] == 0


def test_model_fitness_pool_run_degrades_to_base(caplog):
    with caplog.at_level(logging.WARNING):
        tuner = _tuner(tspec.matmul_spec(16, 256, 48, "float32", 0),
                       fitness="model", model_base="compile", workers=2)
    assert tuner.fitness_mode == "compile"
    assert any("in-process only" in r.message for r in caplog.records)


def test_model_fitness_launches_fewer_candidates_and_persists_a_measured_one():
    """A compile-fitness base leg fills the sidecar; a model re-tune
    trusts the stump model, launches only the top slice (predicted >= 1,
    fewer evals) and persists a measured winner."""
    spec = tspec.matmul_spec(64, 1024, 64, "float32", 0)
    side = tspec.matmul_spec(128, 1024, 64, "float32", 0)
    base = _tuner(spec, generations=2, population=14,
                  rng=RandomGenerator("mb", seed=13)).tune()
    _tuner(side, generations=1, population=10,
           rng=RandomGenerator("ms", seed=14)).tune()
    assert base["evals"] >= 3
    row = _tuner(spec, generations=2, population=14, fitness="model",
                 model_base="compile", model_min_triples=6, model_trust=10.0,
                 rng=RandomGenerator("mb", seed=13)).tune(force=True)
    info = row["model"]
    assert info["fallback"] is None and info["trusted"]
    assert info["predicted"] >= 1 and row["evals"] < base["evals"]
    assert row["source"] == "ga" and row["fitness"] is not None
    assert tcache.consult("matmul", ("m",), CPU,
                          lambda: spec) == row["schedule"]


def test_sweep_candidates_persists_the_best():
    spec = tspec.matmul_spec(16, 512, 48, "float32", 0)
    family = tspec.family_for("matmul")
    best, ranking = sweep_candidates(
        spec, family.seeds(spec), fitness="compile", device="cpu")
    assert best is not None and len(ranking) >= 3
    assert tcache.consult("matmul", ("s",), CPU, lambda: spec) == best
    entry = next(iter(tcache.cache_for().entries().values()))
    assert entry["source"] == "sweep"


def test_autotune_matmul_migrates_a_device_info_entry(monkeypatch):
    from veles_tpu_torch.backends import DeviceInfo
    from veles_tpu_torch.ops.common import PORT_KERNEL_VERSIONS
    info = DeviceInfo("cpu")
    info.put("matmul:v%d:float32:pl0:s256" % PORT_KERNEL_VERSIONS["matmul"],
             {"bk": 128, "splits": 2})

    def boom(*args, **kwargs):
        raise AssertionError("swept despite the table's entry")
    monkeypatch.setattr("veles_tpu_torch.tune.autotune.sweep_candidates",
                        boom)
    assert matmul_mod.autotune_matmul(info, size=256, device="cpu") == \
        {"bk": 128, "splits": 2}
    entries = tcache.cache_for().entries()
    assert [e["source"] for e in entries.values()] == ["device_info"]
    # a second call is a cache hit
    assert matmul_mod.autotune_matmul(DeviceInfo("cpu"), size=256,
                                      device="cpu") == {"bk": 128,
                                                        "splits": 2}


@pytest.mark.parametrize("op", OPS)
def test_farmed_tuner_persists_a_feasible_measured_winner(op):
    """Two farm workers score the candidates one by one (each its own
    launch): the winner is legal, feasible, measured and persisted, and
    ``evals`` counts the launches the workers made in this process."""
    spec, _, _ = _case(op, numpy.random.RandomState(26))
    row = _tuner(spec, generations=2, population=4, farm_slaves=2).tune()
    assert row["source"] == "ga" and row["evals"] >= 1
    assert row["genomes"] >= row["evals"]
    family = tspec.family_for(op)
    assert family.validate(row["schedule"], spec)
    assert family.feasible(spec, row["schedule"], tspec.card_limits(
        torch.device("cpu")))
    assert PENALTY < row["fitness"] < 0
    entry = tcache.cache_for().get(_plant_key(spec))
    assert entry["schedule"] == row["schedule"]


def _plant_key(spec):
    return tcache.schedule_key(spec["op"], spec["shape"], spec["dtype"],
                               spec["precision_level"], "cpu",
                               spec["extra"])[0]


def test_model_fitness_farm_run_degrades_to_base(caplog):
    with caplog.at_level(logging.WARNING):
        tuner = _tuner(tspec.matmul_spec(16, 256, 48, "float32", 0),
                       fitness="model", model_base="compile", farm_slaves=2)
    assert tuner.fitness_mode == "compile"
    assert any("in-process only" in r.message for r in caplog.records)


# -- the walk ----------------------------------------------------------------


_CONVNET = [
    {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "softmax", "output_sample_shape": 10, "learning_rate": 0.05,
     "gradient_moment": 0.9},
]


@pytest.mark.parametrize("model", ["mlp", "convnet"])
def test_walk_matches_the_jax_walk(model):
    """One raw step's consults and dense products against JAX's walk of
    the lowering: the same raw coordinates for conv_vjp and pool_bwd,
    the same (M, K, N) set for the dense products."""
    from veles_tpu.models import zoo as jax_zoo
    from veles_tpu.tune.walk import collect_specs as jax_collect
    from veles_tpu_torch.models import zoo
    from veles_tpu_torch.tune.walk import collect_specs
    if model == "mlp":
        layers, shape = zoo.mnist_mlp_layers(hidden=16), (784,)
        jax_layers = jax_zoo.mnist_mlp_layers(hidden=16)
    else:
        layers, shape, jax_layers = _CONVNET, (16, 16, 3), _CONVNET
    plans, state, _ = zoo.build_plans_and_state(layers, shape, seed=2)
    ported = collect_specs(plans, state, 8, shape, device="cpu")
    jplans, jstate, _ = jax_zoo.build_plans_and_state(jax_layers, shape,
                                                      seed=2)
    reference = jax_collect(jplans, jstate, 8, shape)

    def raws(specs, op):
        return sorted(json.dumps(s["raw"], sort_keys=True) for s in specs
                      if s["op"] == op)

    def products(specs):
        """Each product as (K, {M, N}): the weight gradient is x^T d,
        (K_in, B, N_out), in the port's autograd and d^T x, (N_out, B,
        K_in), transposed after, in JAX's lowering: one product, M and
        N exchanged."""
        return {(s["raw"]["mkn"][1], tuple(sorted(
            (s["raw"]["mkn"][0], s["raw"]["mkn"][2]))))
            for s in specs if s["op"] == "matmul"}

    def jax_key(k, mn):
        from veles_tpu.tune.spec import matmul_spec as jax_spec
        return tuple(jax_spec(mn[0], k, mn[1], "float32", 0)["shape"])
    for op in ("conv_vjp", "pool_bwd"):
        assert raws(ported, op) == raws(reference, op)
    ours, theirs = products(ported), products(reference)
    assert theirs <= ours
    # JAX keys a product by its shape padded to the MXU quanta (8, 128,
    # 128), so the input gradient d W^T, (B, N_out, K_in), shares one
    # digest with the forward x W, (B, K_in, N_out), where both pad
    # alike, and its walk keeps one of the two; the port keys raw dims
    theirs_keys = {jax_key(k, mn) for k, mn in theirs} | {
        jax_key(k, mn[::-1]) for k, mn in theirs}
    for k, mn in ours - theirs:
        assert jax_key(k, mn) in theirs_keys or \
            jax_key(k, mn[::-1]) in theirs_keys, (k, mn)
    digests = [s["digest"] for s in ported]
    assert len(digests) == len(set(digests))
    if model == "convnet":
        assert {s["op"] for s in ported} == {"conv_vjp", "pool_bwd",
                                             "matmul"}


# -- the CLI -----------------------------------------------------------------


def test_cli_tune_receipt_and_second_run_hits(tmp_path, capsys):
    from veles_tpu_torch.tune.__main__ import main
    out1, out2 = str(tmp_path / "TUNE1.json"), str(tmp_path / "TUNE2.json")
    argv = ["--model", "mlp", "--batch", "8",
            "--fitness", "compile", "--generations", "1", "--population",
            "4", "--ops", "matmul", "--max-specs", "2", "-d", "cpu",
            "--out", out1]
    assert main(argv) == 0
    receipt = json.load(open(out1))
    assert receipt["counts"].get("ga", 0) >= 1 and receipt["evals"] >= 1
    assert receipt["device_kind"] == "cpu"
    assert receipt["torch"] == torch.__version__ and "jax" not in receipt
    assert os.path.exists(receipt["cache_path"])
    assert all(row["op"] == "matmul" for row in receipt["specs"])
    assert main(argv[:-1] + [out2]) == 0
    second = json.load(open(out2))
    assert second["counts"] == {"cache": len(second["specs"])}
    assert second["evals"] == 0
    capsys.readouterr()


@pytest.mark.parametrize("local", [0, 1])
def test_cli_worker_joins_a_farmed_master(local, tmp_path, capsys):
    """``--worker HOST:PORT -d cpu`` evaluates candidates for a master
    run with ``--farm-address HOST:PORT`` (and ``--farm-slaves``
    local workers beside it): the receipt counts its evals and the
    persisted winner is a measured one."""
    import socket
    from veles_tpu_torch.tune.__main__ import main
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    address = "127.0.0.1:%d" % probe.getsockname()[1]
    probe.close()
    out = str(tmp_path / "TUNE.json")
    worker = {}
    thread = threading.Thread(target=lambda: worker.update(
        code=main(["--worker", address, "-d", "cpu"])), daemon=True)
    thread.start()
    assert main(["--model", "mlp", "--batch", "8", "--fitness", "compile",
                 "--generations", "1", "--population", "4", "--ops",
                 "matmul", "--max-specs", "1", "-d", "cpu",
                 "--farm-slaves", str(local), "--farm-address", address,
                 "--out", out]) == 0
    thread.join(30)
    assert not thread.is_alive() and worker["code"] == 0
    receipt = json.load(open(out))
    assert receipt["evals"] >= 1 and receipt["counts"] == {"ga": 1}
    row = receipt["specs"][0]
    assert PENALTY < row["fitness"] < 0
    assert "evaluated" in capsys.readouterr().out


def test_cli_worker_takes_the_card_unless_asked(monkeypatch):
    from veles_tpu_torch.tune.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--worker", "127.0.0.1:1"])


def test_cli_bank_export_merge_and_report(tmp_path, capsys):
    from veles_tpu_torch.tune.__main__ import main
    spec, _, planted = _case("pool_bwd", numpy.random.RandomState(18))
    _plant(spec, planted, fitness=-1e-3)
    bank = str(tmp_path / "bank.json")
    assert main(["--export-bank", bank]) == 0
    assert main(["--cache", str(tmp_path / "other"), "--merge-bank",
                 bank]) == 0
    assert main(["--cache", str(tmp_path / "other"), "--report"]) == 0
    out = capsys.readouterr().out
    assert "bank export: 1 entries" in out and "1 adopted" in out
    assert "schedule cache:" in out and "(1 entries)" in out


# -- the bank ----------------------------------------------------------------


def test_bank_merge_into_fresh_cache_serves_with_zero_local_evals(
        monkeypatch, tmp_path):
    spec, call, _ = _case("matmul", numpy.random.RandomState(19))
    want = call()
    first = _tuner(spec, generations=2, population=4).tune()
    assert first["source"] == "ga"
    bank = str(tmp_path / "bank.json")
    assert tcache.cache_for().export_bank(bank) == 1
    monkeypatch.setenv("VELES_SCHEDULE_CACHE", str(tmp_path / "fresh"))
    assert len(tcache.cache_for()) == 0
    counts = tcache.cache_for().merge_bank(bank)
    assert counts["adopted"] == 1 and counts["total"] == 1
    with tcache.record_specs():
        assert torch.equal(call(), want)
    assert matmul_mod.tuned_schedule(24, 200, 48, "float32", 0,
                                     CPU) == first["schedule"]
    retune = _tuner(spec, generations=2, population=4).tune()
    assert retune["source"] == "cache" and retune["evals"] == 0


def _bank_sequence(schedule_key, put_schedules, tmp_path, name):
    """Two banks in one package's format: bank 1 holds entries a, b
    (fitness -1e-3); bank 2 holds a (better), b (worse), c (new), a
    tampered digest and an entry whose schedule its family refuses."""
    good, bad = put_schedules
    banks = []
    for i, rows in enumerate((
            [("a", good, -1e-3), ("b", good, -1e-3)],
            [("a", good, -5e-4), ("b", good, -2e-3), ("c", good, -1e-3),
             ("d", bad, -1e-3)])):
        entries = {}
        for tag, schedule, fitness in rows:
            digest, payload = schedule_key(
                "matmul", [8, 256 + 64 * ord(tag), 8], "float32", 0,
                "cpu", {"kernel_version": 1})
            entries[digest] = dict(payload, schedule=schedule,
                                   fitness=fitness, source="ga")
        if i == 1:
            digest, payload = schedule_key(
                "matmul", [8, 999, 8], "float32", 0, "cpu",
                {"kernel_version": 1})
            entries["0" * 64] = dict(payload, schedule=good, fitness=-1.0)
        path = str(tmp_path / ("%s_%d.json" % (name, i)))
        with open(path, "w") as fout:
            json.dump({"schema": 1, "kind": "schedule_bank",
                       "host": "h", "entries": entries}, fout)
        banks.append(path)
    return banks


def test_merge_bank_counts_match_jax_for_the_same_sequence(tmp_path):
    from veles_tpu.tune import cache as jax_cache
    port_banks = _bank_sequence(tcache.schedule_key,
                                ({"bk": 64, "splits": 1},
                                 {"bk": 7, "splits": 1}), tmp_path, "port")
    jax_banks = _bank_sequence(jax_cache.schedule_key,
                               ({"blocks": [8, 128, 128]},
                                # a value no JAX test plants: JAX warns
                                # once a process for each refused value
                                {"blocks": [11, 133, 7]}), tmp_path,
                               "jax")
    port = [tcache.cache_for().merge_bank(p) for p in port_banks]
    ref = [jax_cache.cache_for().merge_bank(p) for p in jax_banks]
    assert port == ref
    assert port[1] == {"adopted": 2, "kept": 1, "stale": 1, "invalid": 1,
                       "total": 5}


def test_jax_exported_bank_merges_as_invalid_and_never_serves(
        tmp_path, monkeypatch):
    from veles_tpu.tune.cache import cache_for as jax_cache_for
    from veles_tpu.tune.cache import device_kind as jax_kind
    from veles_tpu.tune.cache import schedule_key as jax_key
    from veles_tpu.tune.spec import matmul_spec as jax_spec
    spec = jax_spec(24, 200, 48, "float32", 0)
    digest, payload = jax_key(spec["op"], spec["shape"], spec["dtype"],
                              spec["precision_level"], jax_kind(),
                              spec["extra"])
    jax_cache_for().put(digest, payload, {"blocks": [8, 128, 128]},
                        fitness=-1e-4)
    # a JAX entry whose schedule happens to look like the port's genes
    d2, p2 = jax_key("matmul", [24, 200, 48], "float32", 0, "cpu",
                     {"kernel_version": 1})
    jax_cache_for().put(d2, p2, {"bk": 64, "splits": 1}, fitness=-1e-4)
    bank = str(tmp_path / "jax_bank.json")
    assert jax_cache_for().export_bank(bank) == 2
    # the port's cache in a directory of its own (the two packages read
    # one VELES_SCHEDULE_CACHE; their digests never meet)
    monkeypatch.setenv("VELES_SCHEDULE_CACHE", str(tmp_path / "port"))
    counts = tcache.cache_for().merge_bank(bank)
    assert counts == {"adopted": 0, "kept": 0, "stale": 0, "invalid": 2,
                      "total": 2}
    assert len(tcache.cache_for()) == 0
    assert matmul_mod.tuned_schedule(24, 200, 48, "float32", 0, CPU) is None


def test_publish_schedule_bank_channel_and_watcher_pickup(tmp_path):
    """publish_schedule_bank writes a manifest-verified bank; a freshness
    poll merges it into the local cache and consumes its stamp; a
    mid-replace bank is retried, not half-merged."""
    from veles_tpu_torch.serve.freshness import SnapshotWatcher
    from veles_tpu_torch.snapshotter import publish_schedule_bank
    pub = str(tmp_path / "pub")
    empty = tcache.ScheduleCache(str(tmp_path / "empty" / "schedules.json"))
    assert publish_schedule_bank(pub, cache=empty) is None
    producer = tcache.ScheduleCache(str(tmp_path / "prod" /
                                        "schedules.json"))
    spec, _, planted = _case("matmul", numpy.random.RandomState(20))
    digest, payload = tcache.schedule_key(
        spec["op"], spec["shape"], spec["dtype"], 0, "cpu", spec["extra"])
    producer.put(digest, payload, planted, fitness=-1e-3, evals=4)
    res = publish_schedule_bank(pub, cache=producer)
    assert res["entries"] == 1
    assert os.path.basename(res["bank"]) == tcache.BANK_FILE_NAME
    watcher = SnapshotWatcher(pub, poll_s=30.0)
    assert watcher.poll_once() is None       # no snapshot: the bank only
    assert tcache.cache_for().get(digest)["schedule"] == planted
    assert tcache.cache_for().get(digest)["host"]
    assert matmul_mod.tuned_schedule(24, 200, 48, "float32", 0,
                                     CPU) == planted
    assert watcher._maybe_merge_bank() is None   # stamp consumed
    bank_file = os.path.join(pub, tcache.BANK_FILE_NAME)
    stamp = watcher._bank_stamp
    with open(bank_file, "a") as fout:
        fout.write("\n")
    assert watcher._maybe_merge_bank() is None
    assert watcher._bank_stamp == stamp          # retried, not consumed
    newer = {"bk": 128, "splits": 1}
    producer.put(digest, payload, newer, fitness=-5e-4, evals=4)
    publish_schedule_bank(pub, cache=producer)
    assert watcher._maybe_merge_bank()["adopted"] == 1
    assert matmul_mod.tuned_schedule(24, 200, 48, "float32", 0,
                                     CPU) == newer


class _Publisher(object):
    """The attributes ``SnapshotterBase._publish`` reads."""

    def __init__(self, publish_dir):
        self.publish_dir, self.publish_keep = publish_dir, 8
        self.notes = []

    def info(self, msg, *args):
        self.notes.append(("info", msg % args))

    def warning(self, msg, *args):
        self.notes.append(("warning", msg % args))


def _exported_snapshot(tmp_path):
    from veles_tpu_torch.snapshotter import SnapshotterBase
    path = str(tmp_path / "snap.pickle")
    with open(path, "wb") as fout:
        fout.write(b"\x80\x04N.")
    SnapshotterBase.write_manifest(path)
    return path


def test_snapshotter_publishes_its_bank_after_each_snapshot(tmp_path):
    from veles_tpu_torch.snapshotter import Snapshotter
    spec, _, planted = _case("attention", numpy.random.RandomState(21))
    _plant(spec, planted, fitness=-1e-3)
    pub = str(tmp_path / "pub")
    publisher = _Publisher(pub)
    Snapshotter._publish(publisher, _exported_snapshot(tmp_path))
    assert os.path.exists(os.path.join(pub, tcache.BANK_FILE_NAME))
    assert os.path.exists(os.path.join(pub, tcache.BANK_FILE_NAME +
                                       ".manifest"))
    assert any("schedule bank (1 entries)" in text
               for _, text in publisher.notes)
    assert tcache.tune_counters()["bank_published"] >= 1


def test_a_failed_bank_publish_does_not_stop_training(tmp_path,
                                                      monkeypatch):
    from veles_tpu_torch import snapshotter
    monkeypatch.setattr(snapshotter, "publish_schedule_bank",
                        lambda *a, **k: 1 / 0)
    publisher = _Publisher(str(tmp_path / "pub"))
    snapshotter.Snapshotter._publish(publisher,
                                     _exported_snapshot(tmp_path))
    assert any(kind == "warning" and "schedule bank publish" in text
               for kind, text in publisher.notes)


def test_serve_engine_receipt_carries_the_tune_block():
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.models import zoo
    from veles_tpu_torch.serve import AOTEngine
    plans, state, _ = zoo.build_plans_and_state(
        zoo.mnist_mlp_layers(hidden=8), (784,), seed=0)
    params = [{"weights": s["weights"], "bias": s["bias"]} for s in state]
    engine = AOTEngine(plans, params, (784,), ladder=(1, 4),
                       device=Device("cpu"))
    receipt = engine.compile()
    assert set(receipt["tune"]) >= {"entries"}
    assert receipt["tune"]["entries"] == 0
