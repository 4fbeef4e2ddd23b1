"""The port's counterpart of ``xla_introspect``
(veles_tpu_torch/observe/introspect.py) and the analytic FLOP count of
a step (veles_tpu_torch/compiler.step_flops), on the CPU:

- ``mfu_snapshot`` / ``bwd_snapshot`` equal the JAX package's on the
  same registry values under one ``VELES_PEAK_TFLOPS``;
- the compile counters: captures (through a graph owner on
  tests/test_torch_graphs.FakeGraphs) and kernel-library loads, the
  ``compile_delta`` receipt, and ``CompileWatcher`` counting a watched
  owner's captures, per signature kind, warning once past
  ``warn_after``;
- the peak table (an H100 by name, the override, the measured CPU
  ceiling), the memory gauges' CPU census (the Arrays' device bytes),
  which never initializes CUDA;
- ``step_flops`` within 3 % of XLA's ``cost_analysis()`` of the JAX
  package's compiled step and evaluation program (the forward and the
  error count, as its fused trainer compiles them): the MLP, three
  small conv nets and a transformer.  The JAX step runs with
  ``VELES_PALLAS_BWD`` off (the Pallas kernels are custom calls XLA
  does not count) at precision level 0, where its products are single
  dots (bf16x3 runs only inside the Pallas kernels).
"""

import logging

import numpy
import pytest

from veles_tpu_torch.observe import introspect
from veles_tpu_torch.observe.metrics import MetricsRegistry


@pytest.fixture
def peak_env(monkeypatch):
    """One peak for both packages (their peak caches cleared)."""
    from veles_tpu.observe import xla_introspect as jax_intro
    monkeypatch.setenv("VELES_PEAK_TFLOPS", "2.5")
    for module in (introspect, jax_intro):
        monkeypatch.setattr(module, "_peak_cache", {})
        monkeypatch.setattr(module, "_step_dtype", ["bf16"])
    yield jax_intro


def _fill(reg, train, evals, step_flops, fwd_flops):
    for value in train:
        reg.histogram("step.train_s").observe(value)
    for value in evals:
        reg.histogram("step.eval_s").observe(value)
    if step_flops is not None:
        reg.gauge("xla.step_flops").set(step_flops)
    if fwd_flops is not None:
        reg.gauge("xla.fwd_flops").set(fwd_flops)


MFU_CASES = [
    ([0.010, 0.012, 0.011, 0.5], [0.004, 0.0041], 3.1e9, 1.0e9),
    ([0.002], [0.003], 1e6, 5e5),            # eval slower: no split
    ([0.020, 0.021], [], 7e10, 2e10),          # no eval steps yet
    ([0.020, 0.021], [0.005], None, None),     # no FLOPs published
    ([], [0.005], 7e10, 2e10),                 # no train steps yet
    ([0.020, 0.030, 0.025], [0.01], 7e10, 8e10),  # fwd > step
]


@pytest.mark.parametrize("train,evals,step_flops,fwd_flops", MFU_CASES)
def test_mfu_and_bwd_snapshots_equal_jax(peak_env, train, evals,
                                         step_flops, fwd_flops):
    from veles_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    jax_intro = peak_env
    port_reg, jax_reg = MetricsRegistry(), JaxRegistry()
    _fill(port_reg, train, evals, step_flops, fwd_flops)
    _fill(jax_reg, train, evals, step_flops, fwd_flops)
    assert introspect.peak_flops() == jax_intro.peak_flops() == 2.5e12
    assert introspect.mfu_snapshot(port_reg) == \
        jax_intro.mfu_snapshot(jax_reg)
    assert introspect.bwd_snapshot(port_reg) == \
        jax_intro.bwd_snapshot(jax_reg)
    names = ("xla.mfu_pct", "bwd.step_ms", "bwd.mfu_pct")
    for name in names:
        got, want = port_reg.peek(name), jax_reg.peek(name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.value == want.value, name


def test_int8_step_rates_against_the_int8_peak(monkeypatch):
    monkeypatch.setattr(introspect, "_peak_cache", {})
    monkeypatch.setattr(introspect, "_step_dtype", ["bf16"])
    monkeypatch.delenv("VELES_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(introspect, "_device_name",
                        lambda: "NVIDIA H100 80GB HBM3")
    assert introspect.peak_flops() == 989e12
    reg = MetricsRegistry()
    introspect.set_step_dtype("int8", reg)
    assert introspect.step_dtype() == "int8"
    assert reg.peek("xla.step_dtype_int8").value == 1
    assert introspect.peak_flops() == 1979e12
    with pytest.raises(ValueError, match="unknown step dtype"):
        introspect.set_step_dtype("fp8")


def test_engine_publishes_its_step_dtype(monkeypatch):
    from veles_tpu_torch.serve.engine import publish_quantized_state
    monkeypatch.setattr(introspect, "_step_dtype", ["bf16"])
    publish_quantized_state(True)
    assert introspect.step_dtype() == "int8"
    publish_quantized_state(False)
    assert introspect.step_dtype() == "bf16"


def test_measured_peak_without_a_card(monkeypatch):
    monkeypatch.setattr(introspect, "_peak_cache", {})
    monkeypatch.delenv("VELES_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(introspect, "_device_name", lambda: None)
    peak = introspect.peak_flops()
    assert peak is not None and 1e6 < peak < 1e14
    # one measured ceiling serves every dtype
    assert introspect.peak_flops("int8") == peak


def test_capture_and_library_load_count_as_compiles():
    from tests.test_torch_graphs import fake_owner
    import torch
    from veles_tpu_torch.observe.metrics import registry
    registry.reset()
    owner = fake_owner("probe")
    x = torch.ones(4)
    with introspect.compile_delta() as delta:
        owner.graph(("step", 1), lambda a: (a * 2,), [x])
        owner.graph(("step", 2), lambda a: (a * 3,), [x])
        owner.graph(("eval", 1), lambda a: (a + 1,), [x])
        owner.graph(("step", 1), lambda a: (a * 2,), [x])  # held
        introspect.note_kernel_library(False, 0.01)
    assert delta.receipt == {"backend_compiles": 4, "cache_hits": 1,
                             "new_compiles": 3, "captures": 3,
                             "kernel_builds": 0}
    assert owner.captures_by_kind == {"step": 2, "eval": 1}
    introspect.note_kernel_library(True, 2.0)
    snap = introspect.compile_snapshot()
    assert snap["count"] == 4 and snap["captures"] == 3
    assert snap["kernel_builds"] == 1 and snap["cache_misses"] == 1
    assert snap["cache_hits"] == 1 and snap["seconds"] >= 2.0
    assert snap["recompiles"] == 0


def test_compile_snapshot_is_whole_before_any_compile():
    reg = MetricsRegistry()
    assert introspect.compile_snapshot(reg) == {
        "count": 0, "seconds": 0.0, "recompiles": 0, "cache_hits": 0,
        "cache_misses": 0, "captures": 0, "kernel_builds": 0}


def test_watcher_counts_recaptures_and_warns_once(caplog):
    from tests.test_torch_graphs import fake_owner
    import torch
    reg = MetricsRegistry()
    watcher = introspect.CompileWatcher(registry=reg, warn_after=2)
    owner = fake_owner("watched")
    x = torch.ones(2)
    owner.graph(("eval", 0), lambda a: (a,), [x])  # before watching
    assert watcher.watch(owner, "fused.step", kind="step")
    assert watcher.watch(owner, "fused.eval", kind="eval")
    assert not watcher.watch(object(), "not an owner")
    warned = []
    owner.graph(("step", 0), lambda a: (a,), [x])
    assert watcher.poll() == {"fused.step": 1, "fused.eval": 0}
    assert reg.peek("compile.recompiles") is None
    owner.graph(("step", 1), lambda a: (a,), [x])
    owner.graph(("step", 2), lambda a: (a,), [x])
    with caplog.at_level(logging.WARNING, logger="xla"):
        sizes = watcher.poll(warn=lambda n, s: warned.append((n, s)))
        owner.graph(("step", 3), lambda a: (a,), [x])
        watcher.poll(warn=lambda n, s: warned.append((n, s)))
    assert sizes["fused.step"] == 3
    assert reg.peek("compile.recompiles").value == 3
    assert warned == [("fused.step", 3)]
    assert sum("recompile storm" in r.message for r in caplog.records) == 1
    assert watcher.poll() == {"fused.step": 4, "fused.eval": 0}
    # watching anew (a rollback's recompile) starts from zero
    watcher.watch(owner, "fused.step", kind="step")
    assert watcher.poll()["fused.step"] == 0
    # held weakly: a dropped owner (and its graphs' pool) goes
    del owner
    import gc
    gc.collect()
    assert watcher.poll() == {}


def test_memory_gauges_take_the_census_without_a_card():
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    reg = MetricsRegistry()
    before = introspect.device_memory_gauges(reg)["xla.mem.live_bytes"]
    arr = Array(numpy.zeros(1 << 20, numpy.float32))  # 4 MiB
    arr.device_array(Device(backend="cpu"))
    after = introspect.device_memory_gauges(reg)["xla.mem.live_bytes"]
    assert after - before == arr.mem.nbytes
    assert reg.peek("xla.mem.live_bytes").value == after
    assert not torch.cuda.is_initialized()


# -- the step's FLOP count against XLA's cost analysis ----------------------


def _a2a(n, kind="all2all_tanh"):
    return {"type": kind, "output_sample_shape": n,
            "learning_rate": 0.05, "gradient_moment": 0.9}


def _conv(n, k=3, pad=1, kind="conv_str"):
    return {"type": kind, "n_kernels": n, "kx": k, "ky": k, "padding": pad,
            "learning_rate": 0.05, "gradient_moment": 0.9}


_POOL = {"type": "max_pooling", "kx": 2, "ky": 2}
_BLOCK = {"type": "transformer", "heads": 2, "hidden": 64,
          "learning_rate": 0.05, "gradient_moment": 0.9}

NETS = {
    "mlp": ([_a2a(100), _a2a(10, "softmax")], (784,), 100),
    "convnet": ([_conv(4), _POOL, _conv(6, kind="conv_tanh"), _POOL,
                 _a2a(16, "all2all_str"), _a2a(5, "softmax")],
                (8, 8, 2), 16),
    "convnet_wide": ([_conv(8), _POOL, _conv(16, kind="conv_tanh"), _POOL,
                      _a2a(32, "all2all_str"), _a2a(10, "softmax")],
                     (16, 16, 3), 16),
    "conv_strided_pool": ([_conv(8, k=5, pad=2),
                           {"type": "max_pooling", "kx": 3, "ky": 3,
                            "sliding": (2, 2)},
                           _a2a(10, "softmax")], (15, 15, 3), 8),
    "transformer": ([dict(_BLOCK), dict(_BLOCK), _a2a(10, "softmax")],
                    (16, 32), 8),
}


def _xla_flops(jplans, state, x, batch):
    import jax
    from veles_tpu.compiler import build_forward, build_train_step

    def aval(leaf):
        if leaf is None:
            return None
        return jax.ShapeDtypeStruct(numpy.shape(leaf),
                                    numpy.asarray(leaf).dtype)

    def flops(cost):
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        return float(cost["flops"])

    step = build_train_step(jplans, loss="softmax", donate=False)
    avals = jax.tree.map(aval, state, is_leaf=lambda v: v is None)
    labels = numpy.zeros(batch, numpy.int32)
    train = flops(step.lower(avals, aval(x), aval(labels),
                             aval(numpy.float32(batch))).cost_analysis())
    forward = build_forward(jplans)

    def eval_metrics(params, x, labels):
        # the JAX fused trainer's evaluation program (models/fused.py)
        out = forward(params, x)
        pred = jax.numpy.argmax(out, axis=-1)
        return ((pred != labels) & (labels >= 0)).sum()
    params = [{"weights": aval(s["weights"]), "bias": aval(s["bias"])}
              for s in state]
    fwd = flops(jax.jit(eval_metrics).lower(
        params, aval(x), aval(labels)).cost_analysis())
    return train, fwd


@pytest.mark.parametrize("net", sorted(NETS))
def test_step_flops_within_3pct_of_xla(net, monkeypatch):
    from veles_tpu.models.zoo import build_plans_and_state
    from veles_tpu.ops import common as jax_common
    from veles_tpu_torch.compiler import step_flops
    from tests.test_torch_train import port_plans
    monkeypatch.setattr(jax_common, "PALLAS_BWD_ENV", "0")
    specs, shape, batch = NETS[net]
    jplans, state, _ = build_plans_and_state(specs, shape, seed=2)
    x = numpy.zeros((batch,) + shape, numpy.float32)
    xla_train, xla_fwd = _xla_flops(jplans, state, x, batch)
    port_state = [{key: None if leaf is None else numpy.asarray(leaf)
                   for key, leaf in entry.items()} for entry in state]
    mine = step_flops(port_plans(jplans), port_state, x.shape)
    assert abs(mine["train"] / xla_train - 1) <= 0.03, (mine, xla_train)
    assert abs(mine["forward"] / xla_fwd - 1) <= 0.03, (mine, xla_fwd)
    assert mine["forward"] < mine["train"]


def test_step_flops_products_by_hand():
    """The products' rule alone, on a case worked by hand: conv 3x3 SAME
    over 32x32 (94 in-bounds taps per axis), its input gradient counted
    only behind a layer with parameters."""
    from veles_tpu_torch.compiler import LayerPlan, step_flops
    from veles_tpu_torch.models.conv import Conv
    from veles_tpu_torch.models.pooling import MaxPooling
    w = numpy.zeros((3, 3, 16, 32), numpy.float32)
    conv = LayerPlan(Conv, static={"padding": (1, 1, 1, 1),
                                   "sliding": (1, 1)})
    entry = {"weights": w, "bias": None}
    one = step_flops([conv], [entry], (8, 32, 32, 16))
    products = 2 * 8 * 16 * 32 * 94 * 94
    out = 8 * 32 * 32 * 32
    # forward: products, the linear rate's 1 an output (the bias add's
    # place) and the error count's tail over the 32768 outputs a row
    assert one["forward"] == products + out + 8 * (9 * out // 8 - 4)
    assert one["train"] == 2 * products + 13 * w.size + 2 * out
    pool = LayerPlan(MaxPooling, static={"window": (2, 2),
                                         "sliding": (2, 2)})
    behind = step_flops([pool, conv], [{"weights": None, "bias": None},
                                       entry], (8, 64, 64, 16))
    assert behind["train"] - one["train"] == \
        8 * 32 * 32 * 16 * 3 + 8 * 64 * 64 * 16
    two = step_flops([conv, LayerPlan(Conv, static={
        "padding": (1, 1, 1, 1), "sliding": (1, 1)})],
        [entry, {"weights": numpy.zeros((3, 3, 32, 32), numpy.float32),
                 "bias": None}], (8, 32, 32, 16))
    second = 2 * 8 * 32 * 32 * 94 * 94
    assert two["train"] - one["train"] == 3 * second + 13 * 9 * 32 * 32 + \
        2 * out


def test_step_flops_refuses_an_unknown_layer():
    from veles_tpu_torch.compiler import LayerPlan, step_flops

    class Strange(object):
        MAPPING = "strange"
    with pytest.raises(ValueError, match="no FLOP rule"):
        step_flops([LayerPlan(Strange)], [{"weights": None}], (2, 3))
