"""The port's graph engine (veles_tpu_torch: mutable, config, units,
plumbing, dummy, workflow, prng, memory) against the JAX package's, on
the CPU.

The same graph is built in both packages — a Repeater loop whose units
record their runs, one unit skipped by ``gate_skip`` on odd passes, the
exit blocked by ``gate_block`` until an EpochCounter completes — and
the run order and iteration counts must be identical.  The numpy PRNG
must give the same fills and shuffles bit for bit; the Array protocol
must never alias a tensor with the host copy."""

import numpy
import pytest
import torch

import veles_tpu.dummy as jax_dummy
import veles_tpu.mutable as jax_mutable
import veles_tpu.plumbing as jax_plumbing
import veles_tpu.prng as jax_prng
import veles_tpu.units as jax_units
import veles_tpu_torch.dummy as torch_dummy
import veles_tpu_torch.mutable as torch_mutable
import veles_tpu_torch.plumbing as torch_plumbing
import veles_tpu_torch.prng as torch_prng
import veles_tpu_torch.units as torch_units
from veles_tpu_torch.backends import Device
from veles_tpu_torch.config import Config, root
from veles_tpu_torch.memory import Array, Watcher

PACKAGES = {
    "jax": (jax_units, jax_plumbing, jax_dummy, jax_mutable),
    "torch": (torch_units, torch_plumbing, torch_dummy, torch_mutable),
}


def _loop_graph(package, passes, log):
    units, plumbing, dummy, mutable = PACKAGES[package]

    class Recorder(units.Unit):
        def __init__(self, workflow, tag, **kwargs):
            super(Recorder, self).__init__(workflow, name=tag, **kwargs)
            self.tag = tag

        def run(self):
            log.append(self.tag)

    wf = dummy.DummyWorkflow()
    repeater = plumbing.Repeater(wf)
    repeater.link_from(wf.start_point)
    first = Recorder(wf, "first").link_from(repeater)
    second = Recorder(wf, "second").link_from(first)
    odd = mutable.Bool(False)

    class Toggle(units.Unit):
        def run(self):
            log.append("toggle")
            self.flag <<= not bool(self.flag)

    toggle = Toggle(wf).link_from(second)
    toggle.flag = odd
    # skipped on odd passes: its successor still runs
    skipped = Recorder(wf, "skippable").link_from(toggle)
    skipped.gate_skip = odd
    counter = plumbing.EpochCounter(wf, passes).link_from(skipped)
    repeater.link_from(counter)
    wf.end_point.link_from(counter)
    wf.end_point.gate_block = ~counter.complete
    return wf, counter, skipped


@pytest.mark.parametrize("passes", [1, 4, 7])
def test_repeater_loop_runs_alike(passes):
    logs, counts = {}, {}
    for package in PACKAGES:
        log = []
        wf, counter, skipped = _loop_graph(package, passes, log)
        wf.initialize()
        wf.run()
        logs[package] = log
        counts[package] = (counter.passes, skipped.run_calls,
                           counter.run_calls, bool(counter.complete),
                           wf.finished)
    assert logs["jax"] == logs["torch"]
    assert counts["jax"] == counts["torch"]
    assert counts["torch"][0] == passes
    # the toggle raises gate_skip on odd passes: "skippable" runs on
    # the even ones
    assert counts["torch"][1] == passes // 2


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_initialize_deadlock_names_the_demand(package):
    units, _, dummy, _ = PACKAGES[package]

    class Needy(units.Unit):
        def __init__(self, workflow, **kwargs):
            super(Needy, self).__init__(workflow, **kwargs)
            self.feed = None
            self.demand("feed")

    wf = dummy.DummyWorkflow()
    Needy(wf, name="needy").link_from(wf.start_point)
    with pytest.raises(RuntimeError, match="deadlock.*needy.*feed"):
        wf.initialize()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_initialize_requeues_until_the_input_is_known(package):
    """A unit raising AttributeError while its input is unknown is
    re-queued, and initializes after the unit it depends on."""
    units, _, dummy, _ = PACKAGES[package]
    order = []

    class Late(units.Unit):
        def initialize(self, **kwargs):
            if not getattr(self.source, "ready", False):
                raise AttributeError("source not ready")
            order.append("late")
            return super(Late, self).initialize(**kwargs)

    class Early(units.Unit):
        def initialize(self, **kwargs):
            self.ready = True
            order.append("early")
            return super(Early, self).initialize(**kwargs)

    wf = dummy.DummyWorkflow()
    late = Late(wf).link_from(wf.start_point)
    early = Early(wf)
    late.source = early
    wf.initialize()
    assert order == ["early", "late"]


def test_run_before_initialize_raises():
    wf = torch_dummy.DummyWorkflow()
    unit = torch_dummy.DummyUnit(wf)
    unit._is_initialized_ = False
    with pytest.raises(RuntimeError, match="before initialize"):
        unit._timed_run()


def test_link_attrs_one_way_and_two_way():
    wf = torch_dummy.DummyWorkflow()
    src = torch_dummy.DummyUnit(wf, value=1, other=5)
    dst = torch_dummy.DummyUnit(wf)
    dst.link_attrs(src, "value")
    dst.link_attrs(src, ("mine", "other"), two_way=True)
    src.value = 2
    assert dst.value == 2
    with pytest.raises(AttributeError):
        dst.value = 3
    dst.mine = 7
    assert src.other == 7


def test_bool_expressions_stay_live():
    a, b = torch_mutable.Bool(False), torch_mutable.Bool(True)
    either, both, neither = a | b, a & b, ~(a | b)
    assert bool(either) and not bool(both) and not bool(neither)
    a <<= True
    assert bool(both)
    b <<= False
    a <<= False
    assert bool(neither)


def test_print_stats_and_graph():
    log = []
    wf, _, _ = _loop_graph("torch", 3, log)
    wf.initialize()
    wf.run()
    import io
    out = io.StringIO()
    # every unit: which 5 take the most time depends on the host's load
    wf.print_stats(top_number=100, out=out)
    text = out.getvalue()
    assert "Workflow run time" in text and "first (3 runs)" in text
    dot = wf.generate_graph()
    assert dot.startswith("digraph DummyWorkflow") and "->" in dot


def test_config_tree():
    node = Config("root")
    node.a.b.c = 3
    node.update({"a": {"d": 4}})
    assert node.a.b.c == 3 and node.a.d == 4
    assert node.a.get("missing", 9) == 9
    node.protect("x")
    with pytest.raises(AttributeError):
        node.x = 1
    assert root.common.engine.get("auto_fuse") in (True, False)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_prng_fills_and_shuffles_bit_equal(seed):
    jg = jax_prng.RandomGenerator("t", seed=seed)
    tg = torch_prng.RandomGenerator("t", seed=seed)
    a = numpy.zeros((17, 5), numpy.float32)
    b = numpy.zeros((17, 5), numpy.float32)
    jg.fill(a, -0.3, 0.3)
    tg.fill(b, -0.3, 0.3)
    assert a.tobytes() == b.tobytes()
    jg.fill_normal(a, 0.0, 2.0)
    tg.fill_normal(b, 0.0, 2.0)
    assert a.tobytes() == b.tobytes()
    x, y = numpy.arange(100), numpy.arange(100)
    jg.shuffle(x)
    tg.shuffle(y)
    assert numpy.array_equal(x, y)
    import pickle
    tg2 = pickle.loads(pickle.dumps(tg))
    assert numpy.array_equal(tg.permutation(9), tg2.permutation(9))


def test_array_protocol_never_aliases():
    device = Device(backend="cpu")
    arr = Array(numpy.arange(6, dtype=numpy.float32).reshape(3, 2))
    arr.initialize(device)
    dev = arr.devmem
    assert torch.equal(dev, torch.arange(6.0).reshape(3, 2))
    arr.map_write()
    arr.mem[0, 0] = 100.0
    assert dev[0, 0].item() == 0.0          # the tensor was not touched
    assert arr.devmem[0, 0].item() == 100.0  # unmap uploaded a new one
    adopted = torch.full((3, 2), 5.0)
    arr.set_device_array(adopted, device)
    assert arr.devmem is adopted
    arr.map_read()
    arr.mem[1, 1] = -1.0                    # host write after a read
    assert adopted[1, 1].item() == 5.0
    assert Watcher.bytes_on_device >= 0
    arr.set_device_array(torch.ones(4, dtype=torch.bfloat16), device)
    assert arr.shape == (4,) and arr.dtype == numpy.float32
    assert numpy.array_equal(arr[:], numpy.ones(4, numpy.float32))
