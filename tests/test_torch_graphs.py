"""The port's compile step (veles_tpu_torch/graphs.py, the donated and
captured train step and epochs of veles_tpu_torch/compiler.py, the
captured rungs of serve/engine.py, the trainer's graphs) on the CPU.

A CUDA graph needs a card.  On the CPU an owner takes a stand-in
backend (:class:`FakeGraphs`): its capture runs the body once on clones
of the static inputs, as a real capture computes nothing, and each
replay runs the body again on the static inputs, copies the results
into the captured outputs and puts the launch counters back, as a
replay runs no Python.  So the bookkeeping of the card's path (static
buffers, copies in and out, host scalars, signatures, counters,
receipts) runs here as it does there.  Limits: the donated and the
captured steps equal the functional step bit for bit; against the JAX
package's ``build_train_step(donate=True)`` the limits of
tests/test_torch_train.py (loss 1e-5 rel, ``n_err`` equal, leaves
max-rel 1e-4).  The ``cuda`` tests hold a real replay against the raw
step on the card."""

import math

import numpy
import pytest
import torch

from test_torch_train import (CLASSES, CONVNET, CPU, NAN,
                              assert_metrics_close, assert_states_close,
                              batches, convnet, mlp, pallas_on,  # noqa: F401
                              port_plans)
from veles_tpu_torch import graphs, threefry
from veles_tpu_torch.compiler import TrainStep, build_train_step
from veles_tpu_torch.convert import state_from_jax, state_to_numpy
from veles_tpu_torch.graphs import GraphCaptureError, GraphOwner
from veles_tpu_torch.ops import common
from veles_tpu_torch.ops.conv_vjp import conv_wgrad
from veles_tpu_torch.ops.gather import gather_minibatch


class FakeGraph(object):
    def __init__(self, body, args, outputs):
        self.body, self.args, self.outputs = body, args, outputs
        self.replays = 0

    def replay(self):
        before = graphs._snapshot()
        for held, new in zip(self.outputs, self.body(*self.args)):
            held.copy_(new)
        graphs._restore(before)
        self.replays += 1


class FakeGraphs(object):
    """A stand-in for ``graphs.CudaGraphs`` on the CPU."""

    def __init__(self):
        self.captured = []

    def pool(self):
        return object()

    def stream(self):
        return None

    def stream_handle(self, stream):
        return 0

    def warm_up(self, stream, fn):
        fn()

    def capture(self, body, args, pool, stream):
        outputs = body(*[graphs._clone(a) for a in args])
        graph = FakeGraph(body, args, outputs)
        self.captured.append(graph)
        return graph, outputs

    def pool_bytes(self, pool):
        return 0


def fake_owner(name="test"):
    return GraphOwner(name, "cpu", FakeGraphs())


def _copy(state):
    return [{k: None if v is None else v.clone() for k, v in e.items()}
            for e in state]


def assert_bits_equal(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert (g[key] is None) == (w[key] is None), key
            if w[key] is not None:
                assert torch.equal(g[key], w[key]), key


def assert_metric_bits_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        g, w = got[key], want[key]
        if g.is_floating_point():
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), key
        else:
            assert torch.equal(g, w), key


def _transformer():
    from test_torch_transformer import SPEC
    from veles_tpu.models.zoo import build_plans_and_state
    jplans, state, _ = build_plans_and_state(*SPEC, seed=10)
    rng = numpy.random.RandomState(11)
    data = [(rng.randn(3, *SPEC[1]).astype(numpy.float32),
             rng.randint(0, 10, 3).astype(numpy.int32)) for _ in range(3)]
    return jplans, state, data


def _case(name):
    """(jax plans, state, [(x, t, batch_size, key, poisons)] x 3, loss)."""
    if name == "transformer":
        jplans, state, data = _transformer()
        return jplans, state, [(x, t, 3.0, None, {}) for x, t in data], \
            "softmax"
    if name == "mlp":
        jplans, state = mlp()
        data = batches((784,), 10, n=3, batch=32, seed=3)
        return jplans, state, [(x, t, 32.0, None, {}) for x, t in data], \
            "softmax"
    jplans, state = convnet()
    data = batches(CONVNET[1], CLASSES)
    if name == "dropout":
        steps = [(x, t, 16.0, threefry.fold_in(threefry.key(5), n), {})
                 for n, (x, t) in enumerate(data[:3], 1)]
    elif name == "chaos":
        poison = numpy.float32(NAN)
        steps = [(data[0][0], data[0][1], 16.0, None, {}),
                 (data[1][0], data[1][1], 16.0, None,
                  {"grad_poison": poison}),
                 (data[2][0], data[2][1], 16.0, None,
                  {"loss_poison": numpy.float32(-0.0)})]
    else:   # a short tail: 11 of the 16 rows count
        t = data[0][1].copy()
        t[11:] = -1
        steps = [(data[0][0], t, 11.0, None, {}),
                 (data[1][0], data[1][1], 16.0, None, {}),
                 (data[0][0], t, 11.0, None, {})]
    return jplans, state, steps, "softmax"


CASES = ["mlp", "dropout", "transformer", "chaos", "tail"]


def _run(step, state, steps):
    s, metrics = state, []
    for x, t, size, key, poisons in steps:
        s, m = step(s, torch.from_numpy(x), torch.from_numpy(t), size, key,
                    **poisons)
        metrics.append(m)
    return s, metrics


@pytest.mark.parametrize("path", ["donated", "captured"])
@pytest.mark.parametrize("case", CASES)
def test_donated_step_equals_functional_step_bit_for_bit(case, path):
    jplans, state, steps, loss = _case(case)
    plans = port_plans(jplans)
    want_state, want = _run(build_train_step(plans, loss, donate=False),
                            state_from_jax(state, CPU), steps)
    owner = fake_owner() if path == "captured" else None
    step = build_train_step(plans, loss, graphs=owner)
    start = state_from_jax(state, CPU)
    got_state, got = _run(step, start, steps)
    assert isinstance(step, TrainStep)
    assert_bits_equal(got_state, want_state)
    for g, w in zip(got, want):
        assert_metric_bits_equal(g, w)
    # the caller's state was copied in, not written
    assert_bits_equal(start, state_from_jax(state, CPU))
    if case == "chaos":
        assert [int(m["skipped"]) for m in got] == [0, 1, 0]
    if owner is not None:
        # one graph per signature: the chaos case's three steps differ
        # in their poisons, the tail's first and last share one
        signatures = {"chaos": 3, "tail": 2}.get(case, 1)
        assert owner.receipt["graphs"] == signatures
        assert owner.receipt["replays"] == 3


@pytest.mark.parametrize("case", ["mlp", "dropout", "chaos"])
def test_donated_step_within_limits_of_jax_donated_step(case, pallas_on):
    """The donated step against ``veles_tpu.compiler.build_train_step``
    with ``donate=True``, run on the CPU from the same parameters."""
    import jax
    from veles_tpu.compiler import build_train_step as jax_build
    jplans, state, steps, loss = _case(case)
    jstep = jax_build(jplans, loss=loss, donate=True)
    js = [{k: None if v is None else jax.numpy.array(v)
           for k, v in e.items()} for e in state]
    jm = []
    for n, (x, t, size, key, poisons) in enumerate(steps, 1):
        jkey = None if key is None else \
            jax.random.fold_in(jax.random.PRNGKey(5), n)
        js, m = jstep(js, x, t, numpy.float32(size), jkey, **poisons)
        jm.append({k: numpy.asarray(v) for k, v in m.items()})
    ps, pm = _run(build_train_step(port_plans(jplans), loss,
                                   graphs=fake_owner()),
                  state_from_jax(state, CPU), steps)
    pm = [{k: v.numpy() for k, v in m.items()} for m in pm]
    finite = [i for i, m in enumerate(jm) if bool(m["finite"])]
    assert finite == [i for i, m in enumerate(pm) if bool(m["finite"])]
    assert_metrics_close([pm[i] for i in finite], [jm[i] for i in finite])
    assert_states_close(state_to_numpy(ps),
                        [{k: None if v is None else numpy.asarray(v)
                          for k, v in e.items()} for e in js])


def _ticking_body(x):
    """A body that 'launches' a gather (vec4) and two wgrads."""
    gather_minibatch.launches += 1
    gather_minibatch.paths["vec4"] += 1
    conv_wgrad.launches += 2
    conv_wgrad.paths["tc_bf16x3"] += 2
    return (x * 2,)


def test_counters_count_replays_not_captures_or_warm_ups():
    owner = fake_owner()
    before = (gather_minibatch.launches, dict(gather_minibatch.paths),
              conv_wgrad.launches, dict(conv_wgrad.paths))
    x = torch.arange(4.0)
    graph = owner.graph("sig", _ticking_body, [x])
    # the warm-up and the capture each ran the body: no count moved
    assert (gather_minibatch.launches, dict(gather_minibatch.paths),
            conv_wgrad.launches, dict(conv_wgrad.paths)) == before
    assert owner.receipt["warmup_launches"] == 3
    assert owner.receipt["captures"] == 1 and graph.launches == 3
    for _ in range(5):
        out, = graph.replay()
    assert torch.equal(out, x * 2)
    assert gather_minibatch.launches == before[0] + 5
    assert gather_minibatch.paths["vec4"] == before[1]["vec4"] + 5
    assert conv_wgrad.launches == before[2] + 10
    assert conv_wgrad.paths["tc_bf16x3"] == before[3]["tc_bf16x3"] + 10
    assert owner.receipt["replays"] == 5
    # a counter a caller rebinds (chip_smoke zeroes ``paths`` so) still
    # advances
    gather_minibatch.paths = dict.fromkeys(gather_minibatch.paths, 0)
    graph.replay()
    assert gather_minibatch.paths["vec4"] == 1


class _InertGraphs(FakeGraphs):
    """A stand-in that, like a CUDA graph, keeps no Python body."""

    def capture(self, body, args, pool, stream):
        outputs = body(*[graphs._clone(a) for a in args])
        return type("Inert", (), {"replay": lambda self: None})(), outputs


def test_owners_die_by_reference_count():
    """No reference cycle holds a graph: an owner or a step that is
    dropped frees its graphs at once, not at some later collection
    (which could land inside another capture and break it)."""
    import gc
    import weakref
    jplans, state = convnet()
    x, t = (torch.from_numpy(a) for a in batches(CONVNET[1], CLASSES)[0])
    collecting = gc.isenabled()
    gc.disable()
    try:
        owner = fake_owner()
        owner.graph("sig", lambda v: (v * 2,), [torch.zeros(2)]).replay()
        dead_owner = weakref.ref(owner)
        del owner
        step = build_train_step(port_plans(jplans), graphs=GraphOwner(
            "step", "cpu", _InertGraphs()))
        step(state_from_jax(state, CPU), x, t, 16.0)
        dead_step = weakref.ref(step.graphs)
        del step
        assert dead_owner() is None and dead_step() is None
    finally:
        if collecting:
            gc.enable()


def test_every_kernel_wrapper_is_registered():
    names = {w.__name__ for w in graphs.counters()}
    assert names == {"gather_minibatch", "matmul", "matmul_int8",
                     "conv_wgrad", "max_pool_bwd", "attention_fwd",
                     "attention_dq", "attention_dkv", "join",
                     "mean_disp_normalize", "hardware_uniform",
                     "reduce_cols", "reduce_rows"}


def test_signatures_key_the_graphs():
    """The same signature replays its graph; a new batch size, input
    shape, key presence or poison captures a new one."""
    jplans, state = convnet()
    owner = fake_owner()
    step = build_train_step(port_plans(jplans), graphs=owner)
    x, t = (torch.from_numpy(a) for a in batches(CONVNET[1], CLASSES)[0])
    s = state_from_jax(state, CPU)
    calls = [((x, t, 16.0), {}), ((x, t, 16.0), {}),
             ((x, t, 11.0), {}),
             ((x[:8], t[:8], 8.0), {}),
             ((x, t, 16.0, threefry.key(1)), {}),
             ((x, t, 16.0, threefry.key(2)), {}),
             ((x, t, 16.0), {"grad_poison": numpy.float32(NAN)}),
             ((x, t, 16.0), {"loss_poison": numpy.float32(NAN)}),
             ((x, t, 16.0), {})]
    graph_counts = []
    for args, kwargs in calls:
        s, _ = step(s, *args, **kwargs)
        graph_counts.append(owner.receipt["graphs"])
    assert graph_counts == [1, 1, 2, 3, 4, 4, 5, 6, 6]
    assert owner.receipt["replays"] == len(calls)


def test_metrics_survive_later_steps_and_state_is_donated():
    """The aliasing rule: the state returned is the step's own buffers
    (the next call rewrites them); the metrics returned are copies no
    later step touches."""
    jplans, state = convnet()
    step = build_train_step(port_plans(jplans), graphs=fake_owner())
    data = [(torch.from_numpy(x), torch.from_numpy(t))
            for x, t in batches(CONVNET[1], CLASSES)]
    s1, m1 = step(state_from_jax(state, CPU), *data[0], 16.0)
    kept_state, kept = _copy(s1), {k: v.clone() for k, v in m1.items()}
    s2, m2 = step(s1, *data[1], 16.0)
    for key in kept:
        assert torch.equal(m1[key], kept[key]), key
    assert not torch.equal(m2["loss"], m1["loss"])
    assert all(a is b for e1, e2 in zip(s1, s2) for a, b in
               zip(e1.values(), e2.values()))
    assert not torch.equal(s1[0]["weights"], kept_state[0]["weights"])


def test_donated_state_refuses_another_device_or_shape():
    jplans, state = convnet()
    step = build_train_step(port_plans(jplans))
    own = step.own_state(state_from_jax(state, CPU))
    moved = [dict(e) for e in own]
    moved[0]["weights"] = torch.empty(own[0]["weights"].shape,
                                      device="meta")
    with pytest.raises(ValueError, match="one device"):
        step.own_state(moved)
    moved[0]["weights"] = own[0]["weights"][:1]
    with pytest.raises(ValueError, match="layer 0 weights"):
        step.own_state(moved)


def test_donate_false_is_the_raw_functional_step():
    jplans, state = convnet()
    step = build_train_step(port_plans(jplans), donate=False)
    assert not isinstance(step, TrainStep)
    x, t = (torch.from_numpy(a) for a in batches(CONVNET[1], CLASSES)[0])
    s0 = state_from_jax(state, CPU)
    s1, _ = step(s0, x, t, 16.0)
    assert not torch.equal(s0[0]["weights"], s1[0]["weights"])
    assert_bits_equal(s0, state_from_jax(state, CPU))


def test_a_failed_capture_raises_naming_the_operation():
    owner = fake_owner()

    def body(x):
        return (torch.cat([x, x.reshape(2, 2)]),)  # shapes do not fit

    with pytest.raises(GraphCaptureError) as err:
        owner.graph("sig", body, [torch.zeros(4)])
    # the warm-up raised first; the message names the operation
    assert "torch.cat" in str(err.value)
    assert isinstance(err.value.__cause__, RuntimeError)


def test_capture_failure_message_names_the_port_frame():
    class Refusing(FakeGraphs):
        def capture(self, body, args, pool, stream):
            from veles_tpu_torch.threefry import fold_in
            fold_in((0, 1), object())   # a TypeError inside the port

    owner = GraphOwner("refusing", "cpu", Refusing())
    with pytest.raises(GraphCaptureError) as err:
        owner.graph(("sig",), lambda x: (x,), [torch.zeros(1)])
    assert "veles_tpu_torch/threefry.py" in str(err.value)
    assert "refusing" in str(err.value)


def test_capture_refuses_under_debug_nonfinite(monkeypatch):
    monkeypatch.setattr(common, "DEBUG_NONFINITE", True)
    with pytest.raises(GraphCaptureError, match="VELES_DEBUG_NONFINITE"):
        fake_owner().graph("sig", lambda x: (x,), [torch.zeros(1)])


@pytest.mark.parametrize("donate", [True, False])
def test_captured_epochs_equal_eager_epochs(donate, pallas_on):
    """37 samples in steps of 16 (a masked tail), keyed: the captured
    train and eval epochs against the functional eager ones (on the CPU
    with no owner the eval runs eagerly), bit for bit."""
    from veles_tpu_torch.compiler import build_eval_epoch, build_train_epoch
    jplans, state = convnet()
    plans = port_plans(jplans)
    rng = numpy.random.RandomState(7)
    data = torch.from_numpy(rng.randn(37, *CONVNET[1]).astype(
        numpy.float32))
    labels = torch.from_numpy(rng.randint(0, CLASSES, 37).astype(
        numpy.int32))
    order = torch.from_numpy(rng.permutation(37).astype(numpy.int32))
    want_state, want = build_train_epoch(plans, 16, donate=False)(
        state_from_jax(state, CPU), data, labels, order, threefry.key(3))
    owner = fake_owner() if donate else None
    got_state, got = build_train_epoch(plans, 16, donate=donate,
                                       graphs=owner)(
        state_from_jax(state, CPU), data, labels, order, threefry.key(3))
    assert_bits_equal(got_state, want_state)
    assert_metric_bits_equal(got, want)
    if owner is not None:
        assert owner.receipt["graphs"] == 2      # full steps, the tail
        assert owner.receipt["replays"] == 3
    params = [{"weights": e["weights"], "bias": e["bias"]}
              for e in want_state]
    eager = build_eval_epoch(plans, 16)(params, data, labels, order)
    eval_owner = fake_owner()
    captured = build_eval_epoch(plans, 16, graphs=eval_owner)
    for _ in range(2):       # the static sums start from 0 each epoch
        assert_metric_bits_equal(captured(params, data, labels, order),
                                 eager)
    assert eval_owner.receipt["graphs"] == 2
    assert int(eager["samples"]) == 37


def test_gather_out_writes_the_given_buffer():
    data = torch.arange(60.0).reshape(10, 6)
    idx = torch.tensor([3, 9, 0, 12], dtype=torch.int32)
    out = torch.empty(4, 6)
    got = gather_minibatch(data, idx, out=out)
    assert got is out
    assert torch.equal(out, gather_minibatch(data, idx))
    with pytest.raises(ValueError, match="out must be"):
        gather_minibatch(data, idx, out=torch.empty(3, 6))


# -- the trainer -------------------------------------------------------------


def _with_graphs(run, graphs):
    """``run()`` with every FusedTrainer on a stand-in graph owner (the
    card's path of the trainer on the CPU) when ``graphs``; returns
    (run's result, the owners made)."""
    from veles_tpu_torch.models.fused import FusedTrainer
    owners = []
    if not graphs:
        return run(), owners
    compile_ = FusedTrainer._compile

    def compile_with_graphs(self):
        if self._graphs_ is None:
            self._graphs_ = fake_owner("fused trainer")
            owners.append(self._graphs_)
        compile_(self)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(FusedTrainer, "_compile", compile_with_graphs)
        return run(), owners


def _blobs_run(epochs=2):
    from test_torch_workflow import blobs, build_torch
    sw = build_torch(blobs(), epochs=epochs, fuse=True)
    sw.run()
    return sw


def _unit_arrays(sw):
    out = []
    for unit in sw.forwards:
        for arr in (unit.weights, unit.bias):
            arr.map_read()
            out.append(numpy.array(arr.mem))
    return out


def _assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert numpy.array_equal(g, w)


def test_trainer_on_graphs_equals_eager_trainer():
    sw, owners = _with_graphs(_blobs_run, True)
    eager, _ = _with_graphs(_blobs_run, False)
    _assert_arrays_equal(_unit_arrays(sw), _unit_arrays(eager))
    assert list(sw.decision.epoch_n_err) == \
        list(eager.decision.epoch_n_err)
    assert float(sw.fused_trainer.last_loss) == \
        float(eager.fused_trainer.last_loss)
    receipt = sw.fused_trainer.compile_receipt
    assert receipt is owners[0].receipt
    # train and evaluation steps, a short tail of each
    assert receipt["graphs"] == receipt["captures"] >= 2
    assert receipt["replays"] > receipt["captures"]
    assert receipt["eager_steps"] == 0
    assert eager.fused_trainer.compile_receipt is None


def test_trainer_reads_the_loaders_buffers_in_place():
    """The loader gathers into the same buffers every minibatch, and the
    trainer's graphs take them as their static inputs: nothing is
    copied in."""
    from test_torch_workflow import blobs, build_torch

    def run():
        sw = build_torch(blobs(), epochs=1, fuse=True)
        sw.loader.run()
        first = sw.loader.minibatch_data.devmem
        sw.fused_trainer.run()
        sw.loader.run()
        assert sw.loader.minibatch_data.devmem is first
        sw.fused_trainer.run()
        return sw

    sw, _ = _with_graphs(run, True)
    step = sw.fused_trainer._step_fn_
    x = sw.loader.minibatch_data.devmem
    assert step._inputs[("x", tuple(x.shape), x.dtype)] is x


def test_unit_arrays_follow_the_donated_state():
    """No stale alias: a host read after each step sees that step's
    values, and the Arrays hold the trainer's buffers."""
    from test_torch_workflow import blobs, build_torch
    from veles_tpu_torch.loader.base import TRAIN

    def run():
        sw = build_torch(blobs(), epochs=1, fuse=True)
        while True:
            sw.loader.run()
            if sw.loader.minibatch_class == TRAIN:
                break
            sw.fused_trainer.run()
        reads = []
        for _ in range(3):
            sw.fused_trainer.run()
            sw.loader.run()
            reads.append(_unit_arrays(sw))
        return sw, reads

    (sw, reads), _ = _with_graphs(run, True)
    assert not numpy.array_equal(reads[0][0], reads[1][0])
    assert not numpy.array_equal(reads[1][0], reads[2][0])
    state = sw.fused_trainer._state_
    assert sw.forwards[0].weights.devmem is state[0]["weights"]
    assert numpy.array_equal(reads[2][0], state[0]["weights"].numpy())


def test_keyed_dropout_trainer_on_graphs_equals_eager():
    from test_torch_workflow import _build_pair, fused_step
    specs = [dict(type="all2all_tanh", output_sample_shape=16,
                  learning_rate=0.1, gradient_moment=0.9),
             {"type": "dropout", "dropout_ratio": 0.4},
             dict(type="softmax", output_sample_shape=4, learning_rate=0.1,
                  gradient_moment=0.9)]

    def run():
        _, sw = _build_pair(specs, (12,), fuse=True)
        for _ in range(2):           # the validation minibatches
            sw.loader.run()
        losses = []
        for _ in range(4):
            fused_step(sw)
            losses.append(float(sw.fused_trainer.last_loss))
        return sw, losses

    (sw, losses), owners = _with_graphs(run, True)
    (eager, want), _ = _with_graphs(run, False)
    assert losses == want
    _assert_arrays_equal(_unit_arrays(sw), _unit_arrays(eager))
    # every step replayed the one keyed graph, its key written anew
    assert owners[0].receipt["graphs"] == 1
    assert owners[0].receipt["replays"] == 4


def test_rollback_on_graphs_recaptures_and_equals_eager(tmp_path,
                                                         monkeypatch):
    """The stale-alias check across snapshot, decision and rollback: a
    sustained NaN trips the watchdog twice, the snapshots restore the
    unit Arrays, and the trainer captures its steps anew, bit for bit
    the eager trainer's run."""
    from test_torch_health import SUSTAINED, _resume_run, _weights
    monkeypatch.chdir(tmp_path)
    (sw, error), owners = _with_graphs(
        lambda: _resume_run("torch", tmp_path / "graphs", SUSTAINED), True)
    (eager, eager_error), _ = _with_graphs(
        lambda: _resume_run("torch", tmp_path / "eager", SUSTAINED), False)
    assert error is None and eager_error is None
    assert sw.snapshotter.rollbacks == eager.snapshotter.rollbacks == 2
    _assert_arrays_equal(_weights(sw), _weights(eager))
    receipt = owners[0].receipt
    # two rollbacks: the graphs were dropped and captured again twice
    assert receipt["captures"] > receipt["graphs"]
    assert receipt["eager_steps"] == 0


def test_trainer_runs_the_raw_step_under_debug_nonfinite(monkeypatch,
                                                          caplog):
    monkeypatch.setattr(common, "DEBUG_NONFINITE", True)
    sw, owners = _with_graphs(lambda: _blobs_run(epochs=1), True)
    monkeypatch.setattr(common, "DEBUG_NONFINITE", False)
    eager, _ = _with_graphs(lambda: _blobs_run(epochs=1), False)
    _assert_arrays_equal(_unit_arrays(sw), _unit_arrays(eager))
    receipt = owners[0].receipt
    # every train and evaluation minibatch ran eagerly, none captured
    assert receipt["captures"] == 0 and receipt["replays"] == 0
    # 5 train minibatches (85 rows by 20), 2 + 2 validation (30 rows)
    assert sw.fused_trainer.iteration == 5
    assert receipt["eager_steps"] == 9
    assert "VELES_DEBUG_NONFINITE" in caplog.text


# -- the engine --------------------------------------------------------------

RECEIPT_KEYS = {"rungs", "seconds", "quantized", "warmups", "graphs",
                "captures", "capture_s", "warmup_launches", "pool_bytes",
                "replays", "eager_steps"}


def _mlp_engine(device=CPU, seed=3):
    from veles_tpu_torch.models.zoo import build_plans_and_state
    from veles_tpu_torch.serve import AOTEngine
    specs = [{"type": "all2all_tanh", "output_sample_shape": 8},
             {"type": "softmax", "output_sample_shape": 3}]
    plans, state, _ = build_plans_and_state(specs, (5,), seed=seed)
    params = [{"weights": e["weights"], "bias": e["bias"]} for e in state]
    return AOTEngine(plans, params, (5,), ladder=(1, 4), device=device), \
        plans, params


def test_engine_receipt_keys_on_the_cpu():
    engine, _, _ = _mlp_engine()
    receipt = engine.compile()
    assert set(receipt) == RECEIPT_KEYS
    assert receipt["graphs"] == receipt["captures"] == 0
    assert receipt["warmups"] == 2 and engine.graphs is None


def test_engine_on_graphs_copies_out_and_sees_swapped_params():
    """The engine's rungs on stand-in graphs: answers equal the eager
    engine's, a later run leaves an earlier output alone, and
    swap_params reaches the next replay without a capture."""
    engine, plans, params = _mlp_engine()
    engine.graphs = fake_owner("engine")
    engine._params_dev = engine._put_params(engine.params)
    from veles_tpu_torch.compiler import build_forward
    engine._forward = build_forward(plans)
    eager, _, _ = _mlp_engine()
    eager.compile()
    x = numpy.random.RandomState(4).randn(4, 5).astype(numpy.float32)
    first = engine.run_host(x, 4)
    kept = first.clone()
    numpy.testing.assert_array_equal(first.numpy(), eager.infer(x))
    engine.run_host(x[::-1].copy(), 4)
    assert torch.equal(first, kept)
    _, _, other = _mlp_engine(seed=9)
    engine.swap_params(other)
    eager.swap_params(other)
    numpy.testing.assert_array_equal(engine.infer(x), eager.infer(x))
    assert engine.graphs.receipt["captures"] == 1


# -- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    from veles_tpu_torch.backends import Device
    return Device()


def _port_case(name):
    """``_case`` built with the port's zoo alone (the card's machine has
    no JAX): the same specs, seeds and steps."""
    from veles_tpu_torch.models.zoo import build_plans_and_state
    if name == "mlp":
        specs = [{"type": "all2all_tanh", "output_sample_shape": 100,
                  "learning_rate": 0.1, "gradient_moment": 0.9},
                 {"type": "softmax", "output_sample_shape": 10,
                  "learning_rate": 0.1, "gradient_moment": 0.9}]
        plans, state, _ = build_plans_and_state(specs, (784,), seed=0)
        data = batches((784,), 10, n=3, batch=32, seed=3)
        return plans, state, [(x, t, 32.0, None, {}) for x, t in data]
    plans, state, _ = build_plans_and_state(*CONVNET, seed=2)
    data = batches(CONVNET[1], CLASSES)
    if name == "dropout":
        steps = [(x, t, 16.0, threefry.fold_in(threefry.key(5), n), {})
                 for n, (x, t) in enumerate(data[:3], 1)]
    elif name == "chaos":
        steps = [(data[0][0], data[0][1], 16.0, None, {}),
                 (data[1][0], data[1][1], 16.0, None,
                  {"grad_poison": numpy.float32(NAN)}),
                 (data[2][0], data[2][1], 16.0, None,
                  {"loss_poison": numpy.float32(-0.0)})]
    else:
        t = data[0][1].copy()
        t[11:] = -1
        steps = [(data[0][0], t, 11.0, None, {}),
                 (data[1][0], data[1][1], 16.0, None, {}),
                 (data[0][0], t, 11.0, None, {})]
    return plans, state, steps


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mlp", "dropout", "chaos", "tail"])
def test_cuda_replay_equals_raw_step(case):
    card = _card()
    plans, state, steps = _port_case(case)
    runs = []
    for step in (build_train_step(plans, donate=False),
                 build_train_step(plans)):
        s, metrics = state_from_jax(state, card), []
        for x, t, size, key, poisons in steps:
            s, m = step(s, card.put(x), card.put(t), size, key, **poisons)
            metrics.append({k: v.clone() for k, v in m.items()})
        runs.append((_copy(s), metrics))
    assert_bits_equal(runs[1][0], runs[0][0])
    for g, w in zip(runs[1][1], runs[0][1]):
        assert_metric_bits_equal(g, w)


@pytest.mark.cuda
def test_cuda_capture_raises_under_debug_nonfinite(monkeypatch):
    card = _card()
    plans, state, steps = _port_case("mlp")
    step = build_train_step(plans)
    x, t, size, _, _ = steps[0]
    monkeypatch.setattr(common, "DEBUG_NONFINITE", True)
    with pytest.raises(GraphCaptureError, match="VELES_DEBUG_NONFINITE"):
        step(state_from_jax(state, card), card.put(x), card.put(t), size)


@pytest.mark.cuda
def test_cuda_counters_count_replays():
    card = _card()
    from veles_tpu_torch.ops.pool_bwd import max_pool_bwd
    plans, state, steps = _port_case("tail")
    step = build_train_step(plans)
    x, t = batches(CONVNET[1], CLASSES)[0]
    s = state_from_jax(state, card)
    before = (conv_wgrad.launches, max_pool_bwd.launches)
    for _ in range(3):
        s, _ = step(s, card.put(x), card.put(t), 16.0)
    assert (conv_wgrad.launches - before[0],
            max_pool_bwd.launches - before[1]) == (6, 6)
    assert step.graphs.receipt["replays"] == 3
    assert math.isfinite(float(step.graphs.receipt["capture_s"]))


def test_port_cases_are_the_jax_cases():
    """The ``cuda`` tests' port-built cases equal the JAX-built ones."""
    for name in ("mlp", "dropout", "chaos", "tail"):
        plans, state, steps = _port_case(name)
        jplans, jstate, jsteps, _ = _case(name)
        assert [p.forward_cls for p in plans] == \
            [p.forward_cls for p in port_plans(jplans)]
        if name != "mlp":
            assert_bits_equal(state_from_jax(state, CPU),
                              state_from_jax(jstate, CPU))
        assert len(steps) == len(jsteps)
