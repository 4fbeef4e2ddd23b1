"""The port's fused training (veles_tpu_torch/compiler.py:
build_train_step, build_train_epoch, build_eval_epoch) against the JAX
package's, on the same seeded numpy inputs.

The JAX step takes its hand-scheduled backward (the Pallas conv-VJP and
pool kernels in interpret mode: ``PALLAS_BWD_ENV`` is set to "1" as
tests/test_pallas_bwd.py sets it), and its epoch gathers lane-aligned
minibatches with the Pallas gather.  The port runs its plain versions
on the CPU.  Tolerances: loss within 1e-5 rel and ``n_err`` equal per
step; every state leaf, ``accum_*`` included, within max-rel 1e-4 after
3 chained momentum steps (the backwards sum in other orders, and the
differences compound through the updates).  Dropout masks come from
JAX's threefry2x32 key stream in both packages (the port's own copy,
``veles_tpu_torch/threefry.py``), so the keyed steps, epochs and fused
trainer are held to the same limits with their masks bit-equal."""

import math

import numpy
import pytest
import torch

from veles_tpu_torch import threefry
from veles_tpu_torch.backends import Device
from veles_tpu_torch.compiler import (LayerPlan, build_eval_epoch,
                                      build_train_epoch, build_train_step)
from veles_tpu_torch.convert import state_from_jax, state_to_numpy
from veles_tpu_torch.models.nn_units import GradientDescentBase

CPU = Device(backend="cpu")
NAN = float("nan")

#: conv_str 3x3 pad 1 -> max-pool 2x2 -> conv -> pool -> all2all_str ->
#: dropout -> softmax, on 8x8x2 images (128-wide rows: the JAX epoch's
#: Pallas gather takes them)
CONVNET = ([
    {"type": "conv_str", "n_kernels": 4, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "conv_tanh", "n_kernels": 6, "kx": 3, "ky": 3, "padding": 1,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_str", "output_sample_shape": 16,
     "learning_rate": 0.05, "gradient_moment": 0.9},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 5, "learning_rate": 0.05,
     "gradient_moment": 0.9},
], (8, 8, 2))
CLASSES = 5


@pytest.fixture
def pallas_on(monkeypatch):
    from veles_tpu.ops import common
    monkeypatch.setattr(common, "PALLAS_BWD_ENV", "1")


def _max_rel(a, b):
    a = numpy.asarray(a, numpy.float64)
    b = numpy.asarray(b, numpy.float64)
    return float(numpy.abs(a - b).max() / max(numpy.abs(b).max(), 1e-12))


def port_plans(jplans):
    """The port's LayerPlans for the JAX ones: same class by MAPPING,
    same solver, hyper, bias flag and static config."""
    from veles_tpu_torch.models.nn_workflow import forward_mapping
    fmap = forward_mapping()
    return [LayerPlan(fmap[p.forward_cls.MAPPING], solver=p.solver,
                      hyper=dict(p.hyper), include_bias=p.include_bias,
                      static=dict(p.static)) for p in jplans]


def convnet():
    from veles_tpu.models.zoo import build_plans_and_state
    jplans, state, _ = build_plans_and_state(*CONVNET, seed=2)
    return jplans, state


def mlp():
    import __graft_entry__ as graft
    jplans = graft._mlp_plans(100, 10)
    state = graft._mlp_state(numpy.random.RandomState(0), 784, 100, 10)
    # its weights come out float64 (f32 / numpy.sqrt); JAX, without x64,
    # runs them as float32, and so does the port
    return jplans, [{k: None if v is None else v.astype(numpy.float32)
                     for k, v in e.items()} for e in state]


def batches(shape, classes, n=4, batch=16, seed=1):
    rng = numpy.random.RandomState(seed)
    return [(rng.randn(batch, *shape).astype(numpy.float32),
             rng.randint(0, classes, batch).astype(numpy.int32))
            for _ in range(n)]


def _tt(array):
    return torch.from_numpy(numpy.array(array))


def assert_states_close(got, want, tol=1e-4):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None, (i, key)
                continue
            assert g[key].shape == numpy.shape(w[key]), (i, key)
            assert _max_rel(g[key], w[key]) <= tol, (i, key)


def assert_states_equal(a, b):
    for ea, eb in zip(a, b):
        for key in ea:
            if ea[key] is None:
                assert eb[key] is None
            else:
                assert torch.equal(ea[key], eb[key]), key


def run_both(jplans, state, data, steps, loss="softmax", seed=None):
    """The same chained steps through the JAX step and the port's;
    returns (port metrics, jax metrics, port state, jax state).  With a
    ``seed``, step n (from 1) is keyed ``fold_in(PRNGKey(seed), n)`` in
    both packages, as the fused trainer keys it."""
    import jax
    from veles_tpu.compiler import build_train_step as jax_build
    jstep = jax_build(jplans, loss=loss, donate=False)
    step = build_train_step(port_plans(jplans), loss=loss)
    js, ps = state, state_from_jax(state, CPU)
    jm, pm = [], []
    for n, i in enumerate(steps, 1):
        x, t = data[i]
        jkey = pkey = None
        if seed is not None:
            jkey = jax.random.fold_in(jax.random.PRNGKey(seed), n)
            pkey = threefry.fold_in(threefry.key(seed), n)
        js, m = jstep(js, x, t, numpy.float32(len(x)), jkey)
        jm.append({k: numpy.asarray(v) for k, v in m.items()})
        ps, m = step(ps, _tt(x), _tt(t), float(len(x)), pkey)
        pm.append({k: v.numpy() for k, v in m.items()})
    js = [{k: None if v is None else numpy.asarray(v)
           for k, v in e.items()} for e in js]
    return pm, jm, state_to_numpy(ps), js


def assert_metrics_close(pm, jm):
    for got, want in zip(pm, jm):
        assert abs(float(got["loss"]) - float(want["loss"])) <= \
            1e-5 * abs(float(want["loss"]))
        assert int(got["n_err"]) == int(want["n_err"])
        assert bool(got["finite"]) and int(got["skipped"]) == 0
        assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
            1e-4 * float(want["grad_norm"])
        if "mse_sum" in want:
            assert abs(float(got["mse_sum"]) - float(want["mse_sum"])) <= \
                1e-5 * abs(float(want["mse_sum"]))


def test_convnet_three_steps_match_jax(pallas_on):
    jplans, state = convnet()
    data = batches(CONVNET[1], CLASSES)
    pm, jm, ps, js = run_both(jplans, state, data, (0, 1, 2))
    assert_metrics_close(pm, jm)
    assert_states_close(ps, js)
    # the steps moved the weights and filled the momentum
    assert not numpy.array_equal(ps[0]["weights"], state[0]["weights"])
    assert numpy.abs(ps[2]["accum_weights"]).max() > 0


@pytest.mark.parametrize("seed", [5, 2 ** 31 - 1])
def test_keyed_dropout_three_steps_match_jax(pallas_on, seed):
    """3 chained keyed steps of the dropout net: the masks are JAX's, so
    the steps agree to the keyless limits; the masks dropped something
    (the keyless run differs)."""
    jplans, state = convnet()
    data = batches(CONVNET[1], CLASSES)
    pm, jm, ps, js = run_both(jplans, state, data, (0, 1, 2), seed=seed)
    assert_metrics_close(pm, jm)
    assert_states_close(ps, js)
    keyless = run_both(jplans, state, data, (0, 1, 2))[2]
    assert not numpy.array_equal(ps[4]["weights"], keyless[4]["weights"])


def test_mlp_three_steps_match_jax():
    jplans, state = mlp()
    data = batches((784,), 10, batch=32, seed=3)
    pm, jm, ps, js = run_both(jplans, state, data, (0, 1, 2))
    assert_metrics_close(pm, jm)
    assert_states_close(ps, js)


@pytest.mark.parametrize("solver", ["momentum", "adagrad", "adadelta"])
def test_mse_and_solvers_match_jax(solver):
    """An mse tail with weight decay (L1/L2 blend) under each solver;
    a short batch_size masks the tail rows."""
    from veles_tpu.compiler import LayerPlan as JaxPlan
    from veles_tpu.models.all2all import All2All, All2AllSigmoid
    hyper = {"learning_rate": 0.05, "gradient_moment": 0.5,
             "weights_decay": 0.01, "l1_vs_l2": 0.3,
             "adadelta_rho": 0.9, "solver_epsilon": 1e-6}
    jplans = [JaxPlan(All2AllSigmoid, solver=solver, hyper=hyper),
              JaxPlan(All2All, solver=solver, hyper=hyper)]
    rng = numpy.random.RandomState(4)
    state = []
    for fi, fo in ((12, 9), (9, 3)):
        w = (rng.randn(fi, fo) * 0.3).astype(numpy.float32)
        b = (rng.randn(fo) * 0.1).astype(numpy.float32)
        state.append({
            "weights": w, "bias": b,
            "accum_weights": numpy.zeros_like(w),
            "accum_bias": numpy.zeros_like(b),
            "accum2_weights": None if solver != "adadelta" else
            numpy.zeros_like(w),
            "accum2_bias": None if solver != "adadelta" else
            numpy.zeros_like(b)})
    from veles_tpu.compiler import build_train_step as jax_build
    jstep = jax_build(jplans, loss="mse", donate=False)
    step = build_train_step(port_plans(jplans), loss="mse")
    js, ps = state, state_from_jax(state, CPU)
    for i in range(3):
        x = rng.randn(10, 12).astype(numpy.float32)
        t = rng.randn(10, 3).astype(numpy.float32)
        js, jm = jstep(js, x, t, numpy.float32(7))
        ps, pm = step(ps, _tt(x), _tt(t), 7.0)
        assert_metrics_close([{k: v.numpy() for k, v in pm.items()}],
                             [{k: numpy.asarray(v) for k, v in jm.items()}])
    js = [{k: None if v is None else numpy.asarray(v)
           for k, v in e.items()} for e in js]
    assert_states_close(state_to_numpy(ps), js)


def test_epochs_with_masked_tail_match_jax(pallas_on):
    """37 samples in steps of 16: two full steps and a masked tail of
    5; then an eval epoch over the trained weights."""
    from veles_tpu.compiler import build_eval_epoch as jax_eval
    from veles_tpu.compiler import build_train_epoch as jax_train
    jplans, state = convnet()
    plans = port_plans(jplans)
    rng = numpy.random.RandomState(7)
    data = rng.randn(37, *CONVNET[1]).astype(numpy.float32)
    labels = rng.randint(0, CLASSES, 37).astype(numpy.int32)
    order = rng.permutation(37).astype(numpy.int32)
    js, jt = jax_train(jplans, 16, donate=False)(state, data, labels,
                                                 order)
    ps, pt = build_train_epoch(plans, 16)(state_from_jax(state, CPU),
                                          _tt(data), _tt(labels),
                                          _tt(order))
    assert abs(float(pt["loss_mean"]) - float(jt["loss_mean"])) <= \
        1e-5 * abs(float(jt["loss_mean"]))
    assert int(pt["n_err"]) == int(jt["n_err"])
    assert int(pt["skipped"]) == int(jt["skipped"]) == 0
    js = [{k: None if v is None else numpy.asarray(v)
           for k, v in e.items()} for e in js]
    assert_states_close(state_to_numpy(ps), js)

    jparams = [{"weights": e["weights"], "bias": e["bias"]} for e in js]
    params = [{"weights": e["weights"], "bias": e["bias"]} for e in ps]
    want = jax_eval(jplans, 16)(jparams, data, labels, order)
    got = build_eval_epoch(plans, 16)(params, _tt(data), _tt(labels),
                                      _tt(order))
    assert int(got["samples"]) == int(want["samples"]) == 37
    assert int(got["n_err"]) == int(want["n_err"])


def test_keyed_epoch_matches_jax(pallas_on):
    """A keyed epoch: step i draws its masks from fold_in(key, i) in
    both packages (37 samples in steps of 16, a masked tail)."""
    import jax
    from veles_tpu.compiler import build_train_epoch as jax_train
    jplans, state = convnet()
    rng = numpy.random.RandomState(9)
    data = rng.randn(37, *CONVNET[1]).astype(numpy.float32)
    labels = rng.randint(0, CLASSES, 37).astype(numpy.int32)
    order = rng.permutation(37).astype(numpy.int32)
    js, jt = jax_train(jplans, 16, donate=False)(
        state, data, labels, order, jax.random.PRNGKey(3))
    # functional (donate=False): the test holds both epochs' states
    epoch = build_train_epoch(port_plans(jplans), 16, donate=False)
    ps, pt = epoch(state_from_jax(state, CPU), _tt(data), _tt(labels),
                   _tt(order), threefry.key(3))
    assert abs(float(pt["loss_mean"]) - float(jt["loss_mean"])) <= \
        1e-5 * abs(float(jt["loss_mean"]))
    assert int(pt["n_err"]) == int(jt["n_err"])
    assert int(pt["skipped"]) == int(jt["skipped"]) == 0
    js = [{k: None if v is None else numpy.asarray(v)
           for k, v in e.items()} for e in js]
    assert_states_close(state_to_numpy(ps), js)
    keyless, _ = epoch(state_from_jax(state, CPU), _tt(data), _tt(labels),
                       _tt(order))
    assert not torch.equal(ps[4]["weights"], keyless[4]["weights"])


def test_fused_trainer_keyed_dropout_matches_jax():
    """A fused workflow with a dropout layer, 4 train minibatches in
    both packages: each step keyed fold_in(PRNGKey(dropout_seed),
    iteration), the losses within 1e-5 rel and every leaf within 1e-4
    of the JAX package's fused trainer."""
    from test_torch_workflow import _build_pair, fused_step, torch_state
    specs = [dict(type="all2all_tanh", output_sample_shape=16,
                  learning_rate=0.1, gradient_moment=0.9),
             {"type": "dropout", "dropout_ratio": 0.4},
             dict(type="softmax", output_sample_shape=4, learning_rate=0.1,
                  gradient_moment=0.9)]
    jsw, tsw = _build_pair(specs, (12,), fuse=True)
    for sw in (jsw, tsw):
        for _ in range(2):           # the validation minibatches
            sw.loader.run()
    for _ in range(4):
        for sw in (jsw, tsw):
            fused_step(sw)
        want = float(jsw.fused_trainer.last_loss)
        assert abs(float(tsw.fused_trainer.last_loss) - want) <= \
            1e-5 * abs(want)
    assert tsw.fused_trainer.iteration == jsw.fused_trainer._iteration == 4
    want = [{k: None if v is None else numpy.asarray(v)
             for k, v in entry.items()}
            for entry in jsw.fused_trainer._state]
    assert_states_close(torch_state(tsw), want)


def test_mse_eval_epoch_matches_jax():
    from veles_tpu.compiler import LayerPlan as JaxPlan
    from veles_tpu.compiler import build_eval_epoch as jax_eval
    from veles_tpu.models.all2all import All2AllTanh
    jplans = [JaxPlan(All2AllTanh)]
    rng = numpy.random.RandomState(8)
    params = [{"weights": rng.randn(6, 4).astype(numpy.float32),
               "bias": rng.randn(4).astype(numpy.float32)}]
    data = rng.randn(11, 6).astype(numpy.float32)
    targets = rng.randn(11, 4).astype(numpy.float32)
    order = rng.permutation(11).astype(numpy.int32)
    want = jax_eval(jplans, 4, loss="mse")(params, data, targets, order)
    got = build_eval_epoch(port_plans(jplans), 4, loss="mse")(
        state_from_jax(params, CPU), _tt(data), _tt(targets), _tt(order))
    assert int(got["samples"]) == int(want["samples"]) == 11
    assert abs(float(got["mse_sum"]) - float(want["mse_sum"])) <= \
        1e-5 * abs(float(want["mse_sum"]))


def test_poisoned_step_leaves_state_bit_identical():
    """A nan gradient skips the step: params and solver accumulators
    stay bit-identical to never having served that minibatch."""
    jplans, state = convnet()
    # functional (donate=False): the test holds states across calls
    step = build_train_step(port_plans(jplans), donate=False)
    data = [(_tt(x), _tt(t)) for x, t in batches(CONVNET[1], CLASSES)]

    def run(s, indices, **kwargs):
        m = None
        for i in indices:
            s, m = step(s, data[i][0], data[i][1], 16.0, **kwargs)
        return s, m

    ref, m = run(state_from_jax(state, CPU), (0, 1, 3))
    assert bool(m["finite"]) and int(m["skipped"]) == 0
    got, _ = run(state_from_jax(state, CPU), (0, 1))
    before = got
    got, m = run(got, (2,), grad_poison=numpy.float32(NAN))
    assert not bool(m["finite"]) and int(m["skipped"]) == 1
    assert not math.isfinite(float(m["grad_norm"]))
    assert_states_equal(got, before)
    got, m = run(got, (2,), loss_poison=numpy.float32(NAN))
    assert int(m["skipped"]) == 1
    got, _ = run(got, (3,))
    assert_states_equal(ref, got)


def test_keyed_dropout_rate_scale_and_determinism():
    from veles_tpu_torch.models.dropout import DropoutForward
    mask = DropoutForward.make_mask(threefry.key(5), (200, 500), 0.3,
                                    torch.float32, torch.device("cpu"))
    values = set(torch.unique(mask).tolist())
    assert values == {0.0, numpy.float32(1 / 0.7)}
    assert abs(float((mask > 0).float().mean()) - 0.7) < 0.01
    jplans, state = convnet()
    # functional (donate=False): the test holds states across calls
    step = build_train_step(port_plans(jplans), donate=False)
    x, t = (_tt(a) for a in batches(CONVNET[1], CLASSES)[0])
    outs = []
    for seed in (11, 11, 12):
        s, m = step(state_from_jax(state, CPU), x, t, 16.0,
                    threefry.key(seed))
        assert bool(m["finite"])
        outs.append(s)
    assert_states_equal(outs[0], outs[1])
    keyless, _ = step(state_from_jax(state, CPU), x, t, 16.0)
    assert not torch.equal(outs[0][4]["weights"], outs[2][4]["weights"])
    assert not torch.equal(outs[0][4]["weights"], keyless[4]["weights"])


@pytest.mark.parametrize("kwarg", [{"mesh": object()},
                                   {"grad_bucket_mb": 25.0},
                                   {"grad_compress": "bf16"},
                                   {"zero": 1}, {"bwd_remat": True}])
def test_queued_variants_raise(kwarg):
    """The variants are ported (the parallel layer, tests/test_torch_
    bucketed.py and tests/test_torch_mesh.py hold the meshed ones
    against JAX): without a mesh, as in the JAX package, the mesh
    options leave the one-device step as it is, ``zero=1`` raises its
    ValueError, and ``bwd_remat`` gives the same bits."""
    jplans, state = convnet()
    x, t = (_tt(a) for a in batches(CONVNET[1], CLASSES)[0])
    plans = port_plans(jplans)
    if "zero" in kwarg:
        with pytest.raises(ValueError, match="zero=1 needs a mesh"):
            build_train_step(plans, **kwarg)
        return
    if "mesh" in kwarg:
        # a mesh alone (no shardings, no buckets) is the one-device step
        kwarg = {"mesh": object()}
    a, _ = build_train_step(plans)(state_from_jax(state, CPU), x, t, 16.0)
    b, _ = build_train_step(plans, **kwarg)(state_from_jax(state, CPU), x,
                                            t, 16.0)
    assert_states_equal(a, b)


def test_scheduling_hint_has_no_effect():
    jplans, state = convnet()
    x, t = (_tt(a) for a in batches(CONVNET[1], CLASSES)[0])
    a, _ = build_train_step(port_plans(jplans))(
        state_from_jax(state, CPU), x, t, 16.0)
    b, _ = build_train_step(port_plans(jplans), bwd_schedule=True)(
        state_from_jax(state, CPU), x, t, 16.0)
    assert_states_equal(a, b)


def test_empty_order_raises():
    jplans, state = convnet()
    epoch = build_train_epoch(port_plans(jplans), 16)
    with pytest.raises(ValueError, match="empty"):
        epoch(state_from_jax(state, CPU), torch.zeros(4, 8, 8, 2),
              torch.zeros(4, dtype=torch.int32),
              torch.zeros(0, dtype=torch.int32))


@pytest.mark.parametrize("solver", ["momentum", "adagrad", "adadelta"])
def test_solver_formulas_match_jax(solver):
    from veles_tpu.models.nn_units import GradientDescentBase as JaxGD
    rng = numpy.random.RandomState(9)
    p, g, a, a2 = (rng.randn(5, 4).astype(numpy.float32) for _ in range(4))
    a, a2 = numpy.abs(a), numpy.abs(a2)
    want = JaxGD.solver_update(solver, p, JaxGD.regularized(g, p, 0.01,
                                                            0.25),
                               a, a2, 0.1, 0.9, 0.95, 1e-6)
    got = GradientDescentBase.solver_update(
        solver, _tt(p), GradientDescentBase.regularized(
            _tt(g), _tt(p), 0.01, 0.25), _tt(a), _tt(a2), 0.1, 0.9, 0.95,
        1e-6)
    for gv, wv in zip(got, want):
        numpy.testing.assert_allclose(gv.numpy(), numpy.asarray(wv),
                                      rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        GradientDescentBase.solver_update("lbfgs", *got, None, 0.1, 0.9,
                                          0.95, 1e-6)


def test_finite_guard_selects_old_leaves():
    old = {"weights": torch.ones(3), "bias": None}
    new = {"weights": torch.full((3,), 2.0), "bias": None}
    ok = GradientDescentBase.finite_guard(old, new, torch.zeros(3), None)
    assert int(ok["skipped"]) == 0 and torch.equal(ok["weights"],
                                                   new["weights"])
    bad = GradientDescentBase.finite_guard(
        old, new, torch.tensor([0.0, float("inf"), 0.0]))
    assert int(bad["skipped"]) == 1 and torch.equal(bad["weights"],
                                                    old["weights"])
    assert bad["bias"] is None


def test_state_round_trip_keeps_none_leaves():
    _, state = convnet()
    back = state_to_numpy(state_from_jax(state, CPU))
    for entry, orig in zip(back, state):
        assert sorted(entry) == sorted(orig)
        for key in orig:
            if orig[key] is None:
                assert entry[key] is None
            else:
                assert (entry[key] == orig[key]).all()
