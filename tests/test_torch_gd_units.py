"""The port's per-unit GD units (veles_tpu_torch/models: gd_conv,
gd_pooling, dropout, transformer's GD half, activation, deconv,
lr_adjust; nn_units' shared ``descend``) against the JAX package's, on
the same seeded numpy inputs, on the CPU.

The JAX side reaches its Pallas kernels in interpret mode with
``veles_tpu.ops.common.PALLAS_BWD_ENV`` = "1" and its stock autodiff
with "0"; the port's wrappers run their plain versions on CPU tensors.
Tolerances (max-rel unless stated):

- conv GD, on tests/test_torch_conv_vjp.py's five activation cases with
  weight decay, an L1 blend and momentum: at "1" (bf16x3 products on
  both sides) the gradients' solver state and the updated leaves within
  1e-6, err_input within 1e-5, the level-0 bounds of that file; at "0"
  (JAX true f32) within 1e-5;
- pooling GD (max, avg, max-abs; tiled and overlapping ceil-mode
  windows): within 1 ulp;
- dropout: the per-unit masks and outputs bit-equal to JAX's
  ``DropoutForward`` over train steps 1-3 with an evaluation minibatch
  in between; the backward exact;
- transformer GD (layer norm, attention, block): the gradients' solver
  state within 1e-5 and err_input within 1e-5 at "1" (the JAX flash
  kernel's level-0 products), 1e-5 at "0", tests/test_torch_transformer.py's
  forward bound;
- the seven activation units, deconv and depooling, forward and
  backward: 1e-6 (the same elementwise formulas; deconv's sums in
  another order);
- the learning-rate policies and Rollback: the JAX package's
  tests/test_lr_adjust.py cases give the same numbers in both.

The kernels' wrappers are looked up in their modules at each call (a
swap reaches the GD units), and the first conv layer skips the dgrad.
On the card (``cuda``), each GD unit launches its kernel.
"""

import numpy
import pytest
import torch

from veles_tpu_torch.backends import Device
from veles_tpu_torch.dummy import DummyUnit, DummyWorkflow
from veles_tpu_torch.memory import Array
from veles_tpu_torch.models import (activation, deconv, dropout, gd_conv,
                                    gd_pooling, lr_adjust, transformer)
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.ops import conv_vjp, pool_bwd

from test_torch_conv_vjp import CASES, IDS, _case

CPU = Device(backend="cpu")

#: every hyperparameter away from its default, so the regularization
#: and both solver paths show
HYPER = {"learning_rate": 0.05, "learning_rate_bias": 0.04,
         "weights_decay": 1e-3, "weights_decay_bias": 2e-3,
         "l1_vs_l2": 0.3, "gradient_moment": 0.9,
         "gradient_moment_bias": 0.8, "adadelta_rho": 0.95,
         "solver_epsilon": 1e-6}

CONV_CLASSES = {"linear": "GDConv", "strict_relu": "GDConvStrictRELU",
                "relu_log": "GDConvRELU", "tanh": "GDConvTanh",
                "sigmoid": "GDConvSigmoid"}


@pytest.fixture(params=["1", "0"], ids=["pallas", "stock"])
def pallas(request, monkeypatch):
    """The JAX package's backward: its Pallas kernels in interpret mode
    ("1") or its stock autodiff ("0")."""
    from veles_tpu.ops import common
    monkeypatch.setattr(common, "PALLAS_BWD_ENV", request.param)
    return request.param


def _max_rel(a, b):
    a = numpy.asarray(a, numpy.float64)
    b = numpy.asarray(b, numpy.float64)
    return float(numpy.abs(a - b).max() / max(numpy.abs(b).max(), 1e-12))


def _max_ulp(got, want):
    got = numpy.asarray(got, numpy.float32)
    want = numpy.asarray(want, numpy.float32)
    ulp = numpy.spacing(numpy.maximum(numpy.abs(want), numpy.float32(
        numpy.finfo(numpy.float32).tiny)))
    return float(numpy.max(numpy.abs(got.astype(numpy.float64) - want) /
                           ulp))


def _t(array):
    return None if array is None else torch.from_numpy(numpy.array(array))


def _state(w, b, seed):
    """A layer's state with nonzero momentum buffers."""
    rng = numpy.random.RandomState(seed)
    return {"weights": w, "bias": b,
            "accum_weights": (rng.randn(*w.shape) * 0.01).astype(
                numpy.float32),
            "accum_bias": None if b is None else (
                rng.randn(*b.shape) * 0.01).astype(numpy.float32),
            "accum2_weights": None, "accum2_bias": None}


def _jax_backward(cls, state, x, y, dy, **kwargs):
    import jax.numpy as jnp
    jstate = {k: None if v is None else jnp.asarray(v)
              for k, v in state.items()}
    err_input, new_state = cls.backward(
        jstate, HYPER, jnp.asarray(x), jnp.asarray(y), jnp.asarray(dy),
        **kwargs)
    return (None if err_input is None else numpy.asarray(err_input),
            {k: None if v is None else numpy.asarray(v)
             for k, v in new_state.items()})


def _port_backward(cls, state, x, y, dy, **kwargs):
    err_input, new_state = cls.backward(
        {k: _t(v) for k, v in state.items()}, HYPER, _t(x), _t(y), _t(dy),
        **kwargs)
    return (None if err_input is None else err_input.numpy(),
            {k: None if v is None else v.numpy()
             for k, v in new_state.items()})


def _assert_leaves(got, want, tol, keys=None):
    for key in keys or want:
        if want[key] is None:
            assert got[key] is None, key
            continue
        assert _max_rel(got[key], want[key]) <= tol, (
            key, _max_rel(got[key], want[key]))


# -- conv ---------------------------------------------------------------------


@pytest.mark.parametrize("shape,co,ksize,activation,padding,sliding",
                         CASES[:5], ids=IDS[:5])
def test_conv_gd_matches_jax(pallas, shape, co, ksize, activation, padding,
                             sliding):
    import veles_tpu.models.gd_conv as jax_gd_conv
    x, w, y, dy = _case(shape, co, ksize, activation, padding, sliding)
    b = numpy.random.RandomState(3).randn(co).astype(numpy.float32) * 0.1
    state = _state(w, b, 4)
    kwargs = dict(solver="momentum", include_bias=True, need_err_input=True,
                  padding=padding, sliding=sliding)
    name = CONV_CLASSES[activation]
    jerr, jnew = _jax_backward(getattr(jax_gd_conv, name), state, x, y, dy,
                               **kwargs)
    terr, tnew = _port_backward(getattr(gd_conv, name), state, x, y, dy,
                                **kwargs)
    tol = 1e-6 if pallas == "1" else 1e-5
    assert int(tnew.pop("skipped")) == int(jnew.pop("skipped")) == 0
    _assert_leaves(tnew, jnew, tol)
    assert terr.shape == x.shape
    assert _max_rel(terr, jerr) <= 1e-5


def test_conv_gd_first_layer_skips_the_dgrad(monkeypatch):
    """need_err_input=False: no err_input, no dgrad, the same update."""
    x, w, y, dy = _case(*CASES[1])
    state = _state(w, numpy.zeros(w.shape[-1], numpy.float32), 5)
    kwargs = dict(solver="momentum", include_bias=True, padding=CASES[1][4],
                  sliding=CASES[1][5])
    _, want = _port_backward(gd_conv.GDConvStrictRELU, state, x, y, dy,
                             need_err_input=True, **kwargs)

    def refuse(*args, **kw):
        raise AssertionError("the first layer ran the dgrad")
    monkeypatch.setattr(conv_vjp, "conv_dgrad", refuse)
    err, got = _port_backward(gd_conv.GDConvStrictRELU, state, x, y, dy,
                              need_err_input=False, **kwargs)
    assert err is None
    for key in want:
        if want[key] is not None:
            assert got[key].tobytes() == want[key].tobytes(), key


def test_gd_units_look_their_kernels_up_at_call_time(monkeypatch):
    """A swap of ``conv_vjp.conv_wgrad`` or ``pool_bwd.max_pool_bwd``
    reaches GDConv and GDMaxPooling (the plain-version swap of the card's
    comparison runs)."""
    calls = []

    def spy(inner, name):
        def wrapper(*args, **kwargs):
            calls.append(name)
            return inner(*args, **kwargs)
        return wrapper
    monkeypatch.setattr(conv_vjp, "conv_wgrad",
                        spy(conv_vjp.conv_wgrad, "conv_wgrad"))
    monkeypatch.setattr(pool_bwd, "max_pool_bwd",
                        spy(pool_bwd.max_pool_bwd, "max_pool_bwd"))
    x, w, y, dy = _case(*CASES[0])
    _port_backward(gd_conv.GDConv, _state(w, None, 1), x, y, dy,
                   solver="momentum", include_bias=False,
                   need_err_input=True)
    px, py, pdy = _pool_case((2, 8, 8, 3), (2, 2), (2, 2))
    _port_backward(gd_pooling.GDMaxPooling, _EMPTY, px, py, pdy,
                   solver="momentum", include_bias=False,
                   need_err_input=True, window=(2, 2), sliding=(2, 2))
    assert calls == ["conv_wgrad", "max_pool_bwd"]


# -- pooling ------------------------------------------------------------------

_EMPTY = {"weights": None, "bias": None, "accum_weights": None,
          "accum_bias": None, "accum2_weights": None, "accum2_bias": None}
POOLS = [((2, 8, 8, 3), (2, 2), (2, 2)),
         ((2, 9, 11, 4), (3, 3), (2, 2))]
POOL_IDS = ["tiled", "overlapping_ceil"]


def _pool_case(shape, window, sliding, kind="max_pooling", seed=0):
    from veles_tpu_torch.models import pooling
    cls = {"max_pooling": pooling.MaxPooling,
           "avg_pooling": pooling.AvgPooling,
           "maxabs_pooling": pooling.MaxAbsPooling}[kind]
    rng = numpy.random.RandomState(seed)
    x = rng.randn(*shape).astype(numpy.float32)
    y = cls.apply({}, _t(x), window=window, sliding=sliding).numpy()
    dy = rng.randn(*y.shape).astype(numpy.float32)
    return x, y, dy


@pytest.mark.parametrize("kind,cls_name", [
    ("max_pooling", "GDMaxPooling"), ("avg_pooling", "GDAvgPooling"),
    ("maxabs_pooling", "GDMaxAbsPooling")], ids=["max", "avg", "maxabs"])
@pytest.mark.parametrize("shape,window,sliding", POOLS, ids=POOL_IDS)
def test_pooling_gd_matches_jax(pallas, kind, cls_name, shape, window,
                                sliding):
    import veles_tpu.models.gd_pooling as jax_gd_pooling
    x, y, dy = _pool_case(shape, window, sliding, kind)
    kwargs = dict(solver="momentum", include_bias=False,
                  need_err_input=True, window=window, sliding=sliding)
    jerr, jnew = _jax_backward(getattr(jax_gd_pooling, cls_name), _EMPTY,
                               x, y, dy, **kwargs)
    terr, tnew = _port_backward(getattr(gd_pooling, cls_name), _EMPTY, x, y,
                                dy, **kwargs)
    assert tnew == jnew == {}
    assert terr.shape == jerr.shape == x.shape
    assert _max_ulp(terr, jerr) <= 1.0


def test_pooling_gd_unit_is_stateless():
    unit = gd_pooling.GDMaxPooling(DummyWorkflow(), kx=2, ky=2)
    assert "weights" not in unit._demanded and not unit.include_bias
    assert unit.backward_static() == {"window": (2, 2), "sliding": (2, 2)}
    unit._init_solver_state()
    assert not unit.accum_weights and not unit.accum_bias


# -- dropout ------------------------------------------------------------------


def _dropout_pair(ratio, shape):
    """The JAX and port DropoutForward units over one input, seeded
    alike, initialized on each package's CPU device."""
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.dummy import DummyWorkflow as JaxWorkflow
    from veles_tpu.memory import Array as JaxArray
    from veles_tpu.models.dropout import DropoutForward as JaxDropout
    from veles_tpu.prng import RandomGenerator as JaxRandom
    from veles_tpu_torch.prng import RandomGenerator
    x = numpy.random.RandomState(1).randn(*shape).astype(numpy.float32)
    units = []
    for cls, wf, arr, rng, device in (
            (JaxDropout, JaxWorkflow(), JaxArray, JaxRandom,
             JaxDevice(backend="cpu")),
            (dropout.DropoutForward, DummyWorkflow(), Array,
             RandomGenerator, CPU)):
        unit = cls(wf, dropout_ratio=ratio, prng=rng("dropout", seed=77))
        unit.input = arr(numpy.array(x))
        unit.input.initialize(device)
        unit.minibatch_class = 2
        unit.initialize(device=device)
        units.append(unit)
    return units


@pytest.mark.parametrize("ratio", [0.5, 0.2])
def test_dropout_masks_bit_equal_to_jax(ratio):
    """Train, train, evaluation, train: the masks and outputs of steps 1,
    2 and 4 bit for bit; the evaluation step passes the input through and
    resets the mask, and still counts as a step."""
    junit, tunit = _dropout_pair(ratio, (8, 37))
    for step, cls in enumerate((2, 2, 1, 2), start=1):
        for unit in (junit, tunit):
            unit.minibatch_class = cls
            unit.run()
        assert tunit._step == junit._step == step
        junit.output.map_read()
        tout = tunit.output.devmem.numpy()
        assert tout.tobytes() == numpy.asarray(junit.output.mem).tobytes()
        if cls != 2:
            assert not tunit.mask and not junit.mask
            continue
        junit.mask.map_read()
        tmask = tunit.mask.devmem.numpy()
        assert tmask.tobytes() == numpy.asarray(junit.mask.mem).tobytes()
        assert 0 < numpy.count_nonzero(tmask) < tmask.size


def test_dropout_backward_is_exact():
    """err_input = err_output * mask, the identity after a reset."""
    tunit = _dropout_pair(0.5, (8, 37))[1]
    tunit.run()
    back = dropout.DropoutBackward(DummyWorkflow())
    back.mask = tunit.mask
    err = numpy.random.RandomState(2).randn(8, 37).astype(numpy.float32)
    back.err_output = Array(err)
    back.initialize(device=CPU)
    back.run()
    mask = tunit.mask.devmem.numpy()
    assert back.err_input.devmem.numpy().tobytes() == \
        (err * mask).tobytes()
    tunit.minibatch_class = 1
    tunit.run()
    back.run()
    assert back.err_input.devmem.numpy().tobytes() == err.tobytes()


# -- transformer --------------------------------------------------------------

B, T, D, HEADS, HIDDEN = 3, 12, 16, 2, 32


def _transformer_case(kind, seed=0):
    rng = numpy.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(numpy.float32)
    if kind == "layer_norm":
        w = (1 + 0.1 * rng.randn(D)).astype(numpy.float32)
        b = (0.1 * rng.randn(D)).astype(numpy.float32)
        static = {"eps": 1e-5}
    elif kind == "attention":
        w = (rng.randn(D, 4 * D) * 0.2).astype(numpy.float32)
        b = (rng.randn(4 * D) * 0.1).astype(numpy.float32)
        static = {"heads": HEADS}
    else:
        w, b = transformer.init_block_params(D, HIDDEN, rng)
        b = b + (rng.randn(*b.shape) * 0.05).astype(numpy.float32)
        static = {"heads": HEADS, "hidden": HIDDEN, "eps": 1e-5}
    cls = {"layer_norm": transformer.LayerNorm,
           "attention": transformer.MultiHeadAttention,
           "transformer": transformer.TransformerBlock}[kind]
    y = cls.apply({"weights": _t(w), "bias": _t(b)}, _t(x),
                  **static).numpy()
    dy = rng.randn(*y.shape).astype(numpy.float32)
    return x, w, b, y, dy, static


@pytest.mark.parametrize("kind,cls_name", [
    ("layer_norm", "GDLayerNorm"), ("attention", "GDMultiHeadAttention"),
    ("transformer", "GDTransformerBlock")],
    ids=["layer_norm", "attention", "block"])
def test_transformer_gd_matches_jax(pallas, kind, cls_name):
    import veles_tpu.models.transformer as jax_transformer
    x, w, b, y, dy, static = _transformer_case(kind)
    state = _state(w, b, 6)
    kwargs = dict(solver="momentum", include_bias=True, need_err_input=True,
                  **static)
    jerr, jnew = _jax_backward(getattr(jax_transformer, cls_name), state, x,
                               y, dy, **kwargs)
    terr, tnew = _port_backward(getattr(transformer, cls_name), state, x, y,
                                dy, **kwargs)
    assert int(tnew.pop("skipped")) == int(jnew.pop("skipped")) == 0
    _assert_leaves(tnew, jnew, 1e-5)
    assert _max_rel(terr, jerr) <= 1e-5


def test_transformer_gd_recovers_hidden_from_the_packed_length():
    wf = DummyWorkflow()
    unit = transformer.GDTransformerBlock(wf, heads=HEADS)
    w, _ = transformer.init_block_params(D, 24, numpy.random.RandomState(0))
    unit.weights = Array(w)
    unit.input = Array(numpy.zeros((B, T, D), numpy.float32))
    assert unit.backward_static() == {"heads": HEADS, "hidden": 24,
                                      "eps": 1e-5}


# -- standalone activations, deconv, depooling --------------------------------

ACTIVATIONS = [("activation_tanh", {}), ("activation_relu", {}),
               ("activation_str", {}), ("activation_sigmoid", {}),
               ("activation_log", {}), ("activation_mul", {}),
               ("activation_mul", {"factor": 2.5})]


def _classes(module, base, mapping):
    return [getattr(module, name) for name in dir(module)
            if isinstance(getattr(module, name), type) and issubclass(
                getattr(module, name), base) and
            getattr(getattr(module, name), "MAPPING", None) == mapping][0]


@pytest.mark.parametrize("mapping,kwargs", ACTIVATIONS,
                         ids=["tanh", "relu", "str", "sigmoid", "log", "mul",
                              "mul_2.5"])
def test_activation_units_match_jax(mapping, kwargs):
    import veles_tpu.models.activation as jax_activation
    from veles_tpu.models.nn_units import (
        ForwardBase as JaxForward, GradientDescentBase as JaxGD)
    from veles_tpu_torch.models.nn_units import (ForwardBase,
                                                 GradientDescentBase)
    rng = numpy.random.RandomState(8)
    x = (rng.randn(6, 5, 4) * 2).astype(numpy.float32)
    dy = rng.randn(6, 5, 4).astype(numpy.float32)
    jfwd = _classes(jax_activation, JaxForward, mapping)
    tfwd = _classes(activation, ForwardBase, mapping)
    static = dict(kwargs)
    jy = numpy.asarray(jfwd.apply({}, x, **static))
    ty = tfwd.apply({}, _t(x), **static).numpy()
    assert _max_rel(ty, jy) <= 1e-6
    back = {} if mapping != "activation_mul" else \
        {"factor": kwargs.get("factor", 1.0)}
    jerr, jnew = _jax_backward(
        _classes(jax_activation, JaxGD, mapping), _EMPTY, x, jy, dy,
        solver="momentum", include_bias=False, need_err_input=True, **back)
    terr, tnew = _port_backward(
        _classes(activation, GradientDescentBase, mapping), _EMPTY, x, jy,
        dy, solver="momentum", include_bias=False, need_err_input=True,
        **back)
    assert tnew == jnew == {}
    assert _max_rel(terr, jerr) <= 1e-6


def test_activation_units_run_in_a_chain():
    """ForwardMul -> BackwardMul as units: the forward's output scaled,
    the backward's err_input scaled, no input demanded."""
    wf = DummyWorkflow()
    x = numpy.arange(12, dtype=numpy.float32).reshape(3, 4)
    fwd = activation.ForwardMul(wf, factor=3.0)
    fwd.input = Array(x)
    fwd.initialize(device=CPU)
    fwd.run()
    back = activation.BackwardMul(wf, factor=3.0)
    assert "input" not in back._demanded and "weights" not in back._demanded
    back.output = fwd.output
    back.err_output = Array(numpy.ones((3, 4), numpy.float32))
    back.initialize(device=CPU)
    back.run()
    assert fwd.output.devmem.numpy().tolist() == (x * 3).tolist()
    assert back.err_input.devmem.numpy().tolist() == [[3.0] * 4] * 3


DECONVS = [((2, 5, 6, 3), 4, (3, 3), (0, 0, 0, 0), (1, 1), False),
           ((2, 4, 5, 3), 2, (3, 2), (1, 0, 2, 1), (2, 3), True),
           ((2, 4, 4, 1), 1, (3, 3), (1, 1, 1, 1), (1, 1), True)]


@pytest.mark.parametrize("shape,co,ksize,padding,sliding,bias", DECONVS,
                         ids=["plain", "strided_asym_bias", "autoencoder"])
def test_deconv_matches_jax(shape, co, ksize, padding, sliding, bias):
    from veles_tpu.models.deconv import (Deconv as JaxDeconv,
                                         GDDeconv as JaxGDDeconv)
    rng = numpy.random.RandomState(9)
    x = rng.randn(*shape).astype(numpy.float32)
    w = (rng.randn(ksize[0], ksize[1], co, shape[-1]) * 0.3).astype(
        numpy.float32)
    b = (rng.randn(co) * 0.1).astype(numpy.float32) if bias else None
    static = dict(padding=padding, sliding=sliding)
    jy = numpy.asarray(JaxDeconv.apply({"weights": w, "bias": b}, x,
                                       **static))
    ty = deconv.Deconv.apply({"weights": _t(w), "bias": _t(b)}, _t(x),
                             **static).numpy()
    assert ty.shape == jy.shape
    assert _max_rel(ty, jy) <= 1e-6
    dy = rng.randn(*jy.shape).astype(numpy.float32)
    state = _state(w, b, 10)
    kwargs = dict(solver="momentum", include_bias=bias,
                  need_err_input=True, **static)
    jerr, jnew = _jax_backward(JaxGDDeconv, state, x, jy, dy, **kwargs)
    terr, tnew = _port_backward(deconv.GDDeconv, state, x, jy, dy, **kwargs)
    assert int(tnew.pop("skipped")) == int(jnew.pop("skipped")) == 0
    _assert_leaves(tnew, jnew, 1e-6)
    assert _max_rel(terr, jerr) <= 1e-6


@pytest.mark.parametrize("window", [(2, 2), (3, 2)])
def test_depooling_matches_jax(window):
    from veles_tpu.models.deconv import (Depooling as JaxDepooling,
                                         GDDepooling as JaxGDDepooling)
    rng = numpy.random.RandomState(11)
    x = rng.randn(2, 3, 4, 5).astype(numpy.float32)
    jy = numpy.asarray(JaxDepooling.apply({}, x, window=window))
    ty = deconv.Depooling.apply({}, _t(x), window=window).numpy()
    assert ty.tobytes() == jy.tobytes()
    dy = rng.randn(*jy.shape).astype(numpy.float32)
    kwargs = dict(solver="momentum", include_bias=False,
                  need_err_input=True, window=window)
    jerr, _ = _jax_backward(JaxGDDepooling, _EMPTY, x, jy, dy, **kwargs)
    terr, tnew = _port_backward(deconv.GDDepooling, _EMPTY, x, jy, dy,
                                **kwargs)
    assert tnew == {}
    assert _max_ulp(terr, jerr) <= 1.0


# -- learning-rate policies and rollback (tests/test_lr_adjust.py) -----------


def test_policies_match_jax():
    import veles_tpu.models.lr_adjust as jax_lr
    for name, args in (("fixed_policy", (0.1,)),
                       ("step_exp_policy", (0.1, 0.5, 10)),
                       ("exp_policy", (1.0, 0.9)),
                       ("inv_policy", (1.0, 1.0, 1.0)),
                       ("inv_policy", (0.3, 0.01, 0.75))):
        for it in (0, 1, 2, 25, 100):
            assert getattr(lr_adjust, name)(*args)(it) == \
                getattr(jax_lr, name)(*args)(it), (name, args, it)


def test_lr_adjust_applies_to_gds_like_jax():
    from veles_tpu.dummy import DummyUnit as JaxUnit, DummyWorkflow as JaxWf
    from veles_tpu.models.lr_adjust import LearningRateAdjust as JaxAdjust
    rates = []
    for adjust_cls, unit_cls, wf in (
            (JaxAdjust, JaxUnit, JaxWf()),
            (lr_adjust.LearningRateAdjust, DummyUnit, DummyWorkflow())):
        gd = unit_cls(wf, learning_rate=1.0, learning_rate_bias=1.0)
        adj = adjust_cls(wf, lr_policy=lr_adjust.exp_policy(1.0, 0.5),
                         bias_lr_policy=lr_adjust.inv_policy(1.0, 0.5))
        adj.add_gd_unit(gd)
        adj._is_initialized_ = True
        seen = []
        for _ in range(3):
            adj.run()
            seen.append((gd.learning_rate, gd.learning_rate_bias))
        rates.append(seen)
    assert rates[0] == rates[1]
    assert rates[1][:2] == [(0.5, 1.0 / 1.5), (0.25, 0.5)]


def test_rollback_restores_best_on_the_device():
    """The counterpart of tests/test_lr_adjust.py's rollback case, on an
    Array the device holds: the slip restores the best weights and
    momentum, which the next device read sees, and halves the rate."""
    wf = DummyWorkflow()
    w = Array(numpy.ones(4, numpy.float32))
    acc = Array(numpy.zeros(4, numpy.float32))
    for arr in (w, acc):
        arr.initialize(CPU)
    gd = DummyUnit(wf, weights=w, accum_weights=acc, learning_rate=1.0,
                   learning_rate_bias=1.0)
    improved = Bool(True)
    rb = lr_adjust.Rollback(wf, lr_cut=0.5)
    rb.improved = improved
    rb.add_gd_unit(gd)
    rb.initialize()
    rb.run()  # the best copy: ones, zeros
    w.set_device_array(torch.full((4,), 99.0), CPU)
    acc.set_device_array(torch.full((4,), 7.0), CPU)
    improved <<= False
    rb.run()  # a slip: restore
    assert w.devmem.tolist() == [1.0] * 4
    assert acc.devmem.tolist() == [0.0] * 4
    assert gd.learning_rate == gd.learning_rate_bias == 0.5
    improved <<= True
    w.set_device_array(torch.full((4,), 2.0), CPU)
    rb.run()  # an improvement refreshes the copy
    improved <<= False
    rb.run()
    assert w.devmem.tolist() == [2.0] * 4
    assert gd.learning_rate == 0.25


# -- the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return Device()


@pytest.mark.cuda
def test_cuda_gd_units_launch_their_kernels(cuda_device):
    """On CUDA tensors GDConv launches conv_wgrad, GDMaxPooling
    max_pool_bwd, the transformer GD units attention_fwd, _dq and _dkv,
    once each, and agree with the CPU (max-rel 1e-5)."""
    from veles_tpu_torch.ops import attention
    counters = (conv_vjp.conv_wgrad, pool_bwd.max_pool_bwd,
                attention.attention_fwd, attention.attention_dq,
                attention.attention_dkv)
    for fn in counters:
        fn.launches = 0
    x, w, y, dy = _case(*CASES[1])
    state = _state(w, numpy.zeros(w.shape[-1], numpy.float32), 5)
    kwargs = dict(solver="momentum", include_bias=True, need_err_input=True,
                  padding=CASES[1][4], sliding=CASES[1][5])
    cpu_err, _ = _port_backward(gd_conv.GDConvStrictRELU, state, x, y, dy,
                                **kwargs)
    err, _ = gd_conv.GDConvStrictRELU.backward(
        {k: None if v is None else _t(v).cuda() for k, v in state.items()},
        HYPER, _t(x).cuda(), _t(y).cuda(), _t(dy).cuda(), **kwargs)
    assert _max_rel(err.cpu().numpy(), cpu_err) <= 1e-5
    px, py, pdy = _pool_case((2, 8, 8, 3), (2, 2), (2, 2))
    perr, _ = gd_pooling.GDMaxPooling.backward(
        _EMPTY, HYPER, _t(px).cuda(), _t(py).cuda(), _t(pdy).cuda(),
        solver="momentum", include_bias=False, need_err_input=True,
        window=(2, 2), sliding=(2, 2))
    cpu_perr, _ = _port_backward(
        gd_pooling.GDMaxPooling, _EMPTY, px, py, pdy, solver="momentum",
        include_bias=False, need_err_input=True, window=(2, 2),
        sliding=(2, 2))
    assert perr.cpu().numpy().tobytes() == cpu_perr.tobytes()
    tx, tw, tb, ty, tdy, static = _transformer_case("attention")
    gd = transformer.GDMultiHeadAttention
    gd.backward({k: None if v is None else _t(v).cuda()
                 for k, v in _state(tw, tb, 6).items()}, HYPER,
                _t(tx).cuda(), _t(ty).cuda(), _t(tdy).cuda(),
                solver="momentum", include_bias=True, need_err_input=True,
                **static)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [1, 1, 1, 1, 1]
