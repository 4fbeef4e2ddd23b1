"""The port's forward layers, zoo and compiler walk against the JAX
package, on the same seeded numpy inputs (veles_tpu_torch/models,
veles_tpu_torch/compiler.py).

Tolerances: matmul-based layers rtol 1e-5 (all2all atol 1e-6, conv atol
1e-5) — the two frameworks sum the products in another order; max
pooling is bit-equal, since max is exact; the zoo's weights are
bit-identical, since both draw from one ``numpy.random.RandomState``
in one order."""

import numpy
import pytest
import torch

from veles_tpu_torch.backends import Device
from veles_tpu_torch.convert import params_from_jax

CPU = Device(backend="cpu")

#: the QUANT.json models at small size: the 784-100-10 MLP and a
#: 16x16x1 -> conv 8 -> pool 2 -> fc 64 -> 10 convnet
MLP = ([{"type": "all2all_tanh", "output_sample_shape": 100},
        {"type": "softmax", "output_sample_shape": 10}], (784,))
CONVNET = ([{"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
             "padding": 1},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "all2all_str", "output_sample_shape": 64},
            {"type": "dropout", "dropout_ratio": 0.5},
            {"type": "softmax", "output_sample_shape": 10}], (16, 16, 1))
#: every ported layer type once, with odd sizes, strides and padding
EVERY_LAYER = ([{"type": "conv_tanh", "n_kernels": 4, "kx": 3, "ky": 2,
                 "padding": (1, 0, 0, 1), "sliding": (2, 1)},
                {"type": "conv_relu", "n_kernels": 5, "kx": 2, "ky": 2},
                {"type": "maxabs_pooling", "kx": 2, "ky": 3,
                 "sliding": (1, 2)},
                {"type": "conv_sigmoid", "n_kernels": 3, "kx": 1,
                 "ky": 1},
                {"type": "avg_pooling", "kx": 2, "ky": 2},
                {"type": "conv", "n_kernels": 3, "kx": 1, "ky": 1},
                {"type": "all2all_relu", "output_sample_shape": 12},
                {"type": "all2all_sigmoid", "output_sample_shape": 11},
                {"type": "all2all", "output_sample_shape": 9},
                {"type": "dropout"},
                {"type": "softmax", "output_sample_shape": 7}],
               (11, 9, 2))
MODELS = {"mlp": MLP, "convnet": CONVNET, "every_layer": EVERY_LAYER}


def build_both(name, seed=0):
    """(jax plans, port plans, params as numpy) for one model."""
    from veles_tpu.models import zoo as jax_zoo
    from veles_tpu_torch.models import zoo
    specs, shape = MODELS[name]
    jplans, jstate, jshape = jax_zoo.build_plans_and_state(specs, shape,
                                                           seed=seed)
    plans, state, out_shape = zoo.build_plans_and_state(specs, shape,
                                                        seed=seed)
    assert out_shape == jshape
    params = [{"weights": s["weights"], "bias": s["bias"]}
              for s in state]
    return jplans, plans, params


def samples(name, n, seed=1):
    shape = MODELS[name][1]
    return numpy.random.RandomState(seed).rand(n, *shape).astype(
        numpy.float32)


def _t(array):
    return torch.from_numpy(numpy.ascontiguousarray(array))


@pytest.mark.parametrize("cls_name", [
    "All2All", "All2AllTanh", "All2AllRELU", "All2AllStrictRELU",
    "All2AllSigmoid", "All2AllSoftmax"])
def test_all2all_matches_jax(cls_name):
    from veles_tpu.models import all2all as jax_all2all
    from veles_tpu_torch.models import all2all
    rng = numpy.random.RandomState(0)
    # scaled so the softplus pass-through (z > 15) and both tanh tails
    # are reached
    x = (rng.randn(6, 3, 5) * 4).astype(numpy.float32)
    params = {"weights": rng.randn(15, 9).astype(numpy.float32),
              "bias": rng.randn(9).astype(numpy.float32)}
    want = numpy.asarray(getattr(jax_all2all, cls_name).apply(params, x))
    got = getattr(all2all, cls_name).apply(
        {k: _t(v) for k, v in params.items()}, _t(x))
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                  atol=1e-6)


@pytest.mark.parametrize("cls_name", ["Conv", "ConvStrictRELU",
                                      "ConvTanh"])
@pytest.mark.parametrize("padding,sliding", [
    ((0, 0, 0, 0), (1, 1)),
    ((1, 1, 1, 1), (1, 1)),
    ((2, 0, 1, 1), (2, 1)),
    ((0, 1, 2, 0), (1, 2)),
])
def test_conv_matches_jax(cls_name, padding, sliding):
    from veles_tpu.models import conv as jax_conv
    from veles_tpu_torch.models import conv
    rng = numpy.random.RandomState(1)
    x = rng.randn(3, 10, 7, 4).astype(numpy.float32)
    params = {"weights": rng.randn(3, 2, 4, 6).astype(numpy.float32),
              "bias": rng.randn(6).astype(numpy.float32)}
    want = numpy.asarray(getattr(jax_conv, cls_name).apply(
        params, x, padding=padding, sliding=sliding, pallas_bwd=False))
    got = getattr(conv, cls_name).apply(
        {k: _t(v) for k, v in params.items()}, _t(x), padding=padding,
        sliding=sliding)
    assert tuple(got.shape) == want.shape
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                  atol=1e-5)


@pytest.mark.parametrize("hw,window,sliding", [
    ((7, 9), (2, 2), (2, 2)),
    ((5, 5), (3, 3), (2, 2)),
    ((7, 4), (3, 2), (1, 3)),
    ((2, 3), (3, 3), (3, 3)),
])
def test_max_pooling_ceil_mode_bit_equal(hw, window, sliding):
    from veles_tpu.models import pooling as jax_pooling
    from veles_tpu_torch.models import pooling
    x = numpy.random.RandomState(2).randn(2, hw[0], hw[1], 3).astype(
        numpy.float32)
    want = numpy.asarray(jax_pooling.MaxPooling.apply(
        {}, x, window=window, sliding=sliding, pallas_bwd=False))
    got = pooling.MaxPooling.apply({}, _t(x), window=window,
                                   sliding=sliding)
    assert tuple(got.shape) == want.shape
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("cls_name", ["MaxAbsPooling", "AvgPooling"])
def test_other_pooling_matches_jax(cls_name):
    from veles_tpu.models import pooling as jax_pooling
    from veles_tpu_torch.models import pooling
    x = numpy.random.RandomState(3).randn(2, 7, 5, 3).astype(
        numpy.float32)
    want = numpy.asarray(getattr(jax_pooling, cls_name).apply(
        {}, x, window=(2, 3), sliding=(2, 2)))
    got = getattr(pooling, cls_name).apply({}, _t(x), window=(2, 3),
                                           sliding=(2, 2))
    assert tuple(got.shape) == want.shape
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                  atol=1e-7)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_weights_bit_identical(name):
    from veles_tpu.models import zoo as jax_zoo
    from veles_tpu_torch.models import zoo
    specs, shape = MODELS[name]
    jplans, jstate, _ = jax_zoo.build_plans_and_state(specs, shape,
                                                      seed=11)
    plans, state, _ = zoo.build_plans_and_state(specs, shape, seed=11)
    assert len(plans) == len(jplans)
    for plan, jplan, entry, jentry in zip(plans, jplans, state, jstate):
        assert plan.forward_cls.__name__ == jplan.forward_cls.__name__
        assert plan.forward_cls.MAPPING == jplan.forward_cls.MAPPING
        assert plan.static == jplan.static
        assert plan.include_bias == jplan.include_bias
        assert plan.hyper == jplan.hyper
        assert sorted(entry) == sorted(jentry)
        for key in entry:
            if jentry[key] is None:
                assert entry[key] is None
            else:
                assert entry[key].dtype == jentry[key].dtype
                assert (entry[key] == jentry[key]).all()


def test_zoo_specs_match_jax():
    from veles_tpu.models import zoo as jax_zoo
    from veles_tpu_torch.models import zoo
    for config in ("A", "D", "E"):
        assert zoo.vgg_layers(config=config) == \
            jax_zoo.vgg_layers(config=config)
    assert zoo.alexnet_layers() == jax_zoo.alexnet_layers()
    assert zoo.mnist_mlp_layers() == jax_zoo.mnist_mlp_layers()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_forward_matches_jax(name):
    from veles_tpu.compiler import build_forward as jax_build_forward
    from veles_tpu_torch.compiler import build_forward
    jplans, plans, params = build_both(name)
    x = samples(name, 5)
    want = numpy.asarray(jax_build_forward(jplans)(params, x))
    got = build_forward(plans)(params_from_jax(params, CPU), _t(x))
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                  atol=1e-6)


def test_unported_layer_type_raises():
    from veles_tpu_torch.models import zoo
    with pytest.raises(ValueError, match="not ported"):
        zoo.build_plans_and_state([{"type": "rnn"}], (4, 8))
