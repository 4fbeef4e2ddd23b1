"""The port's post-training quantization (veles_tpu_torch/quant) against
the JAX package's, on the same seeded weights and calibration stream.

Tolerances: weight quantization is bit-equal (same numpy arithmetic);
activation scales rtol 1e-5 (they are solved on the f32 activations,
which the two frameworks sum in another order); the quantized forward
atol 1e-3 on the softmax outputs, since a 1-ulp f32 difference in an
activation can move it across one quantization level."""

import json
import os

import numpy
import pytest
import torch

from tests.test_torch_models import CPU, build_both, samples
from veles_tpu_torch.convert import params_from_jax

pytestmark = pytest.mark.quant


@pytest.mark.parametrize("granularity", ["channel", "tensor"])
@pytest.mark.parametrize("shape", [(20, 7), (3, 3, 4, 6)])
def test_quantize_weights_bit_equal(granularity, shape):
    from veles_tpu.quant import quantize_weights as jax_quantize_weights
    from veles_tpu_torch.quant import quantize_weights
    w = numpy.random.RandomState(0).randn(*shape).astype(numpy.float32)
    w[..., 1] = 0.0  # an all-zero channel gets scale 1.0
    jq, js = jax_quantize_weights(w, granularity=granularity)
    q, s = quantize_weights(w, granularity=granularity)
    assert q.dtype == jq.dtype == numpy.int8
    assert (q == jq).all() and (s == js).all()


@pytest.mark.parametrize("mode", ["minmax", "percentile"])
@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_calibration_scales_match_jax(name, mode):
    from veles_tpu.quant import \
        calibrate_activations as jax_calibrate_activations
    from veles_tpu_torch.quant import calibrate_activations
    jplans, plans, params = build_both(name)
    stream = samples(name, 64, seed=2)
    want = jax_calibrate_activations(jplans, params, stream, mode=mode)
    got = calibrate_activations(plans, params, stream, mode=mode,
                                device=CPU)
    assert sorted(got.layers) == sorted(want.layers)
    for i in want.layers:
        assert got.layers[i]["cls"] == want.layers[i]["cls"]
        for key in ("act_scale", "amax", "observed_max"):
            numpy.testing.assert_allclose(
                got.layers[i][key], want.layers[i][key], rtol=1e-5)
    assert got.samples == want.samples == 64


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_quantized_spec_layout_matches_jax(name):
    """Same keys, dtypes and shapes per entry, so a quantized spec made
    by either package serves in both; the weights and their scales are
    bit-equal, the activation scales within rtol 1e-5."""
    from veles_tpu.quant import \
        quantize_model_spec as jax_quantize_model_spec
    from veles_tpu_torch.quant import quantize_model_spec
    jplans, plans, params = build_both(name)
    stream = samples(name, 64, seed=2)
    want, _ = jax_quantize_model_spec(jplans, params, stream)
    got, _ = quantize_model_spec(plans, params, stream, device=CPU)
    for entry, jentry in zip(got, want):
        assert sorted(entry) == sorted(jentry)
        for key, leaf in jentry.items():
            if leaf is None:
                assert entry[key] is None
                continue
            assert entry[key].dtype == leaf.dtype
            assert entry[key].shape == leaf.shape
            if key == "act_scale":
                numpy.testing.assert_allclose(entry[key], leaf,
                                              rtol=1e-5)
            else:
                assert (entry[key] == leaf).all(), key


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_quantized_forward_matches_jax(name):
    """JAX's qparams carried across by params_from_jax: the port's int8
    forward against the JAX one (its Pallas kernel in interpret mode)."""
    import jax

    from veles_tpu.quant import (
        build_quantized_forward as jax_build_quantized_forward,
        quantize_model_spec as jax_quantize_model_spec)
    from veles_tpu_torch.quant import (build_quantized_forward,
                                       is_quantized_params)
    jplans, plans, params = build_both(name)
    qparams, _ = jax_quantize_model_spec(jplans, params,
                                         samples(name, 64, seed=2))
    x = samples(name, 9, seed=3)
    want = numpy.asarray(jax.jit(jax_build_quantized_forward(jplans))(
        qparams, x))
    ported = params_from_jax(qparams, CPU)
    assert is_quantized_params(ported)
    with torch.inference_mode():
        got = build_quantized_forward(plans)(ported,
                                             torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    assert numpy.isfinite(got.numpy()).all()
    numpy.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_quantize_activation_rounds_half_to_even():
    from veles_tpu_torch.quant.forward import quantize_activation
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0])
    q = quantize_activation(x, torch.tensor(1.0))
    assert q.dtype == torch.int8
    assert q.tolist() == [0, 2, 2, 0, -2, 127, -127]


def test_calibration_sidecar_written():
    """quantize_model_spec writes its record into VELES_QUANT_CALIB
    (the test suite points it at a tmp dir)."""
    from veles_tpu_torch.quant import calibration_dir, quantize_model_spec
    _, plans, params = build_both("mlp")
    _, calibration = quantize_model_spec(plans, params,
                                         samples("mlp", 16), device=CPU)
    names = os.listdir(calibration_dir())
    assert len(names) == 1 and names[0].startswith("calib_")
    with open(os.path.join(calibration_dir(), names[0])) as fin:
        record = json.load(fin)
    assert record["samples"] == 16
    assert sorted(record["layers"]) == ["0", "1"]
    assert record == json.loads(json.dumps(calibration.to_dict()))


def test_calibration_rejects_bad_input():
    from veles_tpu_torch.quant import calibrate_activations
    _, plans, params = build_both("mlp")
    with pytest.raises(ValueError):
        calibrate_activations(plans, params, samples("mlp", 4),
                              mode="median", device=CPU)
    with pytest.raises(ValueError):
        calibrate_activations(plans, params, samples("mlp", 0),
                              device=CPU)
