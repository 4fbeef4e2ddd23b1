"""The port's int8 matmul and conv (veles_tpu_torch/ops/matmul_int8.py)
against the JAX package's Pallas kernel, run in interpret mode on the
CPU as tests/test_quant.py runs it.

On CPU tensors the port's wrapper runs its plain version, so these
tests hold the plain version to the reference.  Contract: with scale 1
and bias 0 the f32 output is the exact int32 sum (|acc| < 2**24 at
these shapes), so the two agree bit for bit; with random per-column
scale and bias they agree to 1 ulp (the JAX epilogue is one FMA, the
port's plain version rounds a float64 epilogue once).  The CUDA kernel
itself is held to the plain version on the card (the ``cuda`` tests
below and ``chip_smoke.py``).  The kernel's planner (``plan_int8``: its
tile and K split) and its K-major, K-padded weight layout are pure
Python and are held here."""

import numpy
import pytest
import torch

from veles_tpu_torch.ops.common import split_ranges
from veles_tpu_torch.ops.matmul_int8 import (INT8_STEP, conv2d_int8,
                                             kmajor_weight, matmul_int8,
                                             matmul_int8_kmajor,
                                             matmul_int8_reference,
                                             plan_int8)

pytestmark = pytest.mark.quant

#: the shapes and tiles of tests/test_quant.py's bit-exactness test
SHAPES = [(37, 91, 53, (64, 128, 128)),
          (300, 500, 260, (64, 128, 128)),
          (8, 1024, 128, (32, 128, 128)),
          (129, 257, 385, None)]


def _ulp(got, want):
    got = numpy.ascontiguousarray(got, numpy.float32).view(numpy.int32)
    want = numpy.ascontiguousarray(want, numpy.float32).view(numpy.int32)
    return int(numpy.abs(got.astype(numpy.int64) - want).max())


def _operands(rng, m, k, n):
    a = rng.randint(-127, 128, (m, k)).astype(numpy.int8)
    b = rng.randint(-127, 128, (k, n)).astype(numpy.int8)
    scale = (rng.rand(n) * 0.01).astype(numpy.float32)
    bias = rng.randn(n).astype(numpy.float32)
    return a, b, scale, bias


@pytest.mark.parametrize("m,k,n,blocks", SHAPES)
def test_int32_sum_bit_exact_vs_jax_kernel(m, k, n, blocks):
    from veles_tpu.ops.matmul_int8 import matmul_int8 as jax_matmul_int8
    a, b, _, _ = _operands(numpy.random.RandomState(3), m, k, n)
    assert k * 127 * 127 < 2 ** 24
    want = numpy.asarray(jax_matmul_int8(a, b, numpy.float32(1.0),
                                         blocks=blocks))
    got = matmul_int8(torch.from_numpy(a), torch.from_numpy(b), 1.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert (got.numpy() == want).all()
    exact = a.astype(numpy.int64) @ b.astype(numpy.int64)
    assert (got.numpy() == exact).all()


@pytest.mark.parametrize("m,k,n,blocks", SHAPES)
def test_epilogue_within_one_ulp_of_jax_kernel(m, k, n, blocks):
    from veles_tpu.ops.matmul_int8 import matmul_int8 as jax_matmul_int8
    a, b, scale, bias = _operands(numpy.random.RandomState(4), m, k, n)
    want = numpy.asarray(jax_matmul_int8(a, b, scale, bias,
                                         blocks=blocks))
    got = matmul_int8(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(scale), torch.from_numpy(bias))
    assert _ulp(got.numpy(), want) <= 1


def test_scalar_scale_no_bias_within_one_ulp():
    """The other epilogue arity: a scalar scale and no bias."""
    from veles_tpu.ops.matmul_int8 import matmul_int8 as jax_matmul_int8
    a, b, _, _ = _operands(numpy.random.RandomState(5), 40, 200, 70)
    want = numpy.asarray(jax_matmul_int8(a, b, numpy.float32(0.005),
                                         blocks=(32, 128, 128)))
    got = matmul_int8(torch.from_numpy(a), torch.from_numpy(b), 0.005)
    assert _ulp(got.numpy(), want) <= 1


@pytest.mark.parametrize("padding,sliding", [
    ((0, 0, 0, 0), (1, 1)),
    ((1, 1, 1, 1), (2, 2)),
    ((2, 1, 0, 1), (1, 2)),
    ((0, 2, 1, 0), (2, 1)),
])
def test_conv2d_int8_within_one_ulp_of_jax(padding, sliding):
    """Asymmetric padding, strides (sx, sy) of both orders: the im2col
    order (tap-major, then Cin) must match the HWIO weight reshape."""
    from veles_tpu.ops.matmul_int8 import conv2d_int8 as jax_conv2d_int8
    rng = numpy.random.RandomState(7)
    x = rng.randint(-127, 128, (2, 9, 11, 3)).astype(numpy.int8)
    w = rng.randint(-127, 128, (3, 3, 3, 5)).astype(numpy.int8)
    scale = (rng.rand(5) * 0.01).astype(numpy.float32)
    bias = rng.randn(5).astype(numpy.float32)
    want = numpy.asarray(jax_conv2d_int8(x, w, scale, bias,
                                         padding=padding,
                                         sliding=sliding))
    got = conv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(scale), torch.from_numpy(bias),
                      padding=padding, sliding=sliding)
    assert tuple(got.shape) == want.shape
    assert _ulp(got.numpy(), want) <= 1


def test_plain_version_does_not_count_launches():
    before = matmul_int8.launches
    a = torch.ones((4, 8), dtype=torch.int8)
    matmul_int8(a, a.t().contiguous(), 1.0)
    assert matmul_int8.launches == before


def test_plain_version_casts_before_the_product():
    """torch.matmul on int8 would wrap: 127 * 127 * 64 overflows int8
    and int16 alike."""
    a = torch.full((2, 64), 127, dtype=torch.int8)
    b = torch.full((64, 3), 127, dtype=torch.int8)
    out = matmul_int8_reference(a, b, 1.0)
    assert (out == 127 * 127 * 64).all()


@pytest.mark.parametrize("case", ["float_a", "float_b", "int16_b"])
def test_wrapper_refuses_non_int8(case):
    a = torch.zeros((4, 4), dtype=torch.int8)
    b = torch.zeros((4, 4), dtype=torch.int8)
    if case == "float_a":
        a = a.float()
    elif case == "float_b":
        b = b.float()
    else:
        b = b.to(torch.int16)
    with pytest.raises(TypeError):
        matmul_int8(a, b, 1.0)


@pytest.mark.parametrize("case", ["scale_shape", "bias_shape", "one_d",
                                  "k_mismatch", "non_contiguous"])
def test_wrapper_refuses_bad_shapes(case):
    a = torch.zeros((4, 6), dtype=torch.int8)
    b = torch.zeros((6, 5), dtype=torch.int8)
    scale, bias = torch.ones(5), None
    if case == "scale_shape":
        scale = torch.ones(4)
    elif case == "bias_shape":
        bias = torch.zeros(3)
    elif case == "one_d":
        a = torch.zeros(6, dtype=torch.int8)
    elif case == "k_mismatch":
        b = torch.zeros((5, 5), dtype=torch.int8)
    else:
        b = torch.zeros((5, 6), dtype=torch.int8).t()
    with pytest.raises(ValueError):
        matmul_int8(a, b, scale, bias)


#: every distinct (M, K, N) that VGG16's int8 dispatch at rung 32 runs:
#: conv1_1 .. conv5_x as im2col products (M = 32 * H * W, K = 9 * Cin),
#: then fc1, fc2, fc3
VGG16_RUNG32 = {
    "conv1_1": (32 * 224 * 224, 27, 64),
    "conv1_2": (32 * 224 * 224, 576, 64),
    "conv2_1": (32 * 112 * 112, 576, 128),
    "conv2_2": (32 * 112 * 112, 1152, 128),
    "conv3_1": (32 * 56 * 56, 1152, 256),
    "conv3_x": (32 * 56 * 56, 2304, 256),
    "conv4_1": (32 * 28 * 28, 2304, 512),
    "conv4_x": (32 * 28 * 28, 4608, 512),
    "conv5_x": (32 * 14 * 14, 4608, 512),
    "fc1": (32, 25088, 4096),
    "fc2": (32, 4096, 4096),
    "fc3": (32, 4096, 1000),
    "ragged": (37, 91, 53),
}


def test_plan_conv1_1_pads_k_to_32():
    """conv1_1's 27-byte patch rows are padded with zeros to 32 (exact in
    int32) so that the kernel loads whole 16-byte chunks; its N = 64
    takes the 128 x 64 tile."""
    plan = plan_int8(*VGG16_RUNG32["conv1_1"], sm_count=132)
    assert plan["k_padded"] == 32 and plan["tile"] == (128, 64)
    assert plan["splits"] == 1
    w = torch.arange(3 * 3 * 3 * 64).reshape(3, 3, 3, 64).to(torch.int8)
    wt = kmajor_weight(w)
    assert tuple(wt.shape) == (64, 32) and wt.is_contiguous()
    assert torch.equal(wt[:, :27], w.reshape(27, 64).t())
    assert not wt[:, 27:].any()


@pytest.mark.parametrize("name", list(VGG16_RUNG32))
def test_plan_split_sums_stay_below_2_31(name):
    m, k, n = VGG16_RUNG32[name]
    plan = plan_int8(m, k, n, sm_count=132)
    assert plan["k_padded"] % 16 == 0 and plan["k_padded"] - k < 16
    ranges = split_ranges(plan["steps"], plan["splits"])
    assert ranges[0][0] == 0 and ranges[-1][1] == plan["steps"]
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    assert all(stop > start for start, stop in ranges)
    for start, stop in ranges:
        assert (stop - start) * INT8_STEP * 127 * 127 < 2 ** 31
    assert plan["k_padded"] * 127 * 127 < 2 ** 31


def test_plan_fc_layers_split_k():
    for name in ("fc1", "fc2", "fc3"):
        plan = plan_int8(*VGG16_RUNG32[name], sm_count=132)
        assert plan["tile"] == (32, 128) and plan["splits"] > 1
        assert plan["blocks"] >= 132
    plan = plan_int8(*VGG16_RUNG32["fc1"], sm_count=132)
    assert plan["workspace_ints"] == plan["splits"] * 32 * 4096
    for name in ("conv1_2", "conv3_x", "conv5_x"):
        assert plan_int8(*VGG16_RUNG32[name], sm_count=132)["splits"] == 1


def test_plan_refuses_a_k_that_may_overflow():
    with pytest.raises(ValueError, match="overflow"):
        plan_int8(8, 2 ** 17 + 16, 8, sm_count=132)


@pytest.mark.parametrize("m,k,n", [(37, 91, 53), (8, 1024, 128),
                                   (5, 27, 64)])
def test_kmajor_entry_equals_matmul_int8(m, k, n):
    a, b, scale, bias = _operands(numpy.random.RandomState(6), m, k, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = matmul_int8_kmajor(ta, kmajor_weight(tb), torch.from_numpy(scale),
                             torch.from_numpy(bias))
    want = matmul_int8(ta, tb, torch.from_numpy(scale),
                       torch.from_numpy(bias))
    assert torch.equal(got, want)


def test_kmajor_entry_refuses_a_misfit_weight():
    a = torch.zeros((4, 20), dtype=torch.int8)
    with pytest.raises(ValueError, match="K-major"):
        matmul_int8_kmajor(a, torch.zeros((5, 20), dtype=torch.int8), 1.0)


def test_engine_params_carry_kmajor_weights():
    from veles_tpu_torch.quant.forward import with_kmajor_weights
    w = torch.ones((3, 3, 3, 8), dtype=torch.int8)
    params = [{"weights": w, "weights_scale": torch.ones(8)},
              {"weights": torch.ones(4, 4)}]
    out = with_kmajor_weights(params)
    assert tuple(out[0]["weights_kmajor"].shape) == (8, 32)
    assert "weights_kmajor" not in out[1]
    assert "weights_kmajor" not in params[0]   # the spec is untouched


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,blocks", SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_card, m, k, n, blocks):
    a, b, scale, bias = _operands(numpy.random.RandomState(8), m, k, n)
    a, b, scale, bias = (torch.from_numpy(t).to(cuda_card)
                         for t in (a, b, scale, bias))
    before = matmul_int8.launches
    exact = matmul_int8(a, b, 1.0)
    assert torch.equal(exact, matmul_int8_reference(a, b, 1.0))
    got = matmul_int8(a, b, scale, bias)
    want = matmul_int8_reference(a, b, scale, bias)
    assert matmul_int8.launches == before + 2
    assert _ulp(got.cpu().numpy(), want.cpu().numpy()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VGG16_RUNG32))
def test_cuda_bit_exact_at_every_vgg16_rung32_shape(cuda_card, name):
    """Full int8 range: the int32 sums, converted once to f32, equal the
    plain version's bit for bit (both round the exact sum to nearest),
    with scale 1 and bias 0; 1 ulp with random scale and bias."""
    m, k, n = VGG16_RUNG32[name]
    gen = torch.Generator(device="cuda").manual_seed(k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    wt = kmajor_weight(b)
    before = matmul_int8.launches
    exact = matmul_int8_kmajor(a, wt, 1.0)
    assert torch.equal(exact, matmul_int8_reference(a, b, 1.0))
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01
    bias = torch.randn(n, generator=gen, device="cuda")
    got = matmul_int8_kmajor(a, wt, scale, bias)
    want = matmul_int8_reference(a, b, scale, bias)
    assert matmul_int8.launches == before + 2
    assert (got.view(torch.int32).long() -
            want.view(torch.int32).long()).abs().max().item() <= 1
