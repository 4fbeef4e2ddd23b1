"""The port's conv backward (veles_tpu_torch/ops/conv_vjp.py) against
the JAX package's ``fused_conv_vjp``, whose Pallas wgrad kernel runs in
interpret mode on the CPU, at the same precision level on both sides
(the 11x11 case takes JAX's autodiff path, true f32 at every level).

On CPU tensors the port's wrapper runs its plain version, so these
tests hold the plain version to the reference.  Tolerances: at level 0
(bf16x3 products on both sides) grad_w and grad_b within max-rel 1e-6,
and the true-f32 plain version is shown to sit further (> 2e-6) from
JAX's level 0; at levels 1 and 2, and for the dgrad, max-rel 1e-5 (the
products are summed in another order); bit-exact on small-integer
operands, where every split is exact (lo = 0) and every product and sum
is exact in f32.  The CUDA kernel itself is held to the plain version on
the card by the ``cuda`` tests below and ``chip_smoke.py``."""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import conv_vjp
from veles_tpu_torch.ops.conv_vjp import (activation_grad, conv_act,
                                          conv_wgrad, conv_wgrad_reference,
                                          fused_conv_vjp, plan_wgrad)

#: tests/test_pallas_bwd.py's five cases, plus AlexNet's 11x11 / 4
CASES = [
    ((2, 9, 10, 4), 8, (3, 3), "linear", (0, 0, 0, 0), (1, 1)),
    ((2, 9, 10, 4), 8, (3, 3), "strict_relu", (1, 1, 1, 1), (2, 2)),
    ((2, 9, 10, 4), 8, (3, 3), "relu_log", (0, 0, 0, 0), (1, 1)),
    ((2, 9, 10, 4), 8, (3, 3), "tanh", (2, 1, 2, 1), (2, 3)),
    ((2, 9, 10, 4), 8, (3, 3), "sigmoid", (1, 1, 1, 1), (1, 1)),
    ((2, 27, 27, 3), 4, (11, 11), "strict_relu", (0, 0, 0, 0), (4, 4)),
]
IDS = ["linear", "strict_relu_s2", "relu_log", "tanh_asym", "sigmoid",
       "alexnet_11x11_s4"]


def _max_rel(a, b):
    a = numpy.asarray(a, numpy.float64)
    b = numpy.asarray(b, numpy.float64)
    return float(numpy.abs(a - b).max() / max(numpy.abs(b).max(), 1e-12))


def _t(array):
    return torch.from_numpy(numpy.array(array))


def _case(shape, co, ksize, activation, padding, sliding, seed=0):
    """Seeded (x, w, y, dy) as numpy, y from the port's forward (both
    packages take y as an input; their forwards agree, see
    tests/test_torch_models.py)."""
    from veles_tpu_torch.models.conv import conv2d, forward_activation
    rng = numpy.random.RandomState(seed)
    x = rng.randn(*shape).astype(numpy.float32)
    w = (rng.randn(ksize[0], ksize[1], shape[-1], co) * 0.1).astype(
        numpy.float32)
    y = forward_activation(activation)(
        conv2d(_t(x), _t(w), padding, sliding)).contiguous().numpy()
    dy = rng.randn(*y.shape).astype(numpy.float32)
    return x, w, y, dy


@pytest.mark.parametrize("shape,co,ksize,activation,padding,sliding",
                         CASES, ids=IDS)
def test_plain_vjp_matches_jax(shape, co, ksize, activation, padding,
                               sliding):
    """Level 1 on both sides: true-f32 products."""
    from veles_tpu.ops.conv_vjp import fused_conv_vjp as jax_vjp
    x, w, y, dy = _case(shape, co, ksize, activation, padding, sliding)
    rgx, rgw, rgb = (numpy.asarray(t) for t in jax_vjp(
        x, w, y, dy, activation=activation, padding=padding,
        sliding=sliding, precision_level=1))
    gx, gw, gb = fused_conv_vjp(_t(x), _t(w), _t(y), _t(dy),
                                activation=activation, padding=padding,
                                sliding=sliding, precision_level=1)
    assert gw.dtype == gb.dtype == torch.float32
    assert tuple(gw.shape) == rgw.shape and tuple(gx.shape) == x.shape
    assert _max_rel(gw.numpy(), rgw) <= 1e-5
    assert _max_rel(gb.numpy(), rgb) <= 1e-5
    assert _max_rel(gx.numpy(), rgx) <= 1e-5


@pytest.mark.parametrize("shape,co,ksize,activation,padding,sliding",
                         CASES[:5], ids=IDS[:5])
def test_level0_plain_matches_jax_bf16x3(shape, co, ksize, activation,
                                         padding, sliding):
    """Level 0 on both sides: the TPU kernel's bf16x3 products.  The
    plain version is within 1e-6 of JAX's level 0, where the true-f32
    plain version (level 1) is over 2e-6 away, so the test tells the
    two apart."""
    from veles_tpu.ops.conv_vjp import fused_conv_vjp as jax_vjp
    x, w, y, dy = _case(shape, co, ksize, activation, padding, sliding)
    rgx, rgw, rgb = (numpy.asarray(t) for t in jax_vjp(
        x, w, y, dy, activation=activation, padding=padding,
        sliding=sliding, precision_level=0))
    kw = dict(activation=activation, padding=padding, sliding=sliding)
    gx, gw, gb = fused_conv_vjp(_t(x), _t(w), _t(y), _t(dy),
                                precision_level=0, **kw)
    assert _max_rel(gw.numpy(), rgw) <= 1e-6
    assert _max_rel(gb.numpy(), rgb) <= 1e-6
    assert _max_rel(gx.numpy(), rgx) <= 1e-5
    _, f32_gw, _ = fused_conv_vjp(_t(x), _t(w), _t(y), _t(dy),
                                  precision_level=1, **kw)
    assert _max_rel(f32_gw.numpy(), rgw) > 2e-6


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("shape,co,ksize,activation,padding,sliding",
                         CASES, ids=IDS)
def test_compensated_levels_match_jax(level, shape, co, ksize, activation,
                                      padding, sliding):
    """Levels 1 and 2 (true-f32 products, Kahan / Neumaier) on both
    sides, within 1e-5."""
    from veles_tpu.ops.conv_vjp import fused_conv_vjp as jax_vjp
    x, w, y, dy = _case(shape, co, ksize, activation, padding, sliding)
    rgx, rgw, rgb = (numpy.asarray(t) for t in jax_vjp(
        x, w, y, dy, activation=activation, padding=padding,
        sliding=sliding, precision_level=level))
    gx, gw, gb = fused_conv_vjp(_t(x), _t(w), _t(y), _t(dy),
                                activation=activation, padding=padding,
                                sliding=sliding, precision_level=level)
    assert _max_rel(gw.numpy(), rgw) <= 1e-5
    assert _max_rel(gb.numpy(), rgb) <= 1e-5
    assert _max_rel(gx.numpy(), rgx) <= 1e-5


@pytest.mark.parametrize("activation", sorted(conv_vjp.ACTIVATIONS))
def test_activation_grad_matches_jax(activation):
    """The closed forms on the forward output: bit-equal where they are
    exact (linear, strict_relu), within 1 ulp-class elsewhere (XLA may
    fuse a product into an FMA)."""
    from veles_tpu.ops.conv_vjp import activation_grad as jax_grad
    rng = numpy.random.RandomState(5)
    y = rng.uniform(-1.7, 1.7, (64, 33)).astype(numpy.float32)
    if activation in ("relu_log", "sigmoid"):
        y = numpy.abs(y) * 0.5
    err = rng.randn(64, 33).astype(numpy.float32)
    want = numpy.asarray(jax_grad(activation, y, err))
    got = activation_grad(activation, _t(y), _t(err)).numpy()
    if activation in ("linear", "strict_relu"):
        assert (got == want).all()
    else:
        numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_bit_exact_on_small_integers():
    """tests/test_pallas_bwd.py:116-139: with small-integer operands
    every f32 product and sum is exact, so the order cannot matter."""
    from veles_tpu.ops.conv_vjp import fused_conv_vjp as jax_vjp
    rng = numpy.random.RandomState(3)
    x = rng.randint(-4, 5, (2, 8, 8, 3)).astype(numpy.float32)
    w = rng.randint(-3, 4, (3, 3, 3, 8)).astype(numpy.float32)
    y = numpy.zeros((2, 6, 6, 8), numpy.float32)
    dy = rng.randint(-4, 5, (2, 6, 6, 8)).astype(numpy.float32)
    want = [numpy.asarray(t) for t in jax_vjp(
        x, w, y, dy, activation="linear", padding=(0, 0, 0, 0),
        sliding=(1, 1), precision_level=1)]
    got = fused_conv_vjp(_t(x), _t(w), _t(y), _t(dy), activation="linear",
                         padding=(0, 0, 0, 0), sliding=(1, 1))
    for g, r in zip(got, want):
        assert (g.numpy() == r).all()


@pytest.mark.parametrize("level", [0, 1, 2])
def test_bit_exact_on_small_integers_at_every_level(level):
    """Small integers split exactly (hi = v, lo = 0), so level 0 gives
    the same bits as JAX's level 0, and levels 1 and 2 as theirs."""
    from veles_tpu.ops.conv_vjp import fused_conv_vjp as jax_vjp
    rng = numpy.random.RandomState(4)
    x = rng.randint(-4, 5, (2, 9, 7, 4)).astype(numpy.float32)
    w = rng.randint(-3, 4, (3, 3, 4, 8)).astype(numpy.float32)
    y = rng.randint(-2, 3, (2, 4, 3, 8)).astype(numpy.float32)
    dy = rng.randint(-4, 5, (2, 4, 3, 8)).astype(numpy.float32)
    kw = dict(activation="strict_relu", padding=(1, 0, 0, 1),
              sliding=(2, 2), precision_level=level)
    want = [numpy.asarray(t) for t in jax_vjp(x, w, y, dy, **kw)]
    got = fused_conv_vjp(_t(x), _t(w), _t(y), _t(dy), **kw)
    for g, r in zip(got, want):
        assert (g.numpy() == r).all()


def test_err_and_need_flags():
    x, w, y, dy = _case((2, 9, 10, 4), 8, (3, 3), "tanh", (2, 1, 2, 1),
                        (2, 3))
    grad_w, grad_b, err = conv_wgrad(
        _t(x), _t(y), _t(dy), activation="tanh", ksize=(3, 3),
        padding=(2, 1, 2, 1), sliding=(2, 3))
    assert torch.equal(err, activation_grad("tanh", _t(y), _t(dy)))
    gx, gw, gb = fused_conv_vjp(_t(x), _t(w), _t(y), _t(dy),
                                activation="tanh", padding=(2, 1, 2, 1),
                                sliding=(2, 3), include_bias=False,
                                need_err_input=False)
    assert gx is None and gb is None and torch.equal(gw, grad_w)


def test_float64_reference():
    """float64 operands give a float64 reference and bypass the bf16x3
    split (level 0 gives level 1's float64 bits); the f32 plain version
    is within 1e-6 of it at level 1 (true-f32 products) and within the
    bf16x3 bound, 1e-5, at level 0."""
    x, w, y, dy = _case((2, 9, 10, 4), 8, (3, 3), "strict_relu",
                        (1, 1, 1, 1), (1, 1))
    kw = dict(activation="strict_relu", ksize=(3, 3), padding=(1, 1, 1, 1),
              sliding=(1, 1))
    gw64, gb64, err64 = conv_wgrad_reference(
        _t(x).double(), _t(y).double(), _t(dy).double(), **kw)
    assert gw64.dtype == gb64.dtype == err64.dtype == torch.float64
    gw64_l1, _, _ = conv_wgrad_reference(
        _t(x).double(), _t(y).double(), _t(dy).double(),
        precision_level=1, **kw)
    assert torch.equal(gw64, gw64_l1)
    gw, gb, _ = conv_wgrad(_t(x), _t(y), _t(dy), precision_level=1, **kw)
    assert _max_rel(gw.numpy(), gw64.numpy()) <= 1e-6
    assert _max_rel(gb.numpy(), gb64.numpy()) <= 1e-6
    gw0, gb0, _ = conv_wgrad(_t(x), _t(y), _t(dy), **kw)
    assert _max_rel(gw0.numpy(), gw64.numpy()) <= 1e-5
    assert _max_rel(gb0.numpy(), gb64.numpy()) <= 1e-6


@pytest.mark.parametrize("activation,padding,sliding", [
    ("strict_relu", (1, 1, 1, 1), (1, 1)),
    ("tanh", (2, 0, 1, 1), (2, 1)),
    ("sigmoid", (0, 1, 2, 0), (1, 2)),
])
def test_autograd_function_matches_torch_autograd(activation, padding,
                                                  sliding):
    """conv_act's gradients (the fused backward) against torch autograd
    of the same forward written plainly."""
    from veles_tpu_torch.models.conv import conv2d, forward_activation
    rng = numpy.random.RandomState(9)
    x0 = _t(rng.randn(2, 9, 8, 3).astype(numpy.float32))
    w0 = _t((rng.randn(3, 2, 3, 5) * 0.2).astype(numpy.float32))
    b0 = _t((rng.randn(5) * 0.1).astype(numpy.float32))
    grads = []
    for fused in (True, False):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        if fused:
            y = conv_act(x, w, b, activation=activation, padding=padding,
                         sliding=sliding)
        else:
            y = forward_activation(activation)(
                conv2d(x, w, padding, sliding) + b)
        (y * y).sum().backward()
        grads.append((x.grad, w.grad, b.grad))
    for got, want in zip(*grads):
        assert _max_rel(got.numpy(), want.numpy()) <= 1e-5


def test_forward_identical_with_and_without_grad():
    rng = numpy.random.RandomState(6)
    x = _t(rng.randn(2, 8, 8, 3).astype(numpy.float32))
    w = _t((rng.randn(3, 3, 3, 4) * 0.1).astype(numpy.float32))
    plain = conv_act(x, w, None, activation="strict_relu",
                     padding=(1, 1, 1, 1), sliding=(1, 1))
    traced = conv_act(x, w.clone().requires_grad_(True), None,
                      activation="strict_relu", padding=(1, 1, 1, 1),
                      sliding=(1, 1))
    assert traced.grad_fn is not None and plain.grad_fn is None
    assert torch.equal(plain, traced.detach())


#: VGG16's conv layers at batch 32 as (P, taps * Ci, Co)
VGG16 = [(32 * s * s, 9 * ci, co) for s, ci, co in (
    (224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
    (56, 128, 256), (56, 256, 256), (28, 256, 512), (28, 512, 512),
    (14, 512, 512))]


def _assert_plan_covers_p_and_fills_the_card(p, r, co, level):
    """plan_wgrad at P rows (shape (1, 1, P, R) under a 1 x 1 kernel)."""
    path, tile, splits, chunk = plan_wgrad((1, 1, p, r), co, (1, 1),
                                           level, torch.float32, 132)
    assert path == ("tc_bf16x3" if level == 0 else "simt")
    if path == "simt":
        assert tile == conv_vjp.SIMT_TILE
        blocks_wanted = conv_vjp.SIMT_BLOCKS_PER_SM * 132
        min_rows = conv_vjp.SIMT_MIN_ROWS
    else:
        assert tile == ((128, 128) if co % 128 == 0 else (128, 64))
        blocks_wanted = conv_vjp.TC_WAVES * conv_vjp.TC_RESIDENT[tile] * 132
        min_rows = conv_vjp.TC_MIN_ROWS
    assert chunk % conv_vjp.STAGE == 0
    assert (splits - 1) * chunk < p <= splits * chunk
    tiles = -(-r // tile[0]) * -(-co // tile[1])
    # the grid fills the card, unless P is too short to split so far
    assert tiles * splits >= 0.9 * blocks_wanted or \
        chunk <= min_rows + conv_vjp.STAGE
    assert 1 <= splits <= 65535


@pytest.mark.parametrize("p,r,co", VGG16 + [(1, 1, 1), (33, 27, 5),
                                            (6272, 4608, 512)])
def test_split_plan_covers_p_and_fills_the_card(p, r, co):
    """The SIMT design's split (levels 1 and 2)."""
    _assert_plan_covers_p_and_fills_the_card(p, r, co, 1)


@pytest.mark.parametrize("p,r,co", VGG16 + [(1, 1, 1), (33, 27, 5),
                                            (6272, 4608, 512)])
def test_plan_wgrad_covers_p_and_fills_the_card(p, r, co):
    """The tensor-core design's split (level 0)."""
    _assert_plan_covers_p_and_fills_the_card(p, r, co, 0)


@pytest.mark.parametrize("level,dtype,path", [
    (0, torch.float32, "tc_bf16x3"), (1, torch.float32, "simt"),
    (2, torch.float32, "simt"), (0, torch.float64, "simt"),
    (0, torch.bfloat16, "simt")])
def test_plan_wgrad_picks_tc_bf16x3_only_for_f32_at_level_0(level, dtype,
                                                            path):
    assert plan_wgrad((32, 224, 224, 64), 64, (3, 3), level, dtype,
                      132)[0] == path


def test_plain_version_does_not_count_launches():
    x, w, y, dy = _case((1, 5, 5, 2), 3, (3, 3), "linear", (1, 1, 1, 1),
                        (1, 1))
    before = conv_wgrad.launches
    conv_wgrad(_t(x), _t(y), _t(dy), ksize=(3, 3), padding=(1, 1, 1, 1))
    assert conv_wgrad.launches == before


@pytest.mark.parametrize("case", ["activation", "level", "y_shape",
                                  "dy_shape"])
def test_wrapper_refuses_bad_arguments(case):
    x = torch.zeros(1, 5, 5, 2)
    y = torch.zeros(1, 3, 3, 4)
    dy = torch.zeros(1, 3, 3, 4)
    kw = dict(activation="linear", ksize=(3, 3), precision_level=0)
    if case == "activation":
        kw["activation"] = "softsign"
    elif case == "level":
        kw["precision_level"] = 3
    elif case == "y_shape":
        y = dy = torch.zeros(1, 4, 3, 4)
    else:
        dy = torch.zeros(1, 3, 3, 5)
    with pytest.raises(ValueError):
        conv_wgrad(x, y, dy, **kw)


def test_failed_build_raises(monkeypatch, tmp_path):
    from test_torch_gather import patch_failing_build
    patch_failing_build(monkeypatch, tmp_path)
    monkeypatch.setattr(conv_vjp._launch, "fn", None)
    x, y = torch.zeros(1, 5, 5, 2), torch.zeros(1, 3, 3, 4)
    before = conv_wgrad.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        conv_vjp._launch(x, y, y, "linear",
                         conv_vjp._geometry(x, y, (3, 3), (0, 0, 0, 0),
                                            (1, 1)), 0)
    assert conv_wgrad.launches == before


def test_failed_launch_raises(monkeypatch):
    from test_torch_gather import FakeLibrary, patch_failing_launch
    patch_failing_launch(monkeypatch)
    monkeypatch.setattr(conv_vjp._launch, "fn", None)
    x, y = torch.zeros(1, 5, 5, 2), torch.zeros(1, 3, 3, 4)
    before, calls = conv_wgrad.launches, FakeLibrary.calls
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        conv_vjp._launch(x, y, y, "linear",
                         conv_vjp._geometry(x, y, (3, 3), (0, 0, 0, 0),
                                            (1, 1)), 0)
    assert FakeLibrary.calls == calls + 1
    assert conv_wgrad.launches == before


@pytest.mark.parametrize("level,co", [(0, 64), (0, 128), (1, 64), (2, 128)])
def test_plan_reaches_the_kernel(monkeypatch, level, co):
    """The C entry gets the design, tile, split and chunk plan_wgrad
    picks, and conv_wgrad.paths counts the call under that design."""
    from test_torch_gather import patch_recording_launch
    from veles_tpu_torch.ops import common
    calls = patch_recording_launch(monkeypatch)
    monkeypatch.setattr(common, "sm_count", lambda device: 132)
    monkeypatch.setattr(conv_vjp._launch, "fn", None)
    x, y = torch.zeros(2, 28, 28, 64), torch.zeros(2, 28, 28, co)
    geometry = conv_vjp._geometry(x, y, (3, 3), (1, 1, 1, 1), (1, 1))
    before, paths = conv_wgrad.launches, dict(conv_wgrad.paths)
    grad_w, grad_b, err = conv_vjp._launch(x, y, y, "tanh", geometry, level)
    path, tile, splits, chunk = plan_wgrad((2, 28, 28, 64), co, (3, 3),
                                           level, torch.float32, 132)
    assert len(calls) == 1
    args = calls[0]
    assert args[8:15] == (2, 28, 28, 64, 28, 28, co)
    assert args[21:27] == (chunk, splits, conv_vjp._ACT_CODES["tanh"],
                           level, conv_vjp.PATHS.index(path), tile[1])
    assert conv_wgrad.launches == before + 1
    assert conv_wgrad.paths == dict(paths, **{path: paths[path] + 1})
    assert grad_w.shape == (3, 3, 64, co) and err.shape == y.shape


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("shape,co,ksize,activation,padding,sliding",
                         CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version(cuda_card, level, shape, co,
                                           ksize, activation, padding,
                                           sliding):
    x, w, y, dy = (_t(t).to(cuda_card) for t in _case(
        shape, co, ksize, activation, padding, sliding))
    kw = dict(activation=activation, ksize=ksize, padding=padding,
              sliding=sliding)
    before = conv_wgrad.launches
    gw, gb, err = conv_wgrad(x, y, dy, precision_level=level, **kw)
    gw2, gb2, err2 = conv_wgrad(x, y, dy, precision_level=level, **kw)
    assert conv_wgrad.launches == before + 2
    assert torch.equal(gw, gw2) and torch.equal(gb, gb2)
    assert torch.equal(err, err2)
    rgw, rgb, rerr = conv_wgrad_reference(x.double(), y.double(),
                                          dy.double(), **kw)
    assert _max_rel(gw.cpu(), rgw.cpu()) <= 1e-5
    assert _max_rel(gb.cpu(), rgb.cpu()) <= 1e-5
    _, _, ferr = conv_wgrad_reference(x, y, dy, **kw)
    ulp = (err.view(torch.int32).long() -
           ferr.view(torch.int32).long()).abs().max().item()
    assert ulp <= 1


#: the tensor-core design's cases on the card: VGG16's conv1_1 (Ci = 3,
#: scalar x lanes), conv1_2 and conv5_1 at small batch, ragged shapes
#: (Co and Ci not multiples of 4, strides, asymmetric padding) and
#: operands that start off a 16-byte boundary (scalar lanes throughout)
TC_CASES = [
    ((2, 224, 224, 3), 64, (3, 3), "strict_relu", (1, 1, 1, 1), (1, 1), 0),
    ((1, 224, 224, 64), 64, (3, 3), "strict_relu", (1, 1, 1, 1), (1, 1),
     0),
    ((2, 14, 14, 512), 512, (3, 3), "strict_relu", (1, 1, 1, 1), (1, 1),
     0),
    ((3, 37, 29, 5), 7, (3, 2), "tanh", (2, 1, 0, 1), (2, 3), 0),
    ((2, 19, 23, 12), 130, (5, 3), "sigmoid", (0, 2, 1, 0), (1, 2), 0),
    ((2, 31, 17, 8), 36, (3, 3), "relu_log", (1, 1, 1, 1), (2, 1), 1),
    ((2, 28, 28, 64), 128, (3, 3), "linear", (1, 1, 1, 1), (1, 1), 2),
]
TC_IDS = ["conv1_1", "conv1_2", "conv5_1", "ragged", "co130_5x3",
          "unaligned_by_4_bytes", "unaligned_by_8_bytes"]


def _at_offset(t, offset):
    """t copied into a buffer ``offset`` elements past its start."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,co,ksize,activation,padding,sliding,offset", TC_CASES,
    ids=TC_IDS)
def test_cuda_tc_bf16x3_matches_level0_plain(cuda_card, shape, co, ksize,
                                             activation, padding, sliding,
                                             offset):
    """Level 0 on the card takes the tensor-core design: grad_w and
    grad_b within max-rel 2e-6 of the level-0 plain version on the same
    inputs and 1e-5 of float64, err within 1 ulp, the same bits twice."""
    from veles_tpu_torch.models.all2all import All2AllTanh
    rng = numpy.random.RandomState(11)
    n, h, w_sp, _ = shape
    left, top, right, bottom = padding
    oh = (h + top + bottom - ksize[0]) // sliding[1] + 1
    ow = (w_sp + left + right - ksize[1]) // sliding[0] + 1
    z = rng.randn(n, oh, ow, co).astype(numpy.float32)
    y = numpy.maximum(z, 0) if activation == "strict_relu" else (
        All2AllTanh.A * numpy.tanh(All2AllTanh.B * z)).astype(numpy.float32)
    if activation in ("relu_log", "sigmoid"):
        y = numpy.abs(y) * 0.5
    x, y, dy = (_at_offset(_t(a).to(cuda_card), offset) for a in (
        rng.randn(*shape).astype(numpy.float32), y,
        rng.randn(n, oh, ow, co).astype(numpy.float32)))
    kw = dict(activation=activation, ksize=ksize, padding=padding,
              sliding=sliding)
    before = dict(conv_wgrad.paths)
    gw, gb, err = conv_wgrad(x, y, dy, **kw)
    gw2, gb2, err2 = conv_wgrad(x, y, dy, **kw)
    torch.cuda.synchronize()
    assert conv_wgrad.paths["tc_bf16x3"] == before["tc_bf16x3"] + 2
    assert conv_wgrad.paths["simt"] == before["simt"]
    assert torch.equal(gw, gw2) and torch.equal(gb, gb2)
    assert torch.equal(err, err2)
    pgw, pgb, perr = conv_wgrad_reference(x, y, dy, precision_level=0, **kw)
    assert _max_rel(gw.cpu(), pgw.cpu()) <= 2e-6
    assert _max_rel(gb.cpu(), pgb.cpu()) <= 2e-6
    rgw, rgb, _ = conv_wgrad_reference(x.double(), y.double(), dy.double(),
                                       **kw)
    assert _max_rel(gw.cpu(), rgw.cpu()) <= 1e-5
    assert _max_rel(gb.cpu(), rgb.cpu()) <= 1e-5
    ulp = (err.view(torch.int32).long() -
           perr.view(torch.int32).long()).abs().max().item()
    assert ulp <= 1
