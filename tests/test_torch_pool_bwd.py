"""The port's max-pool backward (veles_tpu_torch/ops/pool_bwd.py)
against the JAX package's ``max_pool_bwd``, whose Pallas kernel runs in
interpret mode on the CPU.

On CPU tensors the port's wrapper runs its plain version, so these
tests hold the plain version to the reference.  Routing compares values
exactly, so it is bit-exact: with representable cotangents (small
integers, whose sums are exact) the outputs are bit-equal for every
case, overlapping windows, ties and ceil-mode tails included; with
random cotangents they are bit-equal where windows do not overlap and
within 1e-6 elsewhere.  The CUDA kernel itself is held to the plain
version on the card by the ``cuda`` tests below and ``chip_smoke.py``."""

import numpy
import pytest
import torch
import torch.nn.functional as F

from veles_tpu_torch.ops import pool_bwd
from veles_tpu_torch.ops.pool_bwd import (max_pool, max_pool_bwd,
                                          max_pool_bwd_reference)

#: tests/test_pallas_bwd.py:224-231, AlexNet's 3x3/2 at 13x13, VGG16's
#: five pool shapes at batch 2, and windows narrower than their stride
#: (gaps no window covers; at 1x1/3 on 5 the last window lies wholly in
#: the ceil-mode padding)
CASES = [
    ((2, 8, 8, 3), (2, 2), (2, 2), False),     # VGG-style non-overlap
    ((2, 9, 9, 3), (3, 3), (2, 2), True),      # AlexNet overlap + ceil
    ((1, 5, 5, 2), (2, 2), (2, 2), False),     # odd input, ceil tail
    ((2, 6, 6, 130), (2, 2), (2, 2), False),   # channels past one lane
    ((1, 4, 4, 1), (4, 4), (4, 4), False),     # window == input
    ((2, 7, 7, 5), (3, 3), (1, 1), True),      # dense overlap
    ((1, 13, 13, 6), (3, 3), (2, 2), True),    # AlexNet pool geometry
    ((1, 7, 4, 2), (3, 2), (3, 1), True),      # (kx, ky) != (sx, sy)
    ((2, 224, 224, 64), (2, 2), (2, 2), False),    # VGG16 pool1
    ((2, 112, 112, 128), (2, 2), (2, 2), False),   # pool2
    ((2, 56, 56, 256), (2, 2), (2, 2), False),     # pool3
    ((2, 28, 28, 512), (2, 2), (2, 2), False),     # pool4
    ((2, 14, 14, 512), (2, 2), (2, 2), False),     # pool5
    ((2, 7, 9, 8), (2, 2), (2, 2), False),     # odd ceil tail, C % 4 == 0
    ((1, 9, 10, 4), (2, 2), (3, 3), False),    # gaps between windows
    ((2, 5, 5, 3), (1, 1), (3, 3), False),     # a window in the padding
    ((1, 6, 8, 5), (2, 1), (3, 2), False),     # gaps along w only
]
IDS = ["vgg", "alexnet_ceil", "odd_ceil", "130_channels", "whole",
       "dense", "alexnet_13", "rect", "vgg16_pool1", "vgg16_pool2",
       "vgg16_pool3", "vgg16_pool4", "vgg16_pool5", "odd_ceil_c8", "gap",
       "gap_past_edge", "gap_w"]
#: the design plan_pool_bwd gives each case: "cells" where no input lies
#: in two windows
DESIGNS = {i: "overlap" if overlap else "cells"
           for i, (_, _, _, overlap) in zip(IDS, CASES)}
#: inputs that hold -inf (whole rows and columns at the ceil-mode edge,
#: so some windows have only -inf real taps) or NaN, in these geometries
SPECIAL_GEOMETRIES = [((1, 5, 7, 4), (2, 2), (2, 2)),
                      ((1, 5, 7, 4), (3, 3), (2, 2)),
                      ((2, 5, 5, 3), (1, 1), (3, 3)),
                      ((1, 7, 9, 130), (2, 2), (2, 2))]
SPECIAL_IDS = ["2x2", "3x3", "gap_past_edge", "130_channels"]


def _forward(x, window, sliding):
    """y from the port's forward (bit-equal to the JAX one, see
    tests/test_torch_models.py)."""
    from veles_tpu_torch.models.pooling import _pool
    return _pool(torch.from_numpy(x), window, sliding, float("-inf"),
                 F.max_pool2d).contiguous().numpy()


def _jax(x, y, dy, window, sliding):
    """The JAX package's backward: its Pallas kernel, or, where a window
    lies wholly in the ceil-mode padding (the kernel refuses its
    zero-size slice), the autodiff routing the kernel replaces."""
    from veles_tpu.ops.pool_bwd import max_pool_bwd as jax_pool_bwd
    (ky, kx), (sx, sy) = window, sliding
    if (y.shape[1] - 1) * sy < x.shape[1] and \
            (y.shape[2] - 1) * sx < x.shape[2]:
        return numpy.asarray(jax_pool_bwd(x, y, dy, window=window,
                                          sliding=sliding))
    import jax
    from veles_tpu.models.pooling import MaxPooling
    _, vjp = jax.vjp(lambda t: MaxPooling.apply(
        {}, t, window=window, sliding=sliding, pallas_bwd=False), x)
    return numpy.asarray(vjp(dy)[0])


def _port(x, y, dy, window, sliding):
    return max_pool_bwd(*(torch.from_numpy(numpy.array(t))
                          for t in (x, y, dy)),
                        window=window, sliding=sliding).numpy()


@pytest.mark.parametrize("shape,window,sliding,overlap", CASES, ids=IDS)
def test_bit_exact_on_representable_cotangents(shape, window, sliding,
                                               overlap):
    rng = numpy.random.RandomState(11)
    x = rng.randn(*shape).astype(numpy.float32)
    y = _forward(x, window, sliding)
    dy = rng.randint(-8, 9, y.shape).astype(numpy.float32) / 4
    want = _jax(x, y, dy, window, sliding)
    got = _port(x, y, dy, window, sliding)
    assert got.shape == x.shape and got.dtype == numpy.float32
    assert (got == want).all()


@pytest.mark.parametrize("shape,window,sliding,overlap", CASES, ids=IDS)
def test_random_cotangents(shape, window, sliding, overlap):
    rng = numpy.random.RandomState(12)
    x = rng.randn(*shape).astype(numpy.float32)
    y = _forward(x, window, sliding)
    dy = rng.randn(*y.shape).astype(numpy.float32)
    want = _jax(x, y, dy, window, sliding)
    got = _port(x, y, dy, window, sliding)
    if overlap:
        numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert (got == want).all()


@pytest.mark.parametrize("window,sliding", [((3, 3), (2, 2)),
                                            ((2, 2), (2, 2))])
def test_ties_route_to_the_first_match(window, sliding):
    """All-equal and all-zero (ReLU) windows: first-match routing in
    row-major window order, as XLA's select-and-scatter."""
    rng = numpy.random.RandomState(2)
    x = numpy.ones((1, 6, 6, 2), numpy.float32)
    x[0, :, :3] = 0.0
    y = _forward(x, window, sliding)
    dy = rng.randint(-8, 9, y.shape).astype(numpy.float32) / 4
    want = _jax(x, y, dy, window, sliding)
    got = _port(x, y, dy, window, sliding)
    assert (got == want).all()


def _special(kind, shape, window, sliding, seed):
    """x with -inf edges or scattered NaN, its y, and representable
    cotangents."""
    rng = numpy.random.RandomState(seed)
    x = rng.randn(*shape).astype(numpy.float32)
    if kind == "neg_inf":
        x[:, -1] = -numpy.inf
        x[:, :, -1] = -numpy.inf
        x[:, :2, :2, :1] = -numpy.inf
    else:
        x[rng.rand(*shape) < 0.2] = numpy.nan
    y = _forward(x, window, sliding)
    dy = rng.randint(-8, 9, y.shape).astype(numpy.float32) / 4
    return x, y, dy


#: (kind, geometry) pairs held to the JAX package.  NaN at
#: gap_past_edge is left out: there the JAX side is autodiff (see
#: _jax), whose select-and-scatter routes a NaN window's cotangent to
#: a tap, where the Pallas kernel, and the port, route nothing
SPECIAL_VS_JAX = [(kind, geometry, "%s-%s" % (name, kind))
                  for kind in ("neg_inf", "nan")
                  for geometry, name in zip(SPECIAL_GEOMETRIES, SPECIAL_IDS)
                  if (kind, name) != ("nan", "gap_past_edge")]


@pytest.mark.parametrize("kind,geometry",
                         [case[:2] for case in SPECIAL_VS_JAX],
                         ids=[case[2] for case in SPECIAL_VS_JAX])
def test_neg_inf_and_nan_inputs_route_as_jax(kind, geometry):
    """A window whose real taps are all -inf routes to its first tap
    (padded or not); a NaN max routes nothing."""
    shape, window, sliding = geometry
    x, y, dy = _special(kind, shape, window, sliding, 14)
    want = _jax(x, y, dy, window, sliding)
    got = _port(x, y, dy, window, sliding)
    assert got.shape == x.shape
    assert (got.view(numpy.int32) == want.view(numpy.int32)).all()


@pytest.mark.parametrize("shape,window,sliding,overlap", CASES, ids=IDS)
def test_planner_picks_the_design_by_geometry(shape, window, sliding,
                                              overlap):
    plan = pool_bwd.plan_pool_bwd(window, sliding, shape[3])
    assert plan["design"] == ("overlap" if overlap else "cells")
    assert plan["vec"] == (4 if shape[3] % 4 == 0 else 1)
    lanes = plan["lanes_x"]
    assert 256 % lanes == 0 and lanes >= min(32, shape[3] // plan["vec"])


@pytest.mark.parametrize("c,pointers,vec,lanes_x", [
    (64, (0, 16, 32, 256), 4, 16),      # VGG16 pool1: 16 float4 lanes
    (512, (0, 0, 0, 0), 4, 32),         # 128 lanes, 4 chunks of 32
    (64, (0, 16, 36, 256), 1, 32),      # one pointer off 16 bytes
    (3, (0, 0, 0, 0), 1, 4),
    (130, (0, 0, 0, 0), 1, 32),
])
def test_planner_vector_width_and_block(c, pointers, vec, lanes_x):
    plan = pool_bwd.plan_pool_bwd((2, 2), (2, 2), c, pointers)
    assert (plan["vec"], plan["lanes_x"]) == (vec, lanes_x)


def test_autograd_function_matches_torch_autograd():
    """max_pool's gradient (the select-and-scatter backward) against
    torch autograd of the plain forward, on inputs without ties."""
    from veles_tpu_torch.models.pooling import _pool
    rng = numpy.random.RandomState(3)
    x0 = torch.from_numpy(rng.randn(2, 9, 8, 3).astype(numpy.float32))
    grads = []
    for fused in (True, False):
        x = x0.clone().requires_grad_(True)
        if fused:
            y = max_pool(x, window=(2, 2), sliding=(2, 2))
        else:
            y = _pool(x, (2, 2), (2, 2), float("-inf"), F.max_pool2d)
        (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
         ).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


def test_plain_version_does_not_count_launches():
    x = torch.zeros(1, 4, 4, 2)
    y = torch.zeros(1, 2, 2, 2)
    before = max_pool_bwd.launches
    max_pool_bwd(x, y, y, window=(2, 2), sliding=(2, 2))
    assert max_pool_bwd.launches == before


@pytest.mark.parametrize("case", ["y_shape", "dy_shape", "rank"])
def test_wrapper_refuses_bad_shapes(case):
    x = torch.zeros(1, 4, 4, 2)
    y = dy = torch.zeros(1, 2, 2, 2)
    if case == "y_shape":
        y = torch.zeros(1, 3, 2, 2)
    elif case == "dy_shape":
        dy = torch.zeros(1, 2, 2, 3)
    else:
        x = torch.zeros(4, 4, 2)
    with pytest.raises(ValueError):
        max_pool_bwd(x, y, dy, window=(2, 2), sliding=(2, 2))


def test_failed_build_raises(monkeypatch, tmp_path):
    from test_torch_gather import patch_failing_build
    patch_failing_build(monkeypatch, tmp_path)
    monkeypatch.setattr(pool_bwd._launch, "fn", None)
    x, y = torch.zeros(1, 4, 4, 2), torch.zeros(1, 2, 2, 2)
    before = max_pool_bwd.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        pool_bwd._launch(x, y, y, 2, 2, 2, 2)
    assert max_pool_bwd.launches == before


def test_launch_passes_the_plan(monkeypatch):
    """The wrapper hands the kernel the planner's design, vector width
    and block, and counts the call under its design."""
    from test_torch_gather import patch_recording_launch
    calls = patch_recording_launch(monkeypatch)
    monkeypatch.setattr(pool_bwd._launch, "fn", None)
    monkeypatch.setattr(max_pool_bwd, "paths",
                        dict.fromkeys(pool_bwd.PATHS, 0))
    for window, sliding, design, out in (((2, 2), (2, 2), 0, 5),
                                         ((3, 3), (2, 2), 1, 4)):
        x = torch.zeros(1, 9, 9, 8)
        y = torch.zeros(1, out, out, 8)
        pool_bwd._launch(x, y, y, window[0], window[1], sliding[1],
                         sliding[0])
        assert calls[-1][14:17] == (design, 4, 2)
    assert max_pool_bwd.paths == {"cells": 1, "overlap": 1}


def test_failed_launch_raises(monkeypatch):
    from test_torch_gather import FakeLibrary, patch_failing_launch
    patch_failing_launch(monkeypatch)
    monkeypatch.setattr(pool_bwd._launch, "fn", None)
    x, y = torch.zeros(1, 4, 4, 2), torch.zeros(1, 2, 2, 2)
    before, calls = max_pool_bwd.launches, FakeLibrary.calls
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pool_bwd._launch(x, y, y, 2, 2, 2, 2)
    assert FakeLibrary.calls == calls + 1
    assert max_pool_bwd.launches == before


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window,sliding,overlap", CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version(cuda_card, shape, window,
                                           sliding, overlap):
    rng = numpy.random.RandomState(13)
    x = rng.randn(*shape).astype(numpy.float32)
    x[..., :1] = numpy.maximum(x[..., :1], 0.0)   # ReLU ties
    y = _forward(x, window, sliding)
    dy = rng.randn(*y.shape).astype(numpy.float32)
    x, y, dy = (torch.from_numpy(t).to(cuda_card) for t in (x, y, dy))
    before = max_pool_bwd.launches
    got = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    again = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    assert max_pool_bwd.launches == before + 2
    want = max_pool_bwd_reference(x, y, dy, window=window,
                                  sliding=sliding)
    assert torch.equal(got, again) and torch.equal(got, want)
    bits = got.view(torch.int32)
    assert torch.equal(bits, want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window,sliding,overlap", CASES, ids=IDS)
def test_cuda_design_served_each_case(cuda_card, shape, window, sliding,
                                      overlap):
    x = torch.zeros(shape, device=cuda_card)
    from veles_tpu_torch.models.pooling import _pool
    y = _pool(x, window, sliding, float("-inf"), F.max_pool2d).contiguous()
    before = dict(max_pool_bwd.paths)
    max_pool_bwd(x, y, y, window=window, sliding=sliding)
    design = "overlap" if overlap else "cells"
    assert max_pool_bwd.paths[design] == before[design] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["neg_inf", "nan"])
@pytest.mark.parametrize("shape,window,sliding", SPECIAL_GEOMETRIES,
                         ids=SPECIAL_IDS)
def test_cuda_neg_inf_and_nan_inputs(cuda_card, kind, shape, window,
                                     sliding):
    x, y, dy = (torch.from_numpy(t).to(cuda_card)
                for t in _special(kind, shape, window, sliding, 15))
    got = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    again = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    want = max_pool_bwd_reference(x, y, dy, window=window,
                                  sliding=sliding)
    for t in (again, want):
        assert torch.equal(got.view(torch.int32), t.view(torch.int32))


@pytest.mark.cuda
def test_cuda_unaligned_channels_take_scalar_lanes(cuda_card):
    """A view whose base is 4 bytes past a 16-byte boundary takes the
    same kernel with one channel a lane."""
    rng = numpy.random.RandomState(16)
    flat = torch.from_numpy(rng.randn(1 + 2 * 8 * 8 * 4).astype(
        numpy.float32)).to(cuda_card)
    x = flat[1:].view(2, 8, 8, 4)
    from veles_tpu_torch.models.pooling import _pool
    y = _pool(x, (2, 2), (2, 2), float("-inf"), F.max_pool2d).contiguous()
    dy = torch.from_numpy(rng.randn(*y.shape).astype(numpy.float32)).to(
        cuda_card)
    assert pool_bwd.plan_pool_bwd((2, 2), (2, 2), 4, [x.data_ptr()])[
        "vec"] == 1
    got = max_pool_bwd(x, y, dy, window=(2, 2), sliding=(2, 2))
    want = max_pool_bwd_reference(x, y, dy, window=(2, 2),
                                  sliding=(2, 2))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
