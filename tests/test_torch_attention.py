"""The port's flash attention (veles_tpu_torch/ops/attention.py) against
the JAX package's ``flash_attention``, whose Pallas kernels run in
interpret mode on the CPU.

On CPU tensors the port's wrappers run their plain versions, so these
tests hold the plain versions to the reference: the forward at level 0
(bf16x3 products on both sides) max-rel < 4e-6 against JAX's level-0
kernel, nearer it than JAX's level 1, and < 5e-6 against level 1 at
level 1 (the reference's own bound, tests/test_transformer.py); dq,
dk and dv at level 1 within 5e-6 of
``jax.grad`` through the JAX kernel at T = 37, where both its paddings
are live; the level-0 backward (bf16x3 products on both sides) within
5e-6 of JAX's level-0 Pallas backward from the same out and lse.
The CUDA kernels are held to the plain versions on the card by the
``cuda`` tests below and by ``chip_smoke.py``."""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import attention
from veles_tpu_torch.ops.matmul import _partial_dot
from veles_tpu_torch.ops.attention import (attention_dkv,
                                           attention_dkv_reference,
                                           attention_dq,
                                           attention_dq_reference,
                                           attention_fwd,
                                           attention_fwd_reference,
                                           attention_reference,
                                           flash_attention, plan_attention)


def _qkv(rng, b, t, dh, scale=1.0):
    return tuple((rng.randn(b, t, dh) * scale).astype(numpy.float32)
                 for _ in range(3))


def _max_rel(got, want):
    got = numpy.asarray(got, numpy.float64)
    want = numpy.asarray(want, numpy.float64)
    return float(numpy.abs(got - want).max() /
                 max(numpy.abs(want).max(), 1e-12))


def _tt(*arrays, grad=False):
    return tuple(torch.from_numpy(numpy.array(a)).requires_grad_(grad)
                 for a in arrays)


# -- forward against the JAX kernel ------------------------------------------

#: (shape, JAX blocks): one tile (tests/test_transformer.py:36), one tile
#: at the transformer's head width, and the ragged multi-tile shape (:66)
FWD_CASES = [((3, 16, 8), (256, 256)), ((4, 128, 64), (256, 256)),
             ((2, 300, 16), (64, 128))]
FWD_IDS = ["single_tile", "single_tile_dh64", "multi_tile"]


@pytest.mark.parametrize("level,bound", [(0, 4e-6), (1, 5e-6)],
                         ids=["0", "1"])
@pytest.mark.parametrize("shape,jax_blocks", FWD_CASES, ids=FWD_IDS)
def test_forward_matches_jax(shape, jax_blocks, level, bound):
    """Each level against JAX's at the same level.  Level 0 (bf16x3
    products, the scores summed in float32 as JAX sums them) measured
    1.1e-7, 5.7e-7 and 1.9e-6 on the three cases; the true-f32 forward
    that level 0 ran before it read 3.7e-6, 7.3e-6 and 7.1e-6 there, so
    the single tile at dh 64 shows that fault."""
    from veles_tpu.ops.attention import flash_attention as jax_flash
    q, k, v = _qkv(numpy.random.RandomState(1), *shape)
    want = numpy.asarray(jax_flash(q, k, v, precision_level=level,
                                   blocks=jax_blocks))
    got = flash_attention(*_tt(q, k, v), precision_level=level).numpy()
    assert got.shape == shape and got.dtype == numpy.float32
    assert numpy.isfinite(got).all()
    assert _max_rel(got, want) < bound


@pytest.mark.parametrize("shape,jax_blocks", FWD_CASES[:2],
                         ids=FWD_IDS[:2])
def test_forward_level0_is_nearer_jax_level0(shape, jax_blocks):
    """The level-0 forward sits nearer JAX's level 0 than JAX's level 1
    on one tile, where JAX's p is split at the whole row's max as the
    plain version's is (measured: 1.1e-7 against 3.7e-6, 5.7e-7 against
    7.3e-6)."""
    from veles_tpu.ops.attention import flash_attention as jax_flash
    q, k, v = _qkv(numpy.random.RandomState(1), *shape)
    want = [numpy.asarray(jax_flash(q, k, v, precision_level=level,
                                    blocks=jax_blocks)) for level in (0, 1)]
    got = flash_attention(*_tt(q, k, v)).numpy()
    assert 3 * _max_rel(got, want[0]) < _max_rel(got, want[1])


@pytest.mark.parametrize("shape,jax_blocks", FWD_CASES, ids=FWD_IDS)
def test_lse_matches_jax(shape, jax_blocks):
    """lse (B, T) f32 at level 0 against the JAX kernel's at level 0, in
    its lane-broadcast (B, T_pad, 128) layout, first lane, real rows."""
    from veles_tpu.ops.attention import _flash_fwd_jit
    q, k, v = _qkv(numpy.random.RandomState(2), *shape)
    scale = 1.0 / numpy.sqrt(shape[-1])
    _, lse = _flash_fwd_jit(q, k, v, float(scale), 0, jax_blocks, True)
    want = numpy.asarray(lse)[:, :shape[1], 0]
    _, got = attention_fwd(*_tt(q, k, v), float(scale))
    assert got.shape == shape[:2] and got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def _gradients_vs_jax_grad(shape, jax_blocks):
    """dq, dk, dv of sum(out**2), port vs ``jax.grad`` through the JAX
    kernel: finite and within 5e-6."""
    import jax
    import jax.numpy as jnp
    from veles_tpu.ops.attention import flash_attention as jax_flash
    q, k, v = _qkv(numpy.random.RandomState(2), *shape)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, precision_level=1,
                                 blocks=jax_blocks) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _tt(q, k, v, grad=True)
    out = flash_attention(tq, tk, tv, precision_level=1)
    got = torch.autograd.grad(torch.sum(out ** 2), (tq, tk, tv))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_rel(g.numpy(), w) < 5e-6


def test_gradients_match_jax_grad():
    """At T = 37 the JAX kernel pads both q and k rows; their
    contributions are exact zeros there."""
    _gradients_vs_jax_grad((2, 37, 8), (16, 128))


def test_multi_tile_gradients_match_jax_grad():
    """The ragged multi-tile shape: 5 q-tiles by 3 k-tiles on the JAX
    side, the last of each padded."""
    _gradients_vs_jax_grad((2, 300, 16), (64, 128))


#: (shape, JAX blocks, numpy seed): the single q-tile shape with both
#: paddings live, and the ragged multi-tile shape
LEVEL0_CASES = [((2, 37, 8), (16, 128), 21), ((2, 300, 16), (64, 128), 22)]


@pytest.mark.parametrize("shape,jax_blocks,seed", LEVEL0_CASES,
                         ids=["t37", "t300"])
def test_level0_backward_matches_jax(shape, jax_blocks, seed):
    """The port's level-0 plain backward against JAX's level-0 Pallas
    backward (interpret mode), both fed the same (q, k, v, do) and the
    JAX forward's out and lse, delta as ``_FlashAttention.backward``
    computes it: dq, dk, dv within max-rel 5e-6 (measured up to 4.74e-6
    at T = 37 and 2.22e-6 at T = 300: the port sums the scores exactly
    and JAX in float32, and the bf16 split of p and ds turns their
    last-bit differences into steps of 2^-17).  The true-f32 level 1
    lands at 8.9e-6 to 2.2e-5 from it, so the bound tells the two
    apart."""
    from veles_tpu.ops.attention import _flash_bwd_jit, _flash_fwd_jit
    rng = numpy.random.RandomState(seed)
    q, k, v, do = (rng.randn(*shape).astype(numpy.float32)
                   for _ in range(4))
    scale = float(1.0 / numpy.sqrt(shape[-1]))
    out, lse = _flash_fwd_jit(q, k, v, scale, 0, jax_blocks, True)
    want = _flash_bwd_jit(q, k, v, out, lse, do, scale, 0, jax_blocks,
                          True)
    tq, tk, tv, tdo, tout = _tt(q, k, v, do, out)
    tlse = torch.from_numpy(numpy.array(lse)[:, :shape[1], 0])
    delta = torch.sum(tdo * tout, dim=-1)
    got = (attention_dq_reference(tq, tk, tv, tdo, tlse, delta, scale,
                                  precision_level=0),) + \
        attention_dkv_reference(tq, tk, tv, tdo, tlse, delta, scale,
                                precision_level=0)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_rel(g.numpy(), w) < 5e-6


def test_bf16_operands_match_jax():
    import jax.numpy as jnp
    from veles_tpu.ops.attention import flash_attention as jax_flash
    q, k, v = _qkv(numpy.random.RandomState(3), 2, 24, 8)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = numpy.asarray(jax_flash(jq, jk, jv, blocks=(256, 256)),
                         numpy.float32)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _tt(q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    numpy.testing.assert_allclose(got.float().numpy(), want, rtol=0.05,
                                  atol=0.05)


def test_reference_matches_jax_reference():
    from veles_tpu.ops.attention import \
        attention_reference as jax_reference
    q, k, v = _qkv(numpy.random.RandomState(4), 3, 21, 16)
    want = numpy.asarray(jax_reference(q, k, v, precision_level=1))
    got = attention_reference(*_tt(q, k, v)).numpy()
    assert _max_rel(got, want) < 5e-6


# -- the autograd entry against stock autograd -------------------------------


AUTOGRAD_SHAPES = [(2, 37, 8), (3, 70, 16), (1, 5, 128)]


@pytest.mark.parametrize("shape", AUTOGRAD_SHAPES)
def test_flash_autograd_matches_stock_autograd(shape):
    """The hand-written backward at level 1 (true-f32 products; plain
    versions on the CPU) against autograd through
    :func:`attention_reference`, on a random cotangent."""
    rng = numpy.random.RandomState(5)
    q, k, v = _qkv(rng, *shape)
    do = rng.randn(*shape).astype(numpy.float32)
    grads = []
    for fn in (lambda a, b, c: flash_attention(a, b, c, precision_level=1),
               attention_reference):
        tq, tk, tv = _tt(q, k, v, grad=True)
        out = fn(tq, tk, tv)
        grads.append((out.detach(),) + torch.autograd.grad(
            out, (tq, tk, tv), torch.from_numpy(do)))
    for got, want in zip(*grads):
        assert _max_rel(got.numpy(), want.numpy()) < 5e-6


@pytest.mark.parametrize("shape", AUTOGRAD_SHAPES)
def test_flash_autograd_level0_is_the_bf16x3_backward(shape):
    """At level 0 (the default) autograd runs the level-0 backward: the
    same bits as the level-0 plain versions fed the forward's out and
    lse, and other bits than level 1's true-f32 products."""
    rng = numpy.random.RandomState(5)
    q, k, v = _qkv(rng, *shape)
    do = torch.from_numpy(rng.randn(*shape).astype(numpy.float32))
    tq, tk, tv = _tt(q, k, v, grad=True)
    got = torch.autograd.grad(flash_attention(tq, tk, tv), (tq, tk, tv),
                              do)
    q, k, v = (t.detach() for t in (tq, tk, tv))
    scale = 1.0 / numpy.sqrt(shape[-1])
    out, lse = attention_fwd(q, k, v, scale)
    delta = torch.sum(do * out, dim=-1)
    for level, same in ((0, True), (1, False)):
        want = (attention_dq_reference(q, k, v, do, lse, delta, scale,
                                       precision_level=level),) + \
            attention_dkv_reference(q, k, v, do, lse, delta, scale,
                                    precision_level=level)
        assert all(torch.equal(g, w) for g, w in zip(got, want)) == same


def test_float64_gradcheck():
    rng = numpy.random.RandomState(6)
    q, k, v = (torch.from_numpy(a.astype(numpy.float64)).requires_grad_()
               for a in _qkv(rng, 2, 11, 4))
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention(a, b, c, scale=0.7), (q, k, v))


def test_inference_runs_the_forward_alone():
    q, k, v = _tt(*_qkv(numpy.random.RandomState(7), 2, 9, 4), grad=True)
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, attention_fwd(q.detach(), k.detach(),
                                          v.detach(), 0.5)[0])


# -- the plain versions ------------------------------------------------------


def _backward_operands(shape, seed):
    """q, k, v, do, and lse and delta from the true-f32 forward."""
    rng = numpy.random.RandomState(seed)
    q, k, v = _tt(*_qkv(rng, *shape))
    do = torch.from_numpy(rng.randn(*shape).astype(numpy.float32))
    scale = 1.0 / numpy.sqrt(shape[-1])
    out, lse = attention_fwd_reference(q, k, v, scale, precision_level=1)
    delta = torch.sum(do * out, dim=-1)
    return q, k, v, do, lse, delta, scale


def _bf16x3(a, b, exact=False):
    """hi hi + hi lo + lo hi of the bf16 splits, batched: the TPU's
    level-0 product (``veles_tpu/ops/common.py`` ``mxu_partial_dot``),
    summed in float32 or, ``exact``, in float64 and rounded once."""
    a_hi, b_hi = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    a_lo = (a - a_hi).to(torch.bfloat16).float()
    b_lo = (b - b_hi).to(torch.bfloat16).float()
    if exact:
        a_hi, b_hi, a_lo, b_lo = (x.double() for x in (a_hi, b_hi, a_lo,
                                                        b_lo))
        return (a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi).float()
    return (a_hi @ b_hi + a_hi @ b_lo) + a_lo @ b_hi


@pytest.mark.parametrize("level", [0, 1, 2])
def test_levels_compute_the_same(level):
    """Levels 1 and 2 compute the same bits (true f32) in the forward and
    the backward; level 0 the bf16x3 formula, bit for bit, and other bits
    than level 1: the forward's products summed in float32, the
    backward's scores summed exactly and rounded once and its output
    products summed in float32."""
    q, k, v, do, lse, delta, scale = _backward_operands((2, 19, 8), 8)
    base = (attention_fwd(q, k, v, scale, precision_level=1),
            attention_dq(q, k, v, do, lse, delta, scale,
                         precision_level=1),
            attention_dkv(q, k, v, do, lse, delta, scale,
                          precision_level=1))
    got = (attention_fwd(q, k, v, scale, precision_level=level),
           attention_dq(q, k, v, do, lse, delta, scale,
                        precision_level=level),
           attention_dkv(q, k, v, do, lse, delta, scale,
                         precision_level=level))
    if level == 0:
        kt = k.transpose(1, 2)
        s = _bf16x3(q, kt) * scale
        m = torch.amax(s, dim=-1, keepdim=True)
        e = torch.exp(s - m)
        l = torch.sum(e, dim=-1, keepdim=True)
        fwd = (_bf16x3(e, v) / l, (m + torch.log(l))[..., 0])
        for a, b in zip(got[0], fwd):
            assert torch.equal(a, b)
        assert not torch.equal(got[0][0], base[0][0])
        p = torch.exp(_bf16x3(q, kt, True) * scale - lse[..., None])
        ds = p * (_bf16x3(do, v.transpose(1, 2), True) -
                  delta[..., None]) * scale
        base = (fwd, _bf16x3(ds, k),
                (_bf16x3(ds.transpose(1, 2), q),
                 _bf16x3(p.transpose(1, 2), do)))
        assert not torch.equal(got[1], attention_dq(
            q, k, v, do, lse, delta, scale, precision_level=1))
    for a, b in zip(got[0], base[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], base[1])
    for a, b in zip(got[2], base[2]):
        assert torch.equal(a, b)


def test_plain_level0_products_and_float64_bypass():
    """The level-0 plain versions sum the score products exactly and
    round once, take the port's ``_partial_dot`` for the output
    products, and true products on float64, whose split would be lost.
    The float32 level 0 stays within 3e-5 of float64 (measured 1.1e-5:
    bf16x3 keeps about 16 bits of each operand)."""
    q, k, v, do, lse, delta, scale = _backward_operands((2, 19, 8), 10)
    dq = attention_dq_reference(q, k, v, do, lse, delta, scale)
    p = torch.exp(attention._exact_bf16x3(q, k.transpose(1, 2)) * scale -
                  lse[..., None])
    ds = p * (attention._exact_bf16x3(do, v.transpose(1, 2)) -
              delta[..., None]) * scale
    assert torch.equal(dq, _partial_dot(ds, k, 0))
    wide = [t.double() for t in (q, k, v, do, lse, delta)]
    dq64 = attention_dq_reference(*wide, scale)
    assert dq64.dtype == torch.float64
    assert torch.equal(dq64, attention_dq_reference(*wide, scale,
                                                    precision_level=1))
    assert _max_rel(dq.numpy(), dq64.numpy()) < 3e-5


@pytest.mark.parametrize("level,path", [(0, "tc_bf16x3"), (1, "simt"),
                                        (2, "simt")])
def test_plan_backward(level, path):
    """The design rule of all three attention kernels (the forward's
    and the backward's), by level."""
    assert plan_attention(level) == path
    with pytest.raises(ValueError, match="precision_level"):
        plan_attention(3)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_design_reaches_the_kernels(monkeypatch, level):
    """The three C entries get the design code after the scale, and the
    paths count each call under its design."""
    from test_torch_gather import patch_recording_launch
    calls = patch_recording_launch(monkeypatch)
    for launcher in (attention._launch_fwd, attention._launch_dq,
                     attention._launch_dkv):
        monkeypatch.setattr(launcher, "fn", None)
    q, k, v, do, lse, delta, scale = _backward_operands((3, 40, 8), 14)
    path = plan_attention(level)
    counters = (attention_fwd, attention_dq, attention_dkv)
    before = [(dict(c.paths), c.launches) for c in counters]
    out, lse2 = attention._launch_fwd(q, k, v, scale, level)
    dq = attention._launch_dq(q, k, v, do, lse, delta, scale, level)
    dk, dv = attention._launch_dkv(q, k, v, do, lse, delta, scale, level)
    # the forward's entry takes its persistent grid after the pointers
    # (0: the resident count, the static plan)
    assert [len(args) for args in calls] == [5 + 9, 7 + 8, 8 + 8]
    for args in calls:
        assert args[-8:-2] == (3, 40, 8, 0, scale,
                               attention.PATHS.index(path))
    assert calls[0][3:6] == (out.data_ptr(), lse2.data_ptr(), 0)
    assert calls[1][6] == dq.data_ptr()
    assert calls[2][6:8] == (dk.data_ptr(), dv.data_ptr())
    for counter, (paths, launches) in zip(counters, before):
        assert counter.paths == dict(paths, **{path: paths[path] + 1})
        assert counter.launches == launches + 1


def test_backward_formulas_match_autograd():
    """dq, dk, dv of the plain versions at level 1 (true-f32 products)
    against autograd through the plain forward, from the same lse and
    delta."""
    q, k, v, do, lse, delta, scale = _backward_operands((2, 33, 8), 9)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention_reference(tq, tk, tv, scale)
    want = torch.autograd.grad(out, (tq, tk, tv), do)
    dq = attention_dq_reference(q, k, v, do, lse, delta, scale,
                                precision_level=1)
    dk, dv = attention_dkv_reference(q, k, v, do, lse, delta, scale,
                                     precision_level=1)
    for got, w in zip((dq, dk, dv), want):
        assert _max_rel(got.numpy(), w.numpy()) < 5e-6


def test_cpu_calls_launch_nothing():
    q, k, v, do, lse, delta, scale = _backward_operands((1, 8, 4), 11)
    counts = [f.launches for f in (attention_fwd, attention_dq,
                                   attention_dkv)]
    attention_fwd(q, k, v, scale)
    attention_dq(q, k, v, do, lse, delta, scale)
    attention_dkv(q, k, v, do, lse, delta, scale)
    assert counts == [f.launches for f in (attention_fwd, attention_dq,
                                           attention_dkv)]


# -- argument errors ---------------------------------------------------------


def _ones(*shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype)


@pytest.mark.parametrize("args,error,match", [
    ((_ones(2, 8, 4), _ones(2, 8, 4), _ones(2, 9, 4)), ValueError,
     "matching"),
    ((_ones(8, 4), _ones(8, 4), _ones(8, 4)), ValueError, "matching"),
    ((_ones(1, 8, 130),) * 3, ValueError, "dh <= 128"),
    ((_ones(1, 8, 4), _ones(1, 8, 4), _ones(1, 8, 4, dtype=torch.float64)),
     TypeError, "dtypes"),
    ((_ones(1, 4, 8).transpose(1, 2),) * 3, ValueError, "contiguous"),
], ids=["shape", "rank", "wide_head", "dtype", "strided"])
def test_wrapper_argument_errors(args, error, match):
    with pytest.raises(error, match=match):
        attention_fwd(*args, 0.5)


def test_option_errors():
    q = _ones(1, 8, 4)
    with pytest.raises(ValueError, match="kernel tile"):
        attention_fwd(q, q, q, 0.5, blocks=(64, 128))
    assert torch.equal(attention_fwd(q, q, q, 0.5, blocks=(64, 64))[0],
                       attention_fwd(q, q, q, 0.5)[0])
    with pytest.raises(ValueError, match="precision_level"):
        attention_fwd(q, q, q, 0.5, precision_level=3)
    with pytest.raises(ValueError, match="precision_level"):
        flash_attention(q, q, q, precision_level=-1)
    with pytest.raises(ValueError, match="matching"):
        flash_attention(q, q, _ones(1, 8, 5))
    rows = _ones(1, 8)
    with pytest.raises(ValueError, match=r"\(B, T\) rows"):
        attention_dq(q, q, q, q, _ones(1, 7), rows, 0.5)
    with pytest.raises(ValueError, match="matching"):
        attention_dkv(q, q, q, _ones(1, 8, 3), rows, rows, 0.5)


def test_other_devices_raise():
    q = _ones(1, 8, 4, dtype=torch.float32).to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        attention_fwd(q, q, q, 0.5)


# -- build and launch failures (no card needed) ------------------------------


def _launchers():
    """(launcher, wrapper, call) of each kernel; the forward at level 0
    (``tc_bf16x3``) and at level 1 (``simt``)."""
    q, k, v, do, lse, delta, scale = _backward_operands((1, 8, 4), 12)
    return [
        (attention._launch_fwd, attention_fwd,
         lambda: attention._launch_fwd(q, k, v, scale)),
        (attention._launch_dq, attention_dq,
         lambda: attention._launch_dq(q, k, v, do, lse, delta, scale)),
        (attention._launch_dkv, attention_dkv,
         lambda: attention._launch_dkv(q, k, v, do, lse, delta, scale)),
        (attention._launch_fwd, attention_fwd,
         lambda: attention._launch_fwd(q, k, v, scale, 1)),
    ]


LAUNCHER_IDS = ["fwd", "dq", "dkv", "fwd_simt"]


@pytest.mark.parametrize("which", [0, 1, 2, 3], ids=LAUNCHER_IDS)
def test_failed_build_raises(monkeypatch, tmp_path, which):
    """No design falls back to another or to the plain version when the
    build fails: the call raises and counts nothing."""
    from test_torch_gather import patch_failing_build
    patch_failing_build(monkeypatch, tmp_path)
    launcher, wrapper, call = _launchers()[which]
    monkeypatch.setattr(launcher, "fn", None)
    before = wrapper.launches, dict(wrapper.paths)
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
    assert (wrapper.launches, wrapper.paths) == before


@pytest.mark.parametrize("which", [0, 1, 2, 3], ids=LAUNCHER_IDS)
def test_failed_launch_raises(monkeypatch, which):
    """A launch that fails raises after one call of the C entry: no
    second try in another design."""
    from test_torch_gather import FakeLibrary, patch_failing_launch
    patch_failing_launch(monkeypatch)
    launcher, wrapper, call = _launchers()[which]
    monkeypatch.setattr(launcher, "fn", None)
    before, calls = (wrapper.launches, dict(wrapper.paths)), \
        FakeLibrary.calls
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    assert FakeLibrary.calls == calls + 1
    assert (wrapper.launches, wrapper.paths) == before


# -- the kernels on the card -------------------------------------------------

#: chip_smoke.py's shapes: the transformer's (B*H, T, dh) at batch 64,
#: the long sequence, the ragged multi-tile shapes of the reference tests
CUDA_CASES = [(512, 128, 64), (8, 1024, 64), (2, 300, 16), (2, 37, 8),
              (3, 100, 128), (3, 70, 96)]
CUDA_IDS = ["model", "long", "ragged_300", "ragged_37", "dh_128",
            "dh_96"]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_operands(shape, device, dtype=torch.float32, seed=13):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(dtype)
                   for _ in range(4))
    return q, k, v, do, 1.0 / float(numpy.sqrt(shape[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_kernels_match_plain_versions(cuda_card, shape):
    q, k, v, do, scale = _card_operands(shape, cuda_card)
    before = [f.launches for f in (attention_fwd, attention_dq,
                                   attention_dkv)]
    out, lse = attention_fwd(q, k, v, scale)
    out2, lse2 = attention_fwd(q, k, v, scale)
    delta = torch.sum(do * out, dim=-1)
    dq = attention_dq(q, k, v, do, lse, delta, scale)
    dq2 = attention_dq(q, k, v, do, lse, delta, scale)
    dk, dv = attention_dkv(q, k, v, do, lse, delta, scale)
    dk2, dv2 = attention_dkv(q, k, v, do, lse, delta, scale)
    assert [f.launches for f in (attention_fwd, attention_dq,
                                 attention_dkv)] == [b + 2 for b in before]
    for a, b in ((out, out2), (lse, lse2), (dq, dq2), (dk, dk2),
                 (dv, dv2)):
        assert torch.equal(a, b)
    want_out, want_lse = attention_fwd_reference(q, k, v, scale)
    want_dq = attention_dq_reference(q, k, v, do, lse, delta, scale)
    want_dk, want_dv = attention_dkv_reference(q, k, v, do, lse, delta,
                                               scale)
    for got, want in ((out, want_out), (lse, want_lse), (dq, want_dq),
                      (dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got).all()
        assert _max_rel(got.cpu().numpy(), want.cpu().numpy()) <= 1e-5


@pytest.mark.cuda
def test_cuda_kernels_bf16(cuda_card):
    q, k, v, do, scale = _card_operands((16, 128, 64), cuda_card,
                                        torch.bfloat16)
    out, lse = attention_fwd(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want_out, want_lse = attention_fwd_reference(q, k, v, scale)
    assert (out.float() - want_out.float()).abs().max().item() <= 0.02
    assert _max_rel(lse.cpu().numpy(), want_lse.cpu().numpy()) <= 1e-5
    delta = torch.sum(do.float() * out.float(), dim=-1)
    dq = attention_dq(q, k, v, do, lse, delta, scale)
    dk, dv = attention_dkv(q, k, v, do, lse, delta, scale)
    want = (attention_dq_reference(q, k, v, do, lse, delta, scale),) + \
        attention_dkv_reference(q, k, v, do, lse, delta, scale)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        assert _max_rel(got.float().cpu().numpy(),
                        w.float().cpu().numpy()) <= 0.02


def nan_tailed(x, tail):
    """x copied into the front of a buffer whose next ``tail`` elements
    are NaN: a kernel that reads past T picks the NaN up."""
    buf = torch.full((x.numel() + tail,), float("nan"), dtype=x.dtype,
                     device=x.device)
    view = buf[:x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 137, 64), (2, 37, 8)],
                         ids=["one_head", "ragged_37"])
def test_cuda_reads_nothing_past_t(cuda_card, shape):
    """Ragged last tiles: the kernels read T rows and no more (NaN
    after the operands changes no bit), and the masked key columns add
    exact zeros."""
    q, k, v, do, scale = _card_operands(shape, cuda_card)
    out, lse = attention_fwd(q, k, v, scale)
    delta = torch.sum(do * out, dim=-1)
    want = (out, lse, attention_dq(q, k, v, do, lse, delta, scale)) + \
        attention_dkv(q, k, v, do, lse, delta, scale)
    tq, tk, tv, tdo = (nan_tailed(x, 64 * shape[-1]) for x in (q, k, v, do))
    tout, tlse = attention_fwd(tq, tk, tv, scale)
    got = (tout, tlse, attention_dq(tq, tk, tv, tdo, lse, delta, scale)) + \
        attention_dkv(tq, tk, tv, tdo, lse, delta, scale)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_flash_autograd_matches_stock_autograd(cuda_card):
    """Level 1 (the ``simt`` backward, true f32) against stock autograd."""
    q, k, v, do, _ = _card_operands((6, 150, 32), cuda_card)
    grads = []
    for fn in (lambda a, b, c: flash_attention(a, b, c, precision_level=1),
               attention_reference):
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(tq, tk, tv)
        grads.append((out.detach(),) + torch.autograd.grad(
            out, (tq, tk, tv), do))
    for got, want in zip(*grads):
        assert _max_rel(got.cpu().numpy(), want.cpu().numpy()) <= 1e-5


@pytest.mark.cuda
def test_cuda_flash_autograd_level0_matches_plain_versions(cuda_card):
    """Level 0 (the default; the ``tc_bf16x3`` backward) against the
    level-0 plain versions fed the forward kernel's out and lse."""
    q, k, v, do, scale = _card_operands((6, 150, 32), cuda_card)
    before = dict(attention_dq.paths), dict(attention_dkv.paths)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(flash_attention(tq, tk, tv), (tq, tk, tv),
                              do)
    assert attention_dq.paths["tc_bf16x3"] == before[0]["tc_bf16x3"] + 1
    assert attention_dkv.paths["tc_bf16x3"] == before[1]["tc_bf16x3"] + 1
    out, lse = attention_fwd(q, k, v, scale)
    delta = torch.sum(do * out, dim=-1)
    want = (attention_dq_reference(q, k, v, do, lse, delta, scale),) + \
        attention_dkv_reference(q, k, v, do, lse, delta, scale)
    for g, w in zip(got, want):
        assert _max_rel(g.cpu().numpy(), w.cpu().numpy()) <= 1e-5


def _backward_on_card(shape, device, level, dtype=torch.float32):
    """Operands, and the kernels' (dq, dk, dv) twice at ``level``."""
    q, k, v, do, scale = _card_operands(shape, device, dtype)
    out, lse = attention_fwd(q, k, v, scale)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    bwd = (q, k, v, do, lse, delta, scale)
    runs = [(attention_dq(*bwd, precision_level=level),) +
            attention_dkv(*bwd, precision_level=level) for _ in range(2)]
    return bwd, runs


@pytest.mark.cuda
@pytest.mark.parametrize("t", [37, 128, 300, 1024])
@pytest.mark.parametrize("dh", [8, 16, 64, 128])
def test_cuda_tc_bf16x3_matches_plain_versions(cuda_card, dh, t):
    """The level-0 design against the level-0 plain versions (max-rel
    1e-5), the same bits twice and with NaN after the operands, and each
    call counted under ``tc_bf16x3``."""
    before = dict(attention_dq.paths), dict(attention_dkv.paths)
    bwd, (got, again) = _backward_on_card((3, t, dh), cuda_card, 0)
    for counter, paths in ((attention_dq, before[0]),
                           (attention_dkv, before[1])):
        assert counter.paths == dict(paths, tc_bf16x3=paths["tc_bf16x3"] + 2)
    q, k, v, do, lse, delta, scale = bwd
    want = (attention_dq_reference(*bwd),) + attention_dkv_reference(*bwd)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert torch.isfinite(g).all()
        assert _max_rel(g.cpu().numpy(), w.cpu().numpy()) <= 1e-5
    tq, tk, tv, tdo = (nan_tailed(x, 64 * dh) for x in (q, k, v, do))
    tails = (attention_dq(tq, tk, tv, tdo, lse, delta, scale),) + \
        attention_dkv(tq, tk, tv, tdo, lse, delta, scale)
    for g, w in zip(tails, got):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_simt_level1_matches_plain_versions(cuda_card, shape):
    """Levels 1 and 2 keep the true-f32 design: against the level-1
    plain versions (max-rel 1e-5), the same bits twice, counted under
    ``simt``."""
    before = dict(attention_dq.paths), dict(attention_dkv.paths)
    bwd, (got, again) = _backward_on_card(shape, cuda_card, 1)
    for counter, paths in ((attention_dq, before[0]),
                           (attention_dkv, before[1])):
        assert counter.paths == dict(paths, simt=paths["simt"] + 2)
    want = (attention_dq_reference(*bwd, precision_level=1),) + \
        attention_dkv_reference(*bwd, precision_level=1)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert _max_rel(g.cpu().numpy(), w.cpu().numpy()) <= 1e-5


@pytest.mark.cuda
def test_cuda_tc_bf16x3_bf16(cuda_card):
    """bf16 operands at level 0: no lo planes, against the level-0 plain
    version within 1e-2 (one bf16 rounding of the outputs)."""
    bwd, (got, again) = _backward_on_card((16, 300, 64), cuda_card, 0,
                                          torch.bfloat16)
    want = (attention_dq_reference(*bwd),) + attention_dkv_reference(*bwd)
    for g, g2, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, g2)
        assert _max_rel(g.float().cpu().numpy(),
                        w.float().cpu().numpy()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("t", [64, 37, 300])
@pytest.mark.parametrize("dh", [6, 8, 64, 128])
def test_cuda_forward_designs_match_plain_versions(cuda_card, dh, t, level):
    """Each forward design (level 0 ``tc_bf16x3``, level 1 ``simt``)
    against the plain version at its level, at one tile, a ragged T and
    several k tiles, dh 6 taking element loads and stores: out and lse
    within max-rel 1e-5, the same bits twice and with NaN after the
    operands, each call counted under the level's design; at level 0 the
    out at least twice as near the level-0 plain version as the level-1
    one (bf16x3 products, not true f32)."""
    q, k, v, _, scale = _card_operands((3, t, dh), cuda_card)
    path = plan_attention(level)
    before = dict(attention_fwd.paths)
    got, again = (attention_fwd(q, k, v, scale, precision_level=level)
                  for _ in range(2))
    assert attention_fwd.paths == dict(before, **{path: before[path] + 2})
    want = attention_fwd_reference(q, k, v, scale, precision_level=level)
    tails = attention_fwd(*(nan_tailed(x, 64 * dh) for x in (q, k, v)),
                          scale, precision_level=level)
    for g, g2, w, tail in zip(got, again, want, tails):
        assert torch.equal(g, g2) and torch.equal(g, tail)
        assert torch.isfinite(g).all()
        assert _max_rel(g.cpu().numpy(), w.cpu().numpy()) <= 1e-5
    if level == 0:
        level1 = attention_fwd_reference(q, k, v, scale, precision_level=1)
        assert 2 * _max_rel(got[0].cpu().numpy(), want[0].cpu().numpy()) < \
            _max_rel(got[0].cpu().numpy(), level1[0].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1])
def test_cuda_forward_bf16(cuda_card, level):
    """bf16 operands in each design: out within max-rel 1e-2 of the plain
    version at the level (one bf16 rounding), lse within 1e-5, the same
    bits twice."""
    q, k, v, _, scale = _card_operands((16, 300, 64), cuda_card,
                                       torch.bfloat16)
    path = plan_attention(level)
    before = dict(attention_fwd.paths)
    got, again = (attention_fwd(q, k, v, scale, precision_level=level)
                  for _ in range(2))
    assert attention_fwd.paths == dict(before, **{path: before[path] + 2})
    want = attention_fwd_reference(q, k, v, scale, precision_level=level)
    assert got[0].dtype == torch.bfloat16
    for g, g2, w, bound in zip(got, again, want, (1e-2, 1e-5)):
        assert torch.equal(g, g2)
        assert _max_rel(g.float().cpu().numpy(),
                        w.float().cpu().numpy()) <= bound
