"""The port's matmul, gemm and power rating (veles_tpu_torch: ops/matmul.py,
ops/blas.py, ops/benchmark.py, Device.computing_power,
Workflow.computing_power) against the JAX package's.

On the CPU ``matmul`` runs its plain PyTorch version; the JAX ``matmul``
runs its Pallas kernel in interpret mode on the same seeded inputs, at
precision levels 0, 1 and 2, with ``blocks`` None and (32, 128, 128).
float32 results agree within rtol 1e-5 and atol 1e-6 (level 0 sums its
three bf16 products in another order than XLA's dot; levels 1 and 2
agree bit for bit on most shapes); bfloat16 outputs within 1 bf16 ulp.
The ``cuda`` tests hold the CUDA kernel against the plain version on a
card (max-rel 1e-5, the same bits twice) and skip where there is none.
The planner (``plan_matmul``) is pure Python and is held here: which
design serves which call, whole K-tiles per split, packed copies where
TMA or 16-byte loads cannot take an operand as it is; the split-K fold
rule is held through a float32 emulation of it."""

import numpy
import pytest
import torch

from veles_tpu_torch.backends import Device
from veles_tpu_torch.ops import benchmark
from veles_tpu_torch.ops.blas import gemm, veles_gemm
from veles_tpu_torch.ops.common import split_ranges
from veles_tpu_torch.ops.matmul import (PATHS, matmul, matmul_benchmark,
                                        matmul_reference, plan_matmul)

CPU = Device(backend="cpu")

SHAPES = [(64, 32, 48), (128, 128, 128), (100, 77, 33), (8, 300, 120),
          (3, 5, 7), (17, 129, 33), (1, 1, 1), (130, 257, 5)]


def _operands(seed, m, k, n):
    rng = numpy.random.RandomState(seed)
    return (rng.rand(m, k).astype(numpy.float32),
            rng.rand(k, n).astype(numpy.float32))


def _jax_matmul(a, b, **kwargs):
    import jax.numpy as jnp
    from veles_tpu.ops.matmul import matmul as jax_matmul
    if "out_dtype" in kwargs and kwargs["out_dtype"] is not None:
        kwargs["out_dtype"] = getattr(jnp, kwargs["out_dtype"])
    return jax_matmul(jnp.asarray(a), jnp.asarray(b), **kwargs)


def _bf16_bits(x):
    """bfloat16 values (torch or jax) -> their 16-bit patterns as int."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(numpy.int64)
    return numpy.asarray(x).view(numpy.int16).astype(numpy.int64)


@pytest.mark.parametrize("blocks", [None, (32, 128, 128)],
                         ids=["default", "32x128x128"])
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_matches_jax(shape, level, blocks):
    a, b = _operands(sum(shape) + level, *shape)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b),
                 precision_level=level, blocks=blocks)
    want = numpy.asarray(_jax_matmul(a, b, precision_level=level,
                                     blocks=blocks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    oracle = a.astype(numpy.float64) @ b.astype(numpy.float64)
    numpy.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5)


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("inputs", ["float32", "bfloat16"])
def test_bf16_out_within_one_ulp_of_jax(inputs, level):
    import jax.numpy as jnp
    a, b = _operands(7 + level, 40, 300, 24)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if inputs == "bfloat16":
        ta, tb = ta.to(torch.bfloat16), tb.to(torch.bfloat16)
        ja, jb = ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16)
    from veles_tpu.ops.matmul import matmul as jax_matmul
    got = matmul(ta, tb, precision_level=level, out_dtype=torch.bfloat16)
    want = jax_matmul(ja, jb, precision_level=level,
                      out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert numpy.abs(_bf16_bits(got) - _bf16_bits(want)).max() <= 1


def test_bf16_operands_f32_out_match_jax():
    import jax.numpy as jnp
    from veles_tpu.ops.matmul import matmul as jax_matmul
    a, b = _operands(3, 33, 200, 17)
    got = matmul(torch.from_numpy(a).to(torch.bfloat16),
                 torch.from_numpy(b).to(torch.bfloat16),
                 out_dtype=torch.float32)
    want = jax_matmul(jnp.asarray(a).astype(jnp.bfloat16),
                      jnp.asarray(b).astype(jnp.bfloat16),
                      out_dtype=jnp.float32)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=1e-5, atol=1e-6)


def _ladder_operands():
    """tests/test_ops.py's adversarial accumulation: large alternating
    terms."""
    k = 4096
    a = numpy.where(numpy.arange(k) % 2 == 0, 1e6, 1.0).astype(
        numpy.float32).reshape(1, k)
    a = numpy.repeat(a, 8, axis=0)
    b = numpy.where(numpy.arange(k) % 2 == 0, 1.0, -1e-3).astype(
        numpy.float32).reshape(k, 1)
    return a, numpy.repeat(b, 8, axis=1)


def _ladder_errors(a, b, mm):
    oracle = a.astype(numpy.float64) @ b.astype(numpy.float64)
    return [numpy.abs(mm(level) - oracle).max() for level in (0, 1, 2)]


def test_precision_level_accuracy_ladder():
    a, b = _ladder_operands()
    errs = _ladder_errors(a, b, lambda level: matmul(
        torch.from_numpy(a), torch.from_numpy(b), precision_level=level,
        blocks=(8, 128, 256)).numpy())
    assert errs[1] <= errs[0] * 1.001
    assert errs[2] <= errs[1] * 1.001


@pytest.mark.parametrize("level", [0, 1, 2])
def test_ladder_case_matches_jax(level):
    a, b = _ladder_operands()
    got = matmul(torch.from_numpy(a), torch.from_numpy(b),
                 precision_level=level, blocks=(8, 128, 256)).numpy()
    want = numpy.asarray(_jax_matmul(a, b, precision_level=level,
                                     blocks=(8, 128, 256)))
    numpy.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_c", [False, True], ids=["no_c", "c"])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_gemm_matches_jax(trans_a, trans_b, with_c):
    import jax.numpy as jnp
    from veles_tpu.ops.blas import gemm as jax_gemm
    rng = numpy.random.RandomState(int(trans_a) * 2 + int(trans_b))
    a = rng.rand(*((16, 24) if trans_a else (24, 16))).astype(numpy.float32)
    b = rng.rand(*((40, 16) if trans_b else (16, 40))).astype(numpy.float32)
    c = rng.rand(24, 40).astype(numpy.float32) if with_c else None
    kwargs = dict(alpha=0.75, beta=-1.5, trans_a=trans_a, trans_b=trans_b)
    got = gemm(torch.from_numpy(a), torch.from_numpy(b),
               None if c is None else torch.from_numpy(c), **kwargs)
    want = jax_gemm(jnp.asarray(a), jnp.asarray(b),
                    None if c is None else jnp.asarray(c), **kwargs)
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=1e-5, atol=1e-6)
    op_a = a.T if trans_a else a
    op_b = b.T if trans_b else b
    oracle = 0.75 * (op_a.astype(numpy.float64) @ op_b)
    if c is not None:
        oracle = oracle - 1.5 * c
    numpy.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5,
                                  atol=1e-5)


def test_gemm_transposes_as_test_ops_does():
    rng = numpy.random.RandomState(42)
    a = rng.rand(24, 16).astype(numpy.float32)
    b = rng.rand(8, 24).astype(numpy.float32)
    out = veles_gemm(torch.from_numpy(a), torch.from_numpy(b),
                     trans_a=True, trans_b=True)
    numpy.testing.assert_allclose(out.numpy(), a.T @ b.T, rtol=1e-5)


def test_gemm_bf16_casts_back():
    a = torch.ones(4, 8, dtype=torch.bfloat16)
    out = gemm(a, torch.ones(8, 3, dtype=torch.bfloat16), alpha=2.0)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), torch.full((4, 3), 16.0))


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        matmul(torch.ones(3, 4), torch.ones(5, 6))
    with pytest.raises(ValueError):
        matmul(torch.ones(3), torch.ones(3, 2))
    with pytest.raises(TypeError):
        f64 = torch.ones(4, 4, dtype=torch.float64)
        matmul(f64, f64)
    with pytest.raises(TypeError):
        matmul(torch.ones(3, 4), torch.ones(4, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        matmul(torch.ones(3, 4), torch.ones(4, 2), precision_level=3)


@pytest.mark.parametrize("shape", [(0, 4, 3), (3, 0, 5), (2, 6, 0)])
def test_zero_size_gives_zeros(shape):
    m, k, n = shape
    out = matmul(torch.ones(m, k), torch.ones(k, n))
    assert tuple(out.shape) == (m, n) and not out.any()
    want = numpy.asarray(_jax_matmul(numpy.ones((m, k), numpy.float32),
                                     numpy.ones((k, n), numpy.float32)))
    assert want.shape == (m, n)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_nan_row_stays_in_its_row(level):
    a = numpy.ones((4, 4), numpy.float32)
    a[1, 2] = numpy.nan
    out = matmul(torch.from_numpy(a), torch.ones(4, 4),
                 precision_level=level).numpy()
    assert numpy.isnan(out[1]).all()
    assert numpy.isfinite(numpy.delete(out, 1, axis=0)).all()


@pytest.mark.parametrize("level", [0, 1])
def test_level0_domain_edge_matches_jax(level):
    """An operand at 3.4e38 (above the bf16 maximum) gives non-finite
    output at level 0, where JAX's does, and finite output at level 1."""
    a = numpy.full((2, 3), 1e-3, numpy.float32)
    a[0, 1] = 3.4e38
    b = numpy.full((3, 2), 1e-3, numpy.float32)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b),
                 precision_level=level).numpy()
    want = numpy.asarray(_jax_matmul(a, b, precision_level=level))
    numpy.testing.assert_array_equal(numpy.isfinite(got),
                                     numpy.isfinite(want))
    assert numpy.isfinite(got).all() == (level == 1)


def test_matmul_benchmark_positive_on_cpu():
    assert matmul_benchmark(size=128, repeats=2, device=CPU) > 0


def test_estimate_computing_power_positive_on_cpu():
    assert benchmark.estimate_computing_power(size=128, repeats=2,
                                              device=CPU) > 0


def test_estimate_computing_power_refuses_noise(monkeypatch):
    calls = []

    def implausible(size, repeats, device):
        calls.append(repeats)
        return 1e-12

    monkeypatch.setattr(benchmark, "matmul_benchmark", implausible)
    with pytest.raises(RuntimeError, match="minimum credible"):
        benchmark.estimate_computing_power(size=256, repeats=3, device=CPU)
    assert calls == [3, 12, 48]


def test_estimate_computing_power_remeasures(monkeypatch):
    slopes = iter([1e-12, 0.004])
    monkeypatch.setattr(benchmark, "matmul_benchmark",
                        lambda size, repeats, device: next(slopes))
    assert benchmark.estimate_computing_power(size=256, device=CPU) == \
        pytest.approx(250000.0)


def test_device_computing_power_on_cpu():
    device = Device(backend="cpu")
    power = device.computing_power
    assert power > 0
    assert device.computing_power == power   # measured once


def test_workflow_computing_power():
    from veles_tpu_torch.dummy import DummyWorkflow
    wf = DummyWorkflow()
    assert wf.computing_power == 0.0
    wf.initialize(device=CPU)
    assert wf.computing_power == CPU.computing_power > 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: Device() would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        matmul_benchmark(size=8, repeats=1)


# -- the planner -------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16
FC1 = (32, 25088, 4096)


def _plan(m, k, n, bk=512, level=0, dtype=F32, trans_a=False,
          trans_b=False, a_ptr=0, b_ptr=0):
    a_strides = (1, m) if trans_a else (k, 1)
    b_strides = (1, k) if trans_b else (n, 1)
    return plan_matmul(m, k, n, bk, level, dtype, a_strides, b_strides,
                       a_ptr, b_ptr, sm_count=132)


@pytest.mark.parametrize("k", [25088, 3001, 4096 + 77, 300, 129])
@pytest.mark.parametrize("bk", [128, 256, 512])
def test_plan_splits_cover_whole_ktiles_once_in_order(bk, k):
    for m, n, level in ((32, 4096, 0), (8, 8, 1), (1024, 1024, 0)):
        plan = _plan(m, k, n, bk=bk, level=level)
        assert plan["ktiles"] == -(-k // bk)
        ranges = split_ranges(plan["ktiles"], plan["splits"])
        assert ranges[0][0] == 0 and ranges[-1][1] == plan["ktiles"]
        for (_, stop), (start, _) in zip(ranges, ranges[1:]):
            assert stop == start
        assert all(stop > start for start, stop in ranges)
        sizes = [stop - start for start, stop in ranges]
        assert max(sizes) - min(sizes) <= 1


def test_plan_fc1_takes_split_k_with_enough_blocks():
    plan = _plan(*FC1)
    assert plan["path"] == "split_k"
    assert plan["blocks"] >= 132 and plan["splits"] > 1
    assert plan["ktiles"] % plan["splits"]   # a ragged split is exercised
    assert plan["pitch_a"] == plan["pitch_b"] == 0   # no copy of 411 MB
    assert plan["workspace_floats"] == plan["splits"] * 32 * 4096


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("trans", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["nn", "tn", "nt", "tt"])
@pytest.mark.parametrize("size", [3001, 2048, 1023])
def test_plan_tma_sees_only_padded_planes(size, trans, dtype):
    plan = _plan(size, size, size, dtype=dtype, trans_a=trans[0],
                 trans_b=trans[1], a_ptr=8, b_ptr=4)
    assert plan["path"] == "tma_wgmma"
    pitch = plan["pitch_a"]
    assert pitch == plan["pitch_b"] >= size and (pitch * 2) % 16 == 0
    planes = 2 if dtype == F32 else 1
    assert plan["plane_bytes"] == 2 * planes * 2 * size * pitch


@pytest.mark.parametrize("case", ["aligned", "pitch_3001", "trans_a",
                                  "trans_b", "odd_pointer"])
def test_plan_split_k_packs_what_16_byte_loads_cannot_take(case):
    m, k, n = (32, 3001, 4096) if case == "pitch_3001" else (32, 4096, 3000)
    plan = _plan(m, k, n, trans_a=case == "trans_a",
                 trans_b=case == "trans_b",
                 a_ptr=4 if case == "odd_pointer" else 0)
    assert plan["path"] == "split_k"
    packed_a = case in ("pitch_3001", "trans_a", "odd_pointer")
    packed_b = case == "trans_b"
    assert bool(plan["pitch_a"]) == packed_a
    assert bool(plan["pitch_b"]) == packed_b
    for pitch in (plan["pitch_a"], plan["pitch_b"]):
        assert (pitch * 4) % 16 == 0
    assert plan["plane_bytes"] == 4 * (m * plan["pitch_a"] +
                                       k * plan["pitch_b"])


@pytest.mark.parametrize("level", [1, 2])
def test_plan_levels_1_2_take_simt_with_a_transposed(level):
    plan = _plan(3001, 3001, 3001, level=level)
    assert plan["path"] == "simt" and plan["splits"] == 1
    assert plan["pitch_a"] == 3004 and plan["pitch_b"] == 3004
    plan = _plan(*FC1, level=level)
    assert plan["path"] == "simt" and plan["splits"] == 132 // 32
    assert plan["workspace_floats"] == plan["splits"] * 2 * 32 * 4096


@pytest.mark.parametrize("m,k,n,bk", [(1, 1, 1, 512), (64, 32, 48, 512),
                                      (300, 1000, 200, 100),
                                      (8, 63, 8, 128)])
def test_plan_general_for_short_k_or_odd_tile(m, k, n, bk):
    plan = _plan(m, k, n, bk=bk)
    assert plan["path"] == "general" and plan["splits"] == 1
    assert plan["plane_bytes"] == plan["workspace_floats"] == 0


def test_plan_paths_at_the_named_shapes():
    assert _plan(3001, 3001, 3001)["path"] == "tma_wgmma"
    assert _plan(3001, 3001, 3001, dtype=BF16)["path"] == "tma_wgmma"
    assert _plan(2048, 2048, 2048)["splits"] == 1
    assert _plan(1024, 1024, 1024)["splits"] == 2
    assert _plan(8, 4096, 8, bk=256)["splits"] == 16
    assert set(PATHS) == {"general", "split_k", "tma_wgmma", "simt"}


def _fold(level, acc, comp, part):
    if level == 0:
        return acc + part, comp
    if level == 1:
        y = part - comp
        t = acc + y
        return t, (t - acc) - y
    t = acc + part
    big = acc.abs() >= part.abs()
    return t, comp + torch.where(big, (acc - t) + part, (part - t) + acc)


def _split_k_emulation(a, b, level, bk, splits):
    """csrc/matmul.cu's split-K arithmetic in float32: each split folds
    its K-tiles, then the splits merge in order (comp added first)."""
    k = a.shape[1]
    ktiles = -(-k // bk)
    states = []
    for start, stop in split_ranges(ktiles, splits):
        acc = torch.zeros(a.shape[0], b.shape[1])
        comp = torch.zeros_like(acc)
        for kt in range(start, stop):
            part = a[:, kt * bk:(kt + 1) * bk] @ b[kt * bk:(kt + 1) * bk]
            acc, comp = _fold(level, acc, comp, part)
        states.append((acc, comp))
    acc, comp = states[0]
    for acc_s, comp_s in states[1:]:
        if level:
            comp = comp + comp_s
        acc, comp = _fold(level, acc, comp, acc_s)
    return acc + comp if level == 2 else acc


@pytest.mark.parametrize("splits", [1, 3, 5, 16])
def test_split_k_fold_keeps_the_ladder(splits):
    a, b = _ladder_operands()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    errs = _ladder_errors(a, b, lambda level: _split_k_emulation(
        ta, tb, level, 256, splits).numpy())
    assert errs[1] <= errs[0] * 1.001
    assert errs[2] <= errs[1] * 1.001


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("splits", [2, 7])
def test_split_k_fold_within_1e5_of_float64(level, splits):
    a, b = _operands(11, 33, 2000, 17)
    got = _split_k_emulation(torch.from_numpy(a), torch.from_numpy(b),
                             level, 128, splits)
    oracle = a.astype(numpy.float64) @ b.astype(numpy.float64)
    numpy.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    Device()   # TF32 off for the plain version's products
    return torch.device("cuda", 0)


def _max_rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() /
            want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [None, (32, 128, 128)],
                         ids=["default", "32x128x128"])
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES + [(300, 1000, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(cuda_card, shape, level,
                                           blocks):
    a, b = (torch.from_numpy(t).to(cuda_card)
            for t in _operands(sum(shape), *shape))
    before = matmul.launches
    got = matmul(a, b, precision_level=level, blocks=blocks)
    again = matmul(a, b, precision_level=level, blocks=blocks)
    want = matmul_reference(a, b, precision_level=level, blocks=blocks)
    torch.cuda.synchronize()
    assert matmul.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert _max_rel(got, want) <= 1e-5
    assert _max_rel(got, a.double() @ b.double()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_cuda_bf16_operands(cuda_card, out, level):
    a, b = (torch.from_numpy(t).to(cuda_card).to(torch.bfloat16)
            for t in _operands(5, 130, 700, 90))
    out_dtype = getattr(torch, out)
    got = matmul(a, b, precision_level=level, out_dtype=out_dtype)
    want = matmul_reference(a, b, precision_level=level,
                            out_dtype=out_dtype)
    assert got.dtype == out_dtype
    if out_dtype == torch.bfloat16:
        diff = (got.view(torch.int16).long() -
                want.view(torch.int16).long()).abs().max().item()
        assert diff <= 1
    else:
        assert _max_rel(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", [(True, False), (False, True),
                                             (True, True)])
def test_cuda_gemm_transposes_read_through_strides(cuda_card, trans_a,
                                                   trans_b):
    rng = numpy.random.RandomState(9)
    a = torch.from_numpy(rng.rand(*((70, 50) if trans_a else (50, 70))).astype(
        numpy.float32)).to(cuda_card)
    b = torch.from_numpy(rng.rand(*((33, 70) if trans_b else (70, 33))).astype(
        numpy.float32)).to(cuda_card)
    c = torch.from_numpy(rng.rand(50, 33).astype(numpy.float32)).to(
        cuda_card)
    got = gemm(a, b, c, alpha=1.0, beta=1.0, trans_a=trans_a,
               trans_b=trans_b)
    op_a = a.t() if trans_a else a
    op_b = b.t() if trans_b else b
    want = op_a.double() @ op_b.double() + c.double()
    assert _max_rel(got, want) <= 1e-5


@pytest.mark.cuda
def test_cuda_ladder_holds_on_the_card(cuda_card):
    a, b = _ladder_operands()
    ta, tb = torch.from_numpy(a).to(cuda_card), torch.from_numpy(b).to(
        cuda_card)
    errs = _ladder_errors(a, b, lambda level: matmul(
        ta, tb, precision_level=level, blocks=(8, 128, 256)).cpu().numpy())
    assert errs[1] <= errs[0] * 1.001
    assert errs[2] <= errs[1] * 1.001


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_cuda_nan_and_domain_edge(cuda_card, level):
    a = torch.ones(40, 70, device=cuda_card)
    a[1, 2] = float("nan")
    out = matmul(a, torch.ones(70, 30, device=cuda_card),
                 precision_level=level).cpu().numpy()
    assert numpy.isnan(out[1]).all()
    assert numpy.isfinite(numpy.delete(out, 1, axis=0)).all()
    big = torch.full((2, 3), 1e-3, device=cuda_card)
    big[0, 1] = 3.4e38
    out = matmul(big, torch.full((3, 2), 1e-3, device=cuda_card),
                 precision_level=level)
    want = matmul_reference(big.cpu(), torch.full((3, 2), 1e-3),
                            precision_level=level)
    assert torch.equal(torch.isfinite(out.cpu()), torch.isfinite(want))


@pytest.mark.cuda
def test_cuda_power_rating(cuda_card):
    assert benchmark.estimate_computing_power(size=256, repeats=1) > 0
    assert Device().computing_power > 0


NAMED = {"fc1": FC1, "3001": (3001, 3001, 3001), "2048": (2048, 2048, 2048)}


def _card_operands(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m, k, n = shape
    return (torch.rand(m, k, generator=gen, device="cuda").to(dtype),
            torch.rand(k, n, generator=gen, device="cuda").to(dtype))


def _expect_path(a, b, level, blocks=None):
    from veles_tpu_torch.ops.common import sm_count
    bk = min((blocks or (512, 512, 512))[2], -(-a.shape[1] // 128) * 128)
    return plan_matmul(a.shape[0], a.shape[1], b.shape[1], bk, level,
                       a.dtype, a.stride(), b.stride(), a.data_ptr(),
                       b.data_ptr(), sm_count(a.device))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32-0", "f32-1", "f32-2", "bf16-0"])
@pytest.mark.parametrize("name", list(NAMED))
def test_cuda_every_path_at_the_named_shapes(cuda_card, name, variant):
    """fc1 (split-K, 49 K-tiles over 12 splits), 3001^3 and 2048^3:
    kernel vs plain version vs float64, the same bits twice, on the
    design the planner names."""
    dtype, level = (F32 if variant.startswith("f32") else BF16,
                    int(variant[-1]))
    a, b = _card_operands(NAMED[name], dtype, 3)
    plan = _expect_path(a, b, level)
    before = dict(matmul.paths)
    got = matmul(a, b, precision_level=level, out_dtype=F32)
    again = matmul(a, b, precision_level=level, out_dtype=F32)
    want = matmul_reference(a, b, precision_level=level, out_dtype=F32)
    torch.cuda.synchronize()
    assert matmul.paths[plan["path"]] == before[plan["path"]] + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert _max_rel(got, want) <= 1e-5
    assert _max_rel(got, a.double() @ b.double()) <= 1e-5
    if dtype == BF16:
        low = matmul(a, b, precision_level=level)
        exact = a.double() @ b.double()
        assert ((low.double() - exact).abs() / exact.abs()).max() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", [(True, False), (False, True),
                                             (True, True)])
@pytest.mark.parametrize("path,shape,level", [
    ("split_k", (32, 1000, 300), 0), ("tma_wgmma", (300, 1000, 200), 0),
    ("simt", (300, 1000, 200), 1), ("general", (300, 50, 200), 0)])
def test_cuda_gemm_transposes_on_every_path(cuda_card, path, shape, level,
                                            trans_a, trans_b):
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = torch.rand(*((k, m) if trans_a else (m, k)), generator=gen,
                   device="cuda")
    b = torch.rand(*((n, k) if trans_b else (k, n)), generator=gen,
                   device="cuda")
    c = torch.rand(m, n, generator=gen, device="cuda")
    before = matmul.paths[path]
    got = gemm(a, b, c, alpha=1.0, beta=1.0, trans_a=trans_a,
               trans_b=trans_b, precision_level=level)
    torch.cuda.synchronize()
    assert matmul.paths[path] == before + 1
    op_a = a.t() if trans_a else a
    op_b = b.t() if trans_b else b
    assert _max_rel(got, op_a.double() @ op_b.double() + c.double()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_cuda_ladder_and_nan_rows_with_split_k(cuda_card, level):
    a, b = _ladder_operands()
    ta, tb = torch.from_numpy(a).to(cuda_card), torch.from_numpy(b).to(
        cuda_card)
    assert _expect_path(ta, tb, level, (8, 128, 256))["splits"] == 16
    errs = _ladder_errors(a, b, lambda lv: matmul(
        ta, tb, precision_level=lv, blocks=(8, 128, 256)).cpu().numpy())
    assert errs[1] <= errs[0] * 1.001 and errs[2] <= errs[1] * 1.001
    x = torch.ones(40, 1000, device=cuda_card)
    x[1, 2] = float("nan")
    y = torch.ones(1000, 30, device=cuda_card)
    assert _expect_path(x, y, level, (8, 128, 128))["splits"] == 8
    out = matmul(x, y, precision_level=level, blocks=(8, 128, 128)).cpu()
    assert torch.isnan(out[1]).all()
    assert torch.isfinite(torch.cat([out[:1], out[2:]])).all()
