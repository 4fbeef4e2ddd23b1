"""Flash attention: the online-softmax forward and its two backward
kernels.

Counterpart of ``veles_tpu/ops/attention.py``.  Three functions over
(B, T, dh) operands (B = batch x heads), each a hand-written Hopper
kernel beside its plain PyTorch version:

- :func:`attention_fwd` -> (out, lse): ``out = softmax(q k^T * scale) v``
  and the row logsumexp ``lse = m + log(l)``, (B, T) f32.  The kernel
  ``veles_tpu_torch/csrc/attention_fwd.cu`` replaces the Pallas
  ``_fwd_kernel``;
- :func:`attention_dq` -> dq and :func:`attention_dkv` -> (dk, dv): the
  backward from the saved lse (p recomputed, never stored),
  ``ds = p * (dp - delta) * scale``.  ``veles_tpu_torch/csrc/
  attention_bwd.cu`` replaces ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``.

On CUDA tensors each wrapper launches its kernel and adds one to its
``launches`` counter; on CPU tensors it runs the plain version
(``*_reference``).  Nothing falls back: a CUDA call builds and launches
the kernel or raises.  Each kernel has two designs, picked by the
precision level (:func:`plan_attention`, the rule of all three) and
counted in ``attention_fwd.paths``, ``attention_dq.paths`` and
``attention_dkv.paths``: ``tc_bf16x3`` (level 0, wgmma on the tensor
cores) and ``simt`` (levels 1 and 2, true-f32 FMAs).

Semantics kept from the TPU kernels: the score is ``dot(q, k) * scale``;
key columns past T in a kernel's last tile take the finite floor
``-1e30`` (never -inf), so their probabilities are exact zeros and so
are their gradients.  The kernels pad nothing in memory: they read
exactly T rows of dh columns and write rows below T only.

:func:`flash_attention` is the entry the transformer calls: a
``torch.autograd.Function`` whose forward saves (q, k, v, out, lse), as
the JAX custom VJP keeps its residuals, and whose backward computes
``delta = rowsum(do * out)`` in f32 as plain tensor code and then
launches the dq and the dk/dv kernels.  :func:`attention_reference` is
plain softmax attention under stock autograd, the parity oracle.

Numerics, the JAX ladder (``mxu_partial_dot``); the attention has no
compensated accumulation, so the levels change only the products.  At
level 0 the three kernels take the TPU kernels' bf16x3 products: each
f32 operand, the f32 intermediates p and ds among them, splits into
``hi = bf16_rn(x)`` and ``lo = bf16_rn(x - hi)``, and each product is
``hi hi + hi lo + lo hi``; a bf16 operand's lo is zero, so a bf16
``q k^T`` is one bf16 product and a bf16 ``p v`` is ``p_hi v + p_lo
v``.  |x| at or above the bfloat16 maximum gives non-finite results, as
the JAX level 0 does.  Levels 1 and 2 take true-f32 products.  The
outputs take the operands' dtype.  The plain versions compute in the
wider of the operands' dtype and float32; float64 operands bypass the
split.  On float32 their output products (p v, ds k, ds^T q, p^T do)
are ``ops.matmul._partial_dot`` at the level.

The score products are summed differently forward and backward, each
chosen by measurement.  The backward's level-0 score products (q k^T,
do v^T) sum the three bf16 products exactly (in float64) and round
once: p and ds come from the scores and are split again, and the bf16
rounding of their lo turns a last-bit difference into a step of 2^-17
of the value, so a float32 sum in one order or another moves dq, dk and
dv by ~1e-5 (``_partial_dot``'s float32 sums sit up to 1.2e-5 from the
exact ones at the transformer's (512, 128, 64) on an H100).  The
kernels' tensor-core sums keep the cross terms apart and sum the hi.hi
steps with TwoSum (``csrc/attention_tc.cuh`` ``score_tile``): against
these plain versions they read 0.1e-6 to 7.8e-6 in dq, dk and dv over 19
shapes (dh 8 to 128, T 37 to 1,024) on an H100, where sums rounded to
nearest every k16 step read up to 12.3e-6 (dk at (3, 300, 128)).
The forward's level-0 q k^T is ``_partial_dot``'s float32 sum, as
JAX's: against JAX's level-0 ``_flash_fwd_jit`` on one (256, 256) tile
the whole-row plain forward reads 1.1e-7 to 2.0e-6 (max-abs error over
max-abs, 8 shapes up to (4, 128, 64)) with float32 sums and 4.6e-7 to
2.5e-6 with exact ones.  Its out carries no second split: the kernel,
whose 64-key tiles split p at the running max where the plain row
splits it at the row max, sits 0.5e-6 to 3.9e-6 from it in out and
below 1.6e-7 in lse (18 shapes on an H100).
"""

import ctypes
import math

import torch

from veles_tpu_torch import graphs
from veles_tpu_torch.ops import common as _common
from veles_tpu_torch.ops.matmul import _partial_dot

__all__ = ["flash_attention", "attention_reference", "attention_fwd",
           "attention_fwd_reference", "attention_dq",
           "attention_dq_reference", "attention_dkv",
           "attention_dkv_reference", "plan_attention", "DEFAULT_BLOCKS",
           "MAX_HEAD_DIM", "PATHS"]

#: the kernels' (bq, bk) tile (csrc/attention.cuh)
DEFAULT_BLOCKS = (64, 64)
#: the widest head the kernels take
MAX_HEAD_DIM = 128

#: dtype codes of csrc/attention_*.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' designs, by their codes in csrc/attention_tc.cuh
PATHS = ("simt", "tc_bf16x3")


def plan_attention(precision_level):
    """The attention kernels' design for a level, the forward's and the
    backward's: ``tc_bf16x3`` (the TPU kernels' bf16x3 products on the
    tensor cores) at level 0, ``simt`` (true-f32 FMAs) at levels 1 and
    2.  Both take f32 and bf16 operands."""
    _check_level(precision_level)
    return "tc_bf16x3" if precision_level == 0 else "simt"


# -- checks ------------------------------------------------------------------


def _check(name, q, k, v, blocks, extra=()):
    """Shape, device and layout checks shared by the three wrappers."""
    tensors = (q, k, v) + tuple(extra)
    if q.ndim != 3 or any(tuple(t.shape) != tuple(q.shape) for t in
                          tensors):
        raise ValueError("%s expects matching (B, T, dh) operands, got %s"
                         % (name, [tuple(t.shape) for t in tensors]))
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError("%s takes dh <= %d, got %d" % (
            name, MAX_HEAD_DIM, q.shape[-1]))
    if any(t.device != q.device for t in tensors):
        raise ValueError("%s: operands on different devices: %s" % (
            name, [str(t.device) for t in tensors]))
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError("%s: operands of different dtypes: %s" % (
            name, [str(t.dtype) for t in tensors]))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("%s expects contiguous operands" % name)
    if blocks is not None and tuple(blocks) != DEFAULT_BLOCKS:
        raise ValueError("%s: blocks %s is not the kernel tile %s"
                         % (name, tuple(blocks), DEFAULT_BLOCKS))


def _check_rows(name, q, *rows):
    """lse / delta: (B, T) float32 on q's device, contiguous."""
    for row in rows:
        if tuple(row.shape) != tuple(q.shape[:2]) or \
                row.device != q.device or not row.is_contiguous():
            raise ValueError("%s expects contiguous (B, T) rows on %s, got "
                             "%s on %s" % (name, q.device,
                                           tuple(row.shape), row.device))
        if q.device.type == "cuda" and row.dtype != torch.float32:
            raise TypeError("%s: lse and delta must be float32, got %s"
                            % (name, row.dtype))


def _route(name, q):
    """True for the kernel, False for the plain version; raises on any
    other device or on a dtype the kernel does not take."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError("%s runs on CUDA or CPU tensors, got %s" % (
            name, q.device))
    if q.dtype not in _CODES:
        raise TypeError("the %s kernel takes float32 or bfloat16 operands, "
                        "got %s" % (name, q.dtype))
    return True


# -- plain versions ----------------------------------------------------------


def _compute_dtype(q):
    return torch.promote_types(q.dtype, torch.float32)


def _dot(cd, precision_level):
    """The product step of the plain versions in the compute dtype
    ``cd``: the level's ``_partial_dot`` on float32 (bf16x3 at level 0),
    ``torch.matmul`` on float64."""
    if cd == torch.float32:
        return lambda a, b: _partial_dot(a, b, precision_level)
    return torch.matmul


def _exact_bf16x3(a, b):
    """The level-0 product of float32 ``a @ b`` (bf16 hi/lo splits, hi hi
    + hi lo + lo hi) summed in float64, where the products of bf16
    values are exact, and rounded to float32 once."""
    def split(x):
        hi = x.to(torch.bfloat16).to(torch.float32)
        return hi.double(), (x - hi).to(torch.bfloat16).double()
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return (a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi).to(torch.float32)


def _score_dot(cd, precision_level):
    """The plain backward's score product (q k^T, do v^T): exact bf16x3
    at level 0 on float32, else the level's product."""
    if cd == torch.float32 and precision_level == 0:
        return _exact_bf16x3
    return _dot(cd, precision_level)


def _scores(q, k, scale, dot):
    """s = dot(q, k) * scale in the compute dtype."""
    cd = _compute_dtype(q)
    return dot(q.to(cd), k.to(cd).transpose(1, 2)) * scale


def attention_fwd_reference(q, k, v, scale, blocks=None, precision_level=0):
    """The plain version of :func:`attention_fwd`: softmax over whole
    rows, (out in q.dtype, lse (B, T) in the compute dtype), both
    products at the level (bf16x3 at level 0 on float32, summed in
    float32)."""
    del blocks
    _check("attention_fwd", q, k, v, None)
    _check_level(precision_level)
    dot = _dot(_compute_dtype(q), precision_level)
    s = _scores(q, k, scale, dot)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = dot(p, v.to(s.dtype)) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, scale, dot):
    """(p, ds) of the backward: p from the saved lse,
    ds = p * (dp - delta) * scale, the scores through ``dot``."""
    s = _scores(q, k, scale, dot)
    cd = s.dtype
    p = torch.exp(s - lse[..., None].to(cd))
    dp = dot(do.to(cd), v.to(cd).transpose(1, 2))
    ds = p * (dp - delta[..., None].to(cd)) * scale
    return p, ds


def attention_dq_reference(q, k, v, do, lse, delta, scale, blocks=None,
                           precision_level=0):
    """The plain version of :func:`attention_dq`: dq = ds @ k, each
    product at the level (bf16x3 at level 0 on float32)."""
    del blocks
    _check("attention_dq", q, k, v, None, (do,))
    _check_level(precision_level)
    cd = _compute_dtype(q)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale,
                          _score_dot(cd, precision_level))
    return _dot(cd, precision_level)(ds, k.to(cd)).to(q.dtype)


def attention_dkv_reference(q, k, v, do, lse, delta, scale, blocks=None,
                            precision_level=0):
    """The plain version of :func:`attention_dkv`: dk = ds^T @ q,
    dv = p^T @ do, each product at the level."""
    del blocks
    _check("attention_dkv", q, k, v, None, (do,))
    _check_level(precision_level)
    cd = _compute_dtype(q)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale,
                          _score_dot(cd, precision_level))
    dot = _dot(cd, precision_level)
    dv = dot(p.transpose(1, 2), do.to(cd))
    dk = dot(ds.transpose(1, 2), q.to(cd))
    return dk.to(q.dtype), dv.to(q.dtype)


# -- the kernels -------------------------------------------------------------


def _fn(holder, name, n_ptrs, lead=()):
    """The C entry point ``name``: n_ptrs pointers, the ``lead`` ctypes
    (the forward's grid), then b, t, dh, the dtype code, the scale, the
    design code, the device and the stream."""
    from veles_tpu_torch.ops.common import kernel_function
    if holder.fn is None:
        holder.fn = kernel_function(
            name, [ctypes.c_void_p] * n_ptrs + list(lead) +
            [ctypes.c_longlong] * 3 +
            [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p])
    return holder.fn


def _call(fn, name, tensors, q, scale, path, lead=()):
    from veles_tpu_torch.ops.common import check_launch, current_stream
    b, t, dh = q.shape
    code = fn(*[x.data_ptr() for x in tensors], *lead, b, t, dh,
              _CODES[q.dtype], float(scale), PATHS.index(path),
              q.device.index, current_stream(q.device))
    check_launch(code, name)


def _launch_fwd(q, k, v, scale, precision_level=0, schedule=None):
    fn = _fn(_launch_fwd, "veles_attention_fwd", 5, (ctypes.c_int,))
    path = plan_attention(precision_level)
    grid = 0 if schedule is None else schedule["grid"]
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _call(fn, "attention_fwd", (q, k, v, out, lse), q, scale, path,
          (grid,))
    attention_fwd.launches += 1
    attention_fwd.paths[path] += 1
    plan = {"path": path, "grid": grid, "schedule": schedule}
    attention_fwd.last_plan = plan
    _common.note_plan("attention", plan)
    return out, lse


def tuned_schedule(q, precision_level):
    """The schedule cache's validated ``{"grid"}`` for one forward call,
    or None (the static plan: the resident count).  Host-only and
    memoized (``tune.cache.consult``); at levels 1 and 2 the forward
    has no free launch parameter and every entry misses."""
    b, t, dh = (int(v) for v in q.shape)
    if not (b and t):
        return None
    dtype = str(q.dtype)[6:]
    from veles_tpu_torch.tune import cache, spec
    return cache.consult(
        "attention", (b, t, dh, dtype, precision_level), q.device,
        lambda: spec.attention_spec(b, t, dh, dtype, precision_level))


def _launch_dq(q, k, v, do, lse, delta, scale, precision_level=0):
    fn = _fn(_launch_dq, "veles_attention_dq", 7)
    path = plan_attention(precision_level)
    dq = torch.empty_like(q)
    _call(fn, "attention_dq", (q, k, v, do, lse, delta, dq), q, scale,
          path)
    attention_dq.launches += 1
    attention_dq.paths[path] += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, scale, precision_level=0):
    fn = _fn(_launch_dkv, "veles_attention_dkv", 8)
    path = plan_attention(precision_level)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call(fn, "attention_dkv", (q, k, v, do, lse, delta, dk, dv), q,
          scale, path)
    attention_dkv.launches += 1
    attention_dkv.paths[path] += 1
    return dk, dv


_launch_fwd.fn = _launch_dq.fn = _launch_dkv.fn = None


def attention_fwd(q, k, v, scale, blocks=None, precision_level=0,
                  schedule=None):
    """(out (B, T, dh) in q.dtype, lse (B, T) f32) of softmax attention
    over contiguous (B, T, dh) operands, dh <= 128.  ``blocks``: the
    kernel's (bq, bk) tile, None or :data:`DEFAULT_BLOCKS`.

    ``blocks=None`` (and no ``schedule``) consults the schedule cache
    (family ``attention``) for the level-0 design's persistent block
    count, before the call branches on the device; an explicit
    ``blocks`` or ``schedule`` (``{"grid"}``) skips the consult.  Each
    item is computed by one block, so a schedule never changes a result.

    A CUDA call launches ``csrc/attention_fwd.cu`` in the design
    :func:`plan_attention` picks for ``precision_level`` and adds one to
    ``attention_fwd.launches`` and to ``attention_fwd.paths[design]``; a
    CPU call runs :func:`attention_fwd_reference` at the same level."""
    _check("attention_fwd", q, k, v, blocks)
    _check_level(precision_level)
    if schedule is None and blocks is None:
        schedule = tuned_schedule(q, precision_level)
    if not _route("attention_fwd", q):
        return attention_fwd_reference(q, k, v, scale,
                                       precision_level=precision_level)
    return _launch_fwd(q, k, v, scale, precision_level, schedule)


def attention_dq(q, k, v, do, lse, delta, scale, blocks=None,
                 precision_level=0):
    """dq (q's shape and dtype) from the cotangent ``do`` of the output,
    the forward's ``lse`` and ``delta = rowsum(do * out)``, both (B, T)
    f32.  A CUDA call launches the dq kernel of ``csrc/attention_bwd.cu``
    in the design :func:`plan_attention` picks for ``precision_level``
    and adds one to ``attention_dq.launches`` and to
    ``attention_dq.paths[design]``; a CPU call runs
    :func:`attention_dq_reference` at the same level."""
    _check("attention_dq", q, k, v, blocks, (do,))
    _check_rows("attention_dq", q, lse, delta)
    _check_level(precision_level)
    if not _route("attention_dq", q):
        return attention_dq_reference(q, k, v, do, lse, delta, scale,
                                      precision_level=precision_level)
    return _launch_dq(q, k, v, do, lse, delta, scale, precision_level)


def attention_dkv(q, k, v, do, lse, delta, scale, blocks=None,
                  precision_level=0):
    """(dk, dv), as :func:`attention_dq` takes its operands.  A CUDA
    call launches the dk/dv kernel of ``csrc/attention_bwd.cu`` in the
    design :func:`plan_attention` picks and adds one to
    ``attention_dkv.launches`` and to ``attention_dkv.paths[design]``;
    a CPU call runs :func:`attention_dkv_reference` at the same level."""
    _check("attention_dkv", q, k, v, blocks, (do,))
    _check_rows("attention_dkv", q, lse, delta)
    _check_level(precision_level)
    if not _route("attention_dkv", q):
        return attention_dkv_reference(q, k, v, do, lse, delta, scale,
                                       precision_level=precision_level)
    return _launch_dkv(q, k, v, do, lse, delta, scale, precision_level)


#: kernel launches since the last reset, in all and by design (plain
#: counters: the smoke run zeroes them before driving a path and reads
#: them after)
attention_fwd.launches = 0
attention_dq.launches = 0
attention_dkv.launches = 0
attention_fwd.paths = dict.fromkeys(PATHS, 0)
attention_dq.paths = dict.fromkeys(PATHS, 0)
attention_dkv.paths = dict.fromkeys(PATHS, 0)
#: the plan of the forward's last launch (its ``schedule`` None under
#: the rule); the backward kernels launch one block an item and take no
#: schedule
attention_fwd.last_plan = None
#: a captured graph's replays advance the counters too
graphs.register_counters(attention_fwd, attention_dq, attention_dkv)


def _check_level(precision_level):
    if precision_level not in (0, 1, 2):
        raise ValueError("precision_level must be 0, 1 or 2, got %r"
                         % (precision_level,))


# -- the autograd entry ------------------------------------------------------


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale, precision_level, blocks):
        out, lse = attention_fwd(q, k, v, scale, blocks,
                                 precision_level=precision_level)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.config = (scale, precision_level, blocks)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, precision_level, blocks = ctx.config
        do = do.to(q.dtype).contiguous()
        # the standard flash-backward precompute, one elementwise pass
        # outside the kernels as on the TPU
        cd = _compute_dtype(q)
        delta = torch.sum(do.to(cd) * out.to(cd), dim=-1)
        dq = attention_dq(q, k, v, do, lse, delta, scale, blocks,
                          precision_level=precision_level)
        dk, dv = attention_dkv(q, k, v, do, lse, delta, scale, blocks,
                               precision_level=precision_level)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, scale=None, precision_level=0, blocks=None):
    """``softmax(q @ k^T * scale) @ v`` over (B, T, dh) operands (B =
    batch x heads; the model layer folds the heads in), with the
    hand-written backward attached.  ``scale`` defaults to
    1/sqrt(dh).

    ``blocks`` names the port's own kernel tile: None or
    :data:`DEFAULT_BLOCKS`, the one tile the kernels are built for.
    ``blocks=None`` lets the forward consult the schedule cache for its
    persistent block count (:func:`attention_fwd`); an explicit tile
    skips the consult, as in the JAX package.
    Where no operand needs a gradient (inference) this is the forward
    kernel alone.  The wrappers check the operands.  With
    ``ops.common.DEBUG_NONFINITE`` on, a non-finite output raises
    ``FloatingPointError`` with per-operand statistics."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    blocks = None if blocks is None else tuple(blocks)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _FlashAttention.apply(q, k, v, float(scale),
                                    int(precision_level), blocks)
    else:
        out = attention_fwd(q, k, v, float(scale), blocks,
                            precision_level=precision_level)[0]
    if _common.DEBUG_NONFINITE:
        _common.debug_check_finite(
            "flash_attention", [("output", out)],
            [("q", q), ("k", k), ("v", v)], precision_level)
    return out


def attention_reference(q, k, v, scale=None, precision_level=1):
    """Plain softmax attention in the op order of the JAX package's
    ``attention_reference``, under stock autograd: s = q k^T * scale,
    m = rowmax, p = exp(s - m), out = (p v) / rowsum(p).  Computes in
    the wider of q.dtype and float32 and returns q.dtype.  The level is
    accepted and computes the same (true-f32 products)."""
    _check_level(precision_level)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    cd = _compute_dtype(q)
    s = torch.matmul(q.to(cd), k.to(cd).transpose(1, 2)) * scale
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    return (torch.matmul(p, v.to(cd)) / l).to(q.dtype)
