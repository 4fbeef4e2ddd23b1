"""GEMM facade over :func:`veles_tpu_torch.ops.matmul.matmul`.

Counterpart of ``veles_tpu/ops/blas.py``: ``alpha * op(a) @ op(b) +
beta * c`` with transpose flags.  A transpose is a view with swapped
strides, which the matmul kernel reads as it is: no copy of the operand
is made.  The product is computed in float32 at ``precision_level``
(level 0, the default, is the bf16x3 decomposition for float32
operands: ~5e-7 from float64, non-finite output for |x| >= the bfloat16
maximum; level 1 takes true float32 products), scaled and added in
float32, and cast back to ``a.dtype``."""

import torch

from veles_tpu_torch.ops.matmul import matmul

__all__ = ["gemm", "veles_gemm"]


def gemm(a, b, c=None, alpha=1.0, beta=0.0, trans_a=False, trans_b=False,
         precision_level=0):
    """alpha * op(a) @ op(b) + beta * c (BLAS GEMM facade); runs where
    its operands lie, the product through the matmul kernel on the
    card."""
    if trans_a:
        a = a.t()
    if trans_b:
        b = b.t()
    out = matmul(a, b, precision_level=precision_level,
                 out_dtype=torch.float32)
    if alpha != 1.0:   # a product by 1 is exact: skip its launch
        out = alpha * out
    if c is not None:
        c = c.to(torch.float32)
        out = out + (c if beta == 1.0 else beta * c)
    return out.to(a.dtype)


#: the reference's name (veles/ocl_blas.py veles_gemm)
veles_gemm = gemm
