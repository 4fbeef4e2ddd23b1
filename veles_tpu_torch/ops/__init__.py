"""Kernels written by hand for Hopper, each beside its plain PyTorch
version; counterpart of ``veles_tpu/ops``.  The CUDA sources live in
``veles_tpu_torch/csrc`` and are built on first use
(:mod:`veles_tpu_torch.ops.common`)."""

from veles_tpu_torch.ops.matmul import matmul  # noqa: F401
from veles_tpu_torch.ops.blas import gemm  # noqa: F401
from veles_tpu_torch.ops.reduce import reduce_rows, reduce_cols  # noqa: F401
