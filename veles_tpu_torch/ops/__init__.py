"""Kernels written by hand for Hopper, each beside its plain PyTorch
version; counterpart of ``veles_tpu/ops``.  The CUDA sources live in
``veles_tpu_torch/csrc`` and are built on first use
(:mod:`veles_tpu_torch.ops.common`)."""
