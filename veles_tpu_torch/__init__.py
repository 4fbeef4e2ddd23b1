"""veles_tpu_torch: the PyTorch/CUDA port of ``veles_tpu``.

A second package beside the JAX one, mirroring its module paths and
public names so each module's counterpart is easy to find.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``veles_tpu``.  Every
Pallas kernel it replaces is a CUDA C++ kernel written by hand for
Hopper (``sm_90a``), built from ``veles_tpu_torch/csrc`` at first use
(:mod:`veles_tpu_torch.ops.common`).

The slice ported so far is the serving path: the model zoo, the f32
forward layers, post-training int8 quantization, the AOT batch-shape
ladder and the continuous batcher, with ``ops/matmul_int8.py`` as the
one kernel.  Entry points run on CUDA unless the caller passes
``Device(backend="cpu")``.

Importing the package imports no submodule: ``import
veles_tpu_torch.serve.engine`` and friends load what they need.
"""

__all__ = []
