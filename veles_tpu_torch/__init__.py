"""veles_tpu_torch: the PyTorch/CUDA port of ``veles_tpu``.

A second package beside the JAX one, mirroring its module paths and
public names so each module's counterpart is easy to find.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``veles_tpu``.  Every
Pallas kernel it replaces is a CUDA C++ kernel written by hand for
Hopper (``sm_90a``), built from ``veles_tpu_torch/csrc`` at first use
(:mod:`veles_tpu_torch.ops.common`).

Ported so far: serving (the model zoo, the f32 forward layers,
post-training int8 quantization, the AOT batch-shape ladder and the
continuous batcher), the fused training step and epochs, the
transformer, and the unit graph (units, workflows, loaders,
``StandardWorkflow`` per unit and fused, the service units).  Entry
points run on CUDA unless the caller passes ``Device(backend="cpu")``.

Importing the package imports no submodule: ``import
veles_tpu_torch.serve.engine`` and friends load what they need.
"""

__all__ = []
