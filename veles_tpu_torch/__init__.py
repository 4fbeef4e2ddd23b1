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
transformer, the unit graph (units, workflows, loaders,
``StandardWorkflow`` per unit and fused, the service units), and the
session layer: snapshots with manifests, restore and resume
(``snapshotter``, ``workflow.restore_workflow``), numerics health and
divergence rollback (``health``, ``chaos``), the inference package
export (``package``), and the command line (``cmdline``, ``launcher``,
``__main__``): ``python -m veles_tpu_torch <workflow.py> <config|->``.
Entry points run on CUDA unless the caller asks for the CPU
(``Device(backend="cpu")``, ``-d cpu``).

Quick start::

    import veles_tpu_torch
    veles_tpu_torch.run(MyWorkflow, config)   # like the CLI

Importing the package imports no submodule: ``import
veles_tpu_torch.serve.engine`` and friends load what they need.
"""

__all__ = ["run", "load_plugins"]


def run(workflow_class, config=None, **kwargs):
    """Programmatic entry point: build ``workflow_class`` under a
    launcher, initialize it (on the card unless ``device="cpu"``) and
    run it; returns the workflow."""
    from veles_tpu_torch.__main__ import Main
    return Main().run_workflow(workflow_class, config, **kwargs)


def load_plugins(paths=None):
    """Plugin discovery is not ported (ROADMAP.md Queue 1 item 12.4)."""
    raise NotImplementedError(
        "plugin discovery is not ported to veles_tpu_torch yet (ROADMAP.md "
        "Queue 1 item 12.4)")


def _make_module_callable():
    """``import veles_tpu_torch; veles_tpu_torch(MyWorkflow, config)``."""
    import sys
    import types

    mod = sys.modules[__name__]

    class _CallableModule(types.ModuleType):
        def __call__(self, workflow_class, config=None, **kwargs):
            return run(workflow_class, config, **kwargs)

    mod.__class__ = _CallableModule


_make_module_callable()
