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
``__main__``): ``python -m veles_tpu_torch <workflow.py> <config|->``,
with the web composer (``--frontend``) and the daemon mode (``-b``);
plugin discovery (:func:`load_plugins`); the services a trained model
leaves by: the plotters and the graphics transport, the report
publisher, the RESTful unit, the forge and the native runtime's bridge;
and the rest of the JAX package's host layers (the master-slave layer,
the job farm, observability, the web status).  What is still to port
stands in ROADMAP.md.  Entry points run on CUDA unless the caller asks
for the CPU (``Device(backend="cpu")``, ``-d cpu``).

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


#: the marker file of a port plugin package: a package marked only for
#: the JAX package (``.veles_tpu``) registers JAX units and imports jax,
#: so the port never imports it
PLUGIN_MARKER = ".veles_tpu_torch"


def load_plugins(paths=None):
    """Discover and import plugin packages: every importable top-level
    package on ``paths`` (default ``sys.path``) whose directory holds a
    ``.veles_tpu_torch`` marker file, its units registering on import.
    A plugin that fails to import is logged as a warning and skipped.
    With ``paths=None`` the scan runs once a process (memoized).
    Returns the imported modules."""
    import importlib
    import logging
    import os
    import sys

    if load_plugins._loaded is not None and paths is None:
        return load_plugins._loaded
    found = []
    for entry in (paths if paths is not None else sys.path):
        try:
            names = os.listdir(entry or ".")
        except OSError:
            continue
        for name in names:
            pkg_dir = os.path.join(entry or ".", name)
            if not os.path.exists(os.path.join(pkg_dir, PLUGIN_MARKER)):
                continue
            try:
                found.append(importlib.import_module(name))
            except Exception as exc:
                logging.getLogger("veles_tpu_torch").warning(
                    "plugin %s failed to import: %s", name, exc)
    if paths is None:
        load_plugins._loaded = found
    return found


load_plugins._loaded = None


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
