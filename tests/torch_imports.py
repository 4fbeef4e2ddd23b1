"""The import state a port test changes, put back.

The port's command line (``veles_tpu_torch/__main__.py``), run in the
test's process on a workflow file, puts the file's directory at
``sys.path[0]`` and imports the file under its bare name, as the JAX
package's does.  Both stay after the run: a later ``import kohonen``
then finds the port's ``veles_tpu_torch/examples/kohonen.py`` where a
reference test expects ``examples/kohonen.py``.  Tests that import the
JAX package's examples by their bare names leave the same kind of trace
in the other direction.

:func:`restored_imports` wraps such a run: afterwards ``sys.path`` is
the list it was, and every module of a bare name (no dot) that the run
imported from the repository or from a directory the run put on the
path is gone from ``sys.modules``.  Modules of packages
(``veles_tpu_torch.examples.kohonen``) and third-party modules stay.
:func:`jax_example` imports one of the JAX package's examples that way.
"""

import contextlib
import importlib
import os
import sys

__all__ = ["REPO", "JAX_EXAMPLES", "restored_imports", "jax_example"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX package's example workflows
JAX_EXAMPLES = os.path.join(REPO, "examples")


def _origin(module):
    path = getattr(module, "__file__", None)
    return os.path.abspath(path) if path else None


def _under(path, directory):
    return path == directory or path.startswith(directory + os.sep)


@contextlib.contextmanager
def restored_imports():
    """Put back ``sys.path`` and drop the bare-named modules imported
    inside (see the module docstring)."""
    path = list(sys.path)
    before = set(sys.modules)
    try:
        yield
    finally:
        added = [os.path.abspath(p) for p in sys.path if p not in path]
        for name in [n for n in sys.modules if n not in before]:
            if "." in name:
                continue
            origin = _origin(sys.modules[name])
            if origin is not None and any(
                    _under(origin, d) for d in [REPO] + added):
                del sys.modules[name]
        sys.path[:] = path


#: the JAX examples jax_example imported, each once (an example installs
#: its config defaults when it is imported)
_JAX_EXAMPLES = {}


def jax_example(name):
    """The JAX package's ``examples/<name>.py``, imported once, without
    leaving ``examples/`` on the path or ``<name>`` in ``sys.modules``."""
    cached = _JAX_EXAMPLES.get(name) or sys.modules.get(name)
    if cached is not None and _origin(cached) == os.path.join(
            JAX_EXAMPLES, name + ".py"):
        return cached
    with restored_imports():
        sys.modules.pop(name, None)
        sys.path.insert(0, JAX_EXAMPLES)
        module = importlib.import_module(name)
    if _origin(module) != os.path.join(JAX_EXAMPLES, name + ".py"):
        raise ImportError("%s resolved to %s, not the JAX package's "
                          "example" % (name, _origin(module)))
    _JAX_EXAMPLES[name] = module
    return module
