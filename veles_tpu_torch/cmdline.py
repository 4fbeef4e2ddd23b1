"""Command-line argument registry.

Counterpart of ``veles_tpu/cmdline.py``: any class whose metaclass is
:class:`CommandLineArgumentsRegistry` (or that subclasses
:class:`CommandLineBase`, or a unit defining the hooks) may define a
classmethod ``init_parser(parser)`` adding its own flags;
:func:`build_parser` folds every registered class's flags into one
parser for the CLI.  A contributor may also define a classmethod
``apply_args(args)``: :func:`apply_parsed_args` fans the parsed
namespace back out so each class installs its settings, usually into
the ``root`` config tree its constructor reads.  The port's
contributors are the launcher (``-l``, ``-m``, ``--resume``, the
telemetry flags), the snapshotter (``--snapshot-*``,
``--rollback-budget``, ``--publish-*``), the Server (``--job-timeout``,
``--codec``, ``--no-shm``, ``--blacklist-ttl``,
``--speculation-factor``, ``--min-speculation-s``) and the Client
(``--async-slave``, ``--reconnect-limit``, ``--death-probability``).
"""

import argparse

__all__ = ["CommandLineArgumentsRegistry", "CommandLineBase",
           "build_parser", "apply_parsed_args"]


class CommandLineArgumentsRegistry(type):
    """Metaclass collecting classes that contribute CLI arguments."""

    classes = []

    def __init__(cls, name, bases, namespace):
        super(CommandLineArgumentsRegistry, cls).__init__(
            name, bases, namespace)
        if "init_parser" in namespace or "apply_args" in namespace:
            CommandLineArgumentsRegistry.classes.append(cls)


class CommandLineBase(object, metaclass=CommandLineArgumentsRegistry):
    """Convenience base for classes contributing CLI arguments."""

    @classmethod
    def init_parser(cls, parser):
        return parser


def _import_standard_contributors():
    """Registration happens at class creation: import the modules that
    contribute flags, so the CLI is complete whatever the workflow file
    imports."""
    import veles_tpu_torch.client  # noqa: F401
    import veles_tpu_torch.launcher  # noqa: F401
    import veles_tpu_torch.server  # noqa: F401
    import veles_tpu_torch.snapshotter  # noqa: F401


def build_parser(**kwargs):
    """Build one parser from every registered contributor."""
    _import_standard_contributors()
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="veles_tpu_torch: the PyTorch/CUDA port of VELES-TPU",
        **kwargs)
    seen = set()
    for cls in CommandLineArgumentsRegistry.classes:
        init = cls.__dict__.get("init_parser")
        if init is None or init in seen:
            continue
        seen.add(init)
        init.__get__(None, cls)(parser)
    return parser


def apply_parsed_args(args):
    """Fan the parsed namespace back out to every contributor that
    defines ``apply_args`` (constructors then read the settings from
    the config tree)."""
    seen = set()
    for cls in CommandLineArgumentsRegistry.classes:
        apply = cls.__dict__.get("apply_args")
        if apply is None or apply in seen:
            continue
        seen.add(apply)
        apply.__get__(None, cls)(args)
