"""Global configuration tree.

Counterpart of ``veles_tpu/config.py``: a :class:`Config` node creates
child nodes on attribute access, can be called to update leaves in bulk,
supports per-key protection against accidental overwrite, and renders
itself as a tree.  The port's :data:`root` is its own tree.  Its
defaults:

- ``root.common.engine.auto_fuse`` (``VELES_AUTO_FUSE``, default on): a
  ``StandardWorkflow`` initialized on a CUDA device swaps its per-unit
  chain for the fused train step; ``False`` keeps the per-unit graph.
- ``root.common.engine.pipeline_input`` (``VELES_PIPELINE_INPUT``,
  default on): the auto-fused train step runs with the input pipeline
  (``veles_tpu_torch/pipeline_input.py``), which serves minibatch k+1
  while step k runs; ``VELES_PIPELINE_INPUT=0`` serves in sequence.
- ``root.common.engine.backend`` (``VELES_BACKEND``, default ``cuda``):
  the device the launcher builds (``cuda``, ``cpu`` or ``numpy``; the
  CLI's ``-d`` sets it).
- ``root.common.dirs.snapshots`` (``VELES_SNAPSHOT_DIR``, default
  ``veles_tpu_torch/snapshots`` under the temporary directory) and
  ``root.common.snapshot``: ``dir`` (set by ``--snapshot-dir``; a
  ``StandardWorkflow`` snapshots itself when it is set), ``resume``
  (``--resume auto|PATH``), ``keep`` (retention, 0 = all).
- ``root.common.dirs.datasets`` (``VELES_DATA``, default
  ``veles_tpu_torch/datasets`` under the temporary directory): where
  ``veles_tpu_torch.datasets`` looks for MNIST, CIFAR-10 and STL-10.
- ``root.common.dirs.cache`` (default ``veles_tpu_torch/cache`` under
  the temporary directory): the kernel schedule cache lives in its
  ``schedule_cache`` unless ``VELES_SCHEDULE_CACHE`` names another
  directory (``veles_tpu_torch.tune``).
- ``root.common.disable.snapshotting``.
- ``root.common.web.notification_interval`` (default 1): seconds between
  the status posts of a run started with ``--web-status``.

:func:`load_site_configs` runs ``site_config.py`` from the working
directory and the file ``VELES_SITE_CONFIG`` names; the JAX package's
``/etc`` and home-directory files are not read: the port reads and
writes nothing outside its caller's arguments and working directory.
"""

import os
import runpy
import tempfile
import threading

__all__ = ["Config", "root", "get", "load_site_configs"]


class Config(object):
    """A node in the configuration tree.

    Attribute access auto-creates child ``Config`` nodes, so
    ``root.common.engine.auto_fuse = False`` just works.  Calling a node
    with a mapping (or keyword arguments) updates the subtree recursively.
    """

    def __init__(self, path):
        self.__dict__["_path_"] = path
        self.__dict__["_protected_"] = set()

    @property
    def path(self):
        return self.__dict__["_path_"]

    def __call__(self, *args, **kwargs):
        if len(args) > 1:
            raise TypeError("Config accepts at most one positional mapping")
        if args:
            self.update(args[0])
        if kwargs:
            self.update(kwargs)
        return self

    def update(self, mapping):
        """Recursively merge ``mapping`` into this subtree."""
        if isinstance(mapping, Config):
            mapping = mapping.as_dict()
        if not isinstance(mapping, dict):
            raise TypeError("Config.update requires a dict, got %s" %
                            type(mapping))
        for key, value in mapping.items():
            if isinstance(value, dict):
                node = getattr(self, key)
                if not isinstance(node, Config):
                    node = Config("%s.%s" % (self.path, key))
                    setattr(self, key, node)
                node.update(value)
            else:
                setattr(self, key, value)
        return self

    def protect(self, *names):
        """Forbid future reassignment of the given child keys."""
        self.__dict__["_protected_"].update(names)

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        node = Config("%s.%s" % (self.__dict__["_path_"], name))
        self.__dict__[name] = node
        return node

    def __setattr__(self, name, value):
        if name in self.__dict__["_protected_"]:
            raise AttributeError(
                "Config key %s.%s is protected" % (self.path, name))
        self.__dict__[name] = value

    def __contains__(self, name):
        return name in self.__dict__ and not name.endswith("_")

    def get(self, name, default=None):
        """Return the leaf value if it was explicitly set, else ``default``."""
        value = self.__dict__.get(name, default)
        if isinstance(value, Config):
            return default
        return value

    def as_dict(self):
        out = {}
        for key, value in self.__dict__.items():
            if key.endswith("_"):
                continue
            if isinstance(value, Config):
                sub = value.as_dict()
                if sub:
                    out[key] = sub
            else:
                out[key] = value
        return out

    def print_(self, indent=0, out=None):
        import sys
        out = out or sys.stdout
        for key, value in sorted(self.__dict__.items()):
            if key.endswith("_"):
                continue
            if isinstance(value, Config):
                out.write("%s%s:\n" % ("  " * indent, key))
                value.print_(indent + 1, out)
            else:
                out.write("%s%s: %r\n" % ("  " * indent, key, value))

    def __repr__(self):
        return "<Config %s: %s>" % (self.path, self.as_dict())

    def __getstate__(self):
        return {"path": self.path, "tree": self.as_dict(),
                "protected": sorted(self.__dict__["_protected_"])}

    def __setstate__(self, state):
        self.__dict__["_path_"] = state["path"]
        self.__dict__["_protected_"] = set()
        self.update(state["tree"])
        self.__dict__["_protected_"].update(state.get("protected", ()))


def get(node, default=None):
    """Return ``node`` unless it is an unset Config placeholder."""
    if isinstance(node, Config):
        return default
    return node


#: The port's configuration tree.
root = Config("root")

root.common.update({
    "dirs": {
        "snapshots": os.environ.get("VELES_SNAPSHOT_DIR") or os.path.join(
            tempfile.gettempdir(), "veles_tpu_torch", "snapshots"),
        "datasets": os.environ.get("VELES_DATA") or os.path.join(
            tempfile.gettempdir(), "veles_tpu_torch", "datasets"),
        "cache": os.path.join(tempfile.gettempdir(), "veles_tpu_torch",
                              "cache"),
    },
    "engine": {
        "auto_fuse": os.environ.get("VELES_AUTO_FUSE", "1") != "0",
        "pipeline_input": os.environ.get(
            "VELES_PIPELINE_INPUT", "1") != "0",
        "backend": os.environ.get("VELES_BACKEND") or "cuda",
    },
    "snapshot": {
        # --resume auto|PATH: restore the verified _current target (or
        # the given snapshot) before initialize; empty = fresh start
        "resume": "",
        # retention: keep only the newest N snapshots (+ best-by-metric
        # and the _current target); 0 = unlimited
        "keep": 0,
    },
    "disable": {
        "snapshotting": False,
    },
    "web": {
        # seconds between a run's status posts (--web-status)
        "notification_interval": 1,
    },
    # the graphics server also binds this EPGM multicast group where
    # the zmq build carries pgm
    "graphics": {"multicast_address": "239.192.1.1"},
})

_site_lock = threading.Lock()
_site_loaded = False


def load_site_configs():
    """Execute the site override files once per process: the file
    ``VELES_SITE_CONFIG`` names, then ``site_config.py`` in the working
    directory, each with ``root`` in its globals."""
    global _site_loaded
    with _site_lock:
        if _site_loaded:
            return
        _site_loaded = True
        for path in (os.environ.get("VELES_SITE_CONFIG"),
                     os.path.join(os.getcwd(), "site_config.py")):
            if path and os.path.exists(path):
                try:
                    runpy.run_path(path, init_globals={"root": root})
                except Exception as exc:
                    import warnings
                    warnings.warn("failed to load site config %s: %s" %
                                  (path, exc))
