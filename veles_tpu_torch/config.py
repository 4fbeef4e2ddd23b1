"""Global configuration tree.

Counterpart of ``veles_tpu/config.py``: a :class:`Config` node creates
child nodes on attribute access, can be called to update leaves in bulk,
supports per-key protection against accidental overwrite, and renders
itself as a tree.  The port's :data:`root` is its own tree, holding the
one key its units read: ``root.common.engine.auto_fuse``
(``VELES_AUTO_FUSE``, default on).  A ``StandardWorkflow`` initialized
on a CUDA device then swaps its per-unit chain for the fused train step;
``False`` keeps the per-unit graph.

Site override files (``/etc``, the home directory) are not read: the
port reads and writes nothing outside its caller's arguments.
"""

import os

__all__ = ["Config", "root", "get"]


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

root.common.engine.auto_fuse = \
    os.environ.get("VELES_AUTO_FUSE", "1") != "0"
