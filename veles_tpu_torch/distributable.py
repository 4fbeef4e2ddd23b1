"""Pickling base of the unit graph.

Counterpart of ``veles_tpu/distributable.py``'s :class:`Pickleable`:
attributes whose name ends with ``_`` are transient and excluded from
pickles; ``init_unpickled`` re-creates them after load.  The
master-slave data-exchange contract (``Distributable``) is not ported.
"""

from veles_tpu_torch.logger import Logger

__all__ = ["Pickleable"]


class Pickleable(Logger):
    """Base class with transient-attribute pickling rules."""

    def __init__(self, **kwargs):
        super(Pickleable, self).__init__(**kwargs)
        self.init_unpickled()

    def init_unpickled(self):
        """(Re)create transient state. Called from ``__init__`` and after
        unpickling. Subclasses must call ``super().init_unpickled()``."""
        parent = super(Pickleable, self)
        if hasattr(parent, "init_unpickled"):
            parent.init_unpickled()

    def __getstate__(self):
        return {key: value for key, value in self.__dict__.items()
                if not key.endswith("_")}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.init_unpickled()
