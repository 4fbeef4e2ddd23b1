"""Pickling base and the master-slave distribution contract.

Counterpart of ``veles_tpu/distributable.py``.

:class:`Pickleable`: attributes whose name ends with ``_`` are
transient and excluded from pickles; ``init_unpickled`` re-creates them
after load.

:class:`Distributable`: the per-unit data exchange of the master-slave
control plane (``veles_tpu_torch/server.py``, ``client.py``).  A master
hands each job's state to a slave (``generate_data_for_slave``), the
slave adopts it (``apply_data_from_master``), runs, and answers with an
update (``generate_data_for_master``) that the master merges
(``apply_data_from_slave``).  The four data hooks run under the unit's
reentrant data lock, so the Server's executor threads never interleave
a job's generation with an update's merge on one unit.  The lock is
taken by wrapping each class's own definitions of the hooks when the
class is created (the JAX package wraps them at every attribute read);
the behaviour is the same.
"""

import functools
import threading

from veles_tpu_torch.logger import Logger

__all__ = ["Pickleable", "Distributable", "TriviallyDistributable",
           "IDistributable"]

#: seconds to wait on the data lock before warning about a likely
#: deadlock
DEADLOCK_TIMEOUT = 4.0

#: the hooks that run under the data lock
_LOCKED_HOOKS = ("generate_data_for_master", "generate_data_for_slave",
                 "apply_data_from_master", "apply_data_from_slave")


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


class IDistributable(object):
    """Documentation-only interface of the distribution contract."""

    def generate_data_for_master(self):
        """Return the update payload this unit sends to the master."""

    def generate_data_for_slave(self, slave):
        """Return the job payload for ``slave`` (None: nothing to send;
        False: not ready, the requester waits at the sync point)."""

    def apply_data_from_master(self, data):
        """Consume a job payload on the slave."""

    def apply_data_from_slave(self, data, slave):
        """Merge an update payload on the master."""

    def drop_slave(self, slave):
        """Called when ``slave`` dies; requeue its pending work."""


def _locked(fn, name):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        lock = self._data_lock_
        if not lock.acquire(timeout=self.DEADLOCK_TIMEOUT):
            self.warning(
                "%s: could not take the data lock within %.0f s - "
                "possible deadlock", name, self.DEADLOCK_TIMEOUT)
            lock.acquire()
        try:
            return fn(self, *args, **kwargs)
        finally:
            lock.release()
    wrapped.__data_locked__ = True
    return wrapped


class Distributable(Pickleable):
    """Thread-safe implementation scaffold of :class:`IDistributable`:
    no-op hooks, the data lock around them, and the
    ``has_data_for_slave`` event."""

    DEADLOCK_TIMEOUT = DEADLOCK_TIMEOUT

    def __init_subclass__(cls, **kwargs):
        super(Distributable, cls).__init_subclass__(**kwargs)
        for name in _LOCKED_HOOKS:
            fn = cls.__dict__.get(name)
            if fn is not None and not getattr(fn, "__data_locked__", False):
                setattr(cls, name, _locked(fn, name))

    def __init__(self, **kwargs):
        self.negotiates_on_connect = kwargs.pop("negotiates_on_connect",
                                                False)
        super(Distributable, self).__init__(**kwargs)

    def init_unpickled(self):
        super(Distributable, self).init_unpickled()
        self._data_lock_ = threading.RLock()
        self._data_event_ = threading.Event()
        self._data_event_.set()

    @property
    def has_data_for_slave(self):
        return self._data_event_.is_set()

    @has_data_for_slave.setter
    def has_data_for_slave(self, value):
        if value:
            self._data_event_.set()
        else:
            self._data_event_.clear()

    def wait_for_data_for_slave(self, timeout=10.0):
        if not self._data_event_.wait(timeout):
            raise TimeoutError(
                "%s: no data for slave within %.0f s" %
                (type(self).__name__, timeout))

    # the default no-op contract
    def generate_data_for_master(self):
        return None

    def generate_data_for_slave(self, slave=None):
        return None

    def apply_data_from_master(self, data):
        pass

    def apply_data_from_slave(self, data, slave=None):
        pass

    def drop_slave(self, slave=None):
        pass


for _name in _LOCKED_HOOKS:
    setattr(Distributable, _name,
            _locked(Distributable.__dict__[_name], _name))
del _name


class TriviallyDistributable(Distributable):
    """The JAX package's name for the no-op contract."""
