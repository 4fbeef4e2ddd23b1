"""Host/device tensor abstraction.

Counterpart of ``veles_tpu/memory.py``: an :class:`Array` holds a host
numpy buffer ``mem`` and a torch tensor ``devmem`` on a
:class:`~veles_tpu_torch.backends.Device`, kept coherent by the
``map_read / map_write / map_invalidate / unmap`` protocol:

==================  =====================================================
call                meaning
==================  =====================================================
``map_read``        make ``mem`` reflect the device (a copy to the host,
                    which waits for the card, when the device is newer)
``map_write``       like map_read, then mark the host copy dirty
``map_invalidate``  mark the host dirty WITHOUT reading the device back
``unmap``           if the host is dirty, upload ``mem``; ``devmem``
                    becomes the fresh tensor
==================  =====================================================

``set_device_array`` adopts a tensor a device computation produced,
with no host round trip.  The port never updates a ``devmem`` in place:
every unit hands the Array a NEW tensor, so a tensor two Arrays share
(an ``Avatar`` clone, a linked attribute) never changes under either.
Host reads copy (``map_read`` never aliases the tensor's memory, even on
the CPU), so writing ``mem`` never reaches a tensor either.

Not ported: the ping-pong staging buffers of the input pipeline.
"""

import threading

import numpy
import torch

from veles_tpu_torch.distributable import Pickleable

__all__ = ["Array", "Watcher", "numpy_dtype"]


#: the host dtype of a device tensor's copy; numpy has no bfloat16, so
#: a bf16 tensor reads back widened to float32 (exactly)
_HOST_DTYPES = {
    torch.float32: numpy.float32, torch.float64: numpy.float64,
    torch.float16: numpy.float16, torch.bfloat16: numpy.float32,
    torch.int64: numpy.int64, torch.int32: numpy.int32,
    torch.int16: numpy.int16, torch.int8: numpy.int8,
    torch.uint8: numpy.uint8, torch.bool: numpy.bool_,
}


def numpy_dtype(torch_dtype):
    """The numpy dtype an Array's host copy of a ``torch_dtype`` tensor
    takes."""
    return numpy.dtype(_HOST_DTYPES[torch_dtype])


class Watcher(object):
    """Tracks bytes resident on devices across all Arrays."""

    _lock = threading.Lock()
    bytes_on_device = 0
    arrays_on_device = 0

    @classmethod
    def add(cls, nbytes):
        with cls._lock:
            cls.bytes_on_device += nbytes
            cls.arrays_on_device += 1

    @classmethod
    def remove(cls, nbytes):
        with cls._lock:
            cls.bytes_on_device -= nbytes
            cls.arrays_on_device -= 1


# coherence states
_HOST_ONLY = 0      # no device buffer
_IN_SYNC = 1        # host == device
_HOST_DIRTY = 2     # host newer than device
_DEVICE_DIRTY = 3   # device newer than host


class Array(Pickleable):
    """A named tensor with a host numpy buffer and an optional device
    tensor, synchronised through the map/unmap protocol."""

    def __init__(self, data=None, shallow_pickle=False):
        super(Array, self).__init__()
        self._mem = None
        self.shallow_pickle = shallow_pickle
        if data is not None:
            self.mem = data

    def init_unpickled(self):
        super(Array, self).init_unpickled()
        self._device_ = None
        self._devmem_ = None
        self._state_ = _HOST_ONLY
        self._lock_ = threading.RLock()
        self._watched_nbytes_ = 0

    # -- basic container behaviour ----------------------------------------

    @property
    def mem(self):
        return self._mem

    @mem.setter
    def mem(self, value):
        if value is None:
            self.reset()
            return
        self._mem = numpy.ascontiguousarray(value)
        if self._device_ is not None:
            self._state_ = _HOST_DIRTY

    @property
    def devmem(self):
        """Current device tensor, pushing host changes first."""
        self.unmap()
        return self._devmem_

    def device_array(self, device):
        """devmem, first attaching ``device`` when the Array is still
        host-only (an Array a user filled by hand)."""
        with self._lock_:
            if self._device_ is None and device is not None \
                    and device.exists and self._mem is not None:
                self._device_ = device
                self._state_ = _HOST_DIRTY
        return self.devmem

    def __bool__(self):
        return self._mem is not None and self._mem.size > 0

    def __len__(self):
        return 0 if self._mem is None else len(self._mem)

    def __getitem__(self, key):
        self.map_read()
        return self._mem[key]

    def __setitem__(self, key, value):
        self.map_write()
        self._mem[key] = value

    @property
    def shape(self):
        return None if self._mem is None else self._mem.shape

    @property
    def size(self):
        return 0 if self._mem is None else self._mem.size

    @property
    def dtype(self):
        return None if self._mem is None else self._mem.dtype

    @property
    def nbytes(self):
        return 0 if self._mem is None else self._mem.nbytes

    @property
    def sample_size(self):
        """Elements per sample (all dims but the first)."""
        if self._mem is None or self._mem.ndim == 0:
            return 0
        return self._mem.size // self._mem.shape[0]

    # -- device lifecycle --------------------------------------------------

    @property
    def device(self):
        return self._device_

    def initialize(self, device):
        """Attach to ``device``; the first ``unmap`` uploads the data."""
        with self._lock_:
            if device is None or not device.exists:
                self._device_ = None
                self._state_ = _HOST_ONLY
                return
            if self._device_ is device and self._state_ != _HOST_ONLY:
                return
            self._device_ = device
            if self._mem is not None:
                self._state_ = _HOST_DIRTY

    def reset(self):
        with self._lock_:
            self._track_device_bytes(0)
            self._mem = None
            self._devmem_ = None
            self._state_ = _HOST_ONLY

    # -- coherence protocol ------------------------------------------------

    def map_read(self):
        with self._lock_:
            if self._state_ == _DEVICE_DIRTY:
                tensor = self._devmem_.detach()
                if tensor.dtype == torch.bfloat16:
                    tensor = tensor.float()
                self._mem = tensor.to("cpu", copy=True).numpy()
                self._state_ = _IN_SYNC

    def map_write(self):
        with self._lock_:
            self.map_read()
            if self._state_ != _HOST_ONLY:
                self._state_ = _HOST_DIRTY

    def map_invalidate(self):
        with self._lock_:
            if self._state_ != _HOST_ONLY:
                self._state_ = _HOST_DIRTY

    def unmap(self):
        with self._lock_:
            if self._state_ == _HOST_DIRTY or (
                    self._state_ == _IN_SYNC and self._devmem_ is None):
                if self._device_ is None:
                    return
                self._devmem_ = self._device_.put(self._mem)
                self._track_device_bytes(self._mem.nbytes)
                self._state_ = _IN_SYNC

    def _track_device_bytes(self, nbytes):
        """Keep Watcher in sync with exactly what this Array contributed."""
        if nbytes != self._watched_nbytes_:
            if self._watched_nbytes_:
                Watcher.remove(self._watched_nbytes_)
            if nbytes:
                Watcher.add(nbytes)
            self._watched_nbytes_ = nbytes

    def set_device_array(self, tensor, device=None):
        """Adopt a fresh device tensor (a unit's result) without a host
        round trip; the host copy becomes stale.  The tensor is kept as
        it is, not copied: its producer must not update it in place."""
        with self._lock_:
            if device is not None:
                self._device_ = device
            self._devmem_ = tensor
            self._state_ = _DEVICE_DIRTY
            shape = tuple(tensor.shape)
            host_dtype = numpy_dtype(tensor.dtype)
            if self._mem is None or self._mem.shape != shape or \
                    self._mem.dtype != host_dtype:
                # shape and dtype metadata, not materialised data
                self._mem = numpy.zeros(shape, host_dtype)
            self._track_device_bytes(tensor.numel() *
                                     tensor.element_size())

    # -- pickling ----------------------------------------------------------

    def __getstate__(self):
        self.map_read()
        state = super(Array, self).__getstate__()
        if self.shallow_pickle:
            state["_mem"] = None
            state["_shallow_shape"] = (
                None if self._mem is None
                else (self._mem.shape, self._mem.dtype.str))
        return state

    def __setstate__(self, state):
        shallow = state.pop("_shallow_shape", None)
        super(Array, self).__setstate__(state)
        if shallow is not None and self._mem is None:
            shape, dtype = shallow
            self._mem = numpy.zeros(shape, numpy.dtype(dtype))
        elif self._mem is not None and not self._mem.flags.writeable:
            # the JAX package pickles read-only host views of its device
            # arrays; the host copy here must take writes
            self._mem = numpy.array(self._mem)

    def __repr__(self):
        return "<Array shape=%s dtype=%s state=%d>" % (
            self.shape, self.dtype, self._state_)
