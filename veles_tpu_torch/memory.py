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

An Array on a device that does not exist (``NumpyDevice``) stays
host-only: ``initialize`` and ``device_array`` never attach it.  The
host run of a unit reads it through ``host_tensor`` (a CPU tensor
copied from ``mem``) and hands it its result through ``set_host`` (a
numpy copy into ``mem``).

``set_device_array`` adopts a tensor a device computation produced,
with no host round trip.  The port never updates a ``devmem`` in place:
every unit hands the Array a NEW tensor, so a tensor two Arrays share
(an ``Avatar`` clone, a linked attribute) never changes under either.
Host reads copy (``map_read`` never aliases the tensor's memory, even on
the CPU), so writing ``mem`` never reaches a tensor either.

Staging (the input pipeline, ``veles_tpu_torch/pipeline_input.py``):
``stage_init(nslots, pin=True)`` gives the Array ``nslots`` host buffers,
each a pinned host tensor's numpy view on the card; ``stage_begin(slot)``
points ``mem`` at one for a fill, after waiting for that slot's last
upload; ``stage_put`` uploads it with ``non_blocking=True`` on the
current stream (the pipeline's side stream) and records an event in the
slot's ``_stage_pending_``, so an upload in flight is never overwritten.
Without pinning (the CPU device, asked for explicitly) the copy is the
plain ``Device.put``.
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


#: the torch dtype of a host buffer a pinned staging slot mirrors
_TORCH_DTYPES = {numpy.dtype(host): dtype for dtype, host in
                 _HOST_DTYPES.items() if dtype != torch.bfloat16}


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
        # the staging slots (stage_init): transient, a restored Array
        # re-stages at the first pipelined serve
        self._stage_bufs_ = None
        self._stage_pinned_ = None
        self._stage_pending_ = None
        self._stage_slot_ = 0

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
        # a new buffer drops the staging slots (their shape may differ)
        self._drop_stage()
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
            self._drop_stage()

    # -- staging (the input pipeline) --------------------------------------
    #
    # Between stage_begin(slot) and the next stage_begin of the same slot
    # the slot's host buffer belongs to the pipeline's worker; consumers
    # read the minibatch through the tensor stage_put / staged_capture
    # returned, never through ``mem``.

    def _drop_stage(self):
        self._stage_bufs_ = None
        self._stage_pinned_ = None
        self._stage_pending_ = None

    @property
    def staged(self):
        return self._stage_bufs_ is not None

    @property
    def stage_slot(self):
        """The slot the last ``stage_begin`` chose (0 when unstaged)."""
        return self._stage_slot_

    def stage_init(self, nslots=2, pin=False):
        """Give the Array ``nslots`` host buffers of ``mem``'s shape and
        dtype.  ``pin=True`` (the card) makes each a pinned host tensor
        (``mem`` is its numpy view; slot 0 starts with ``mem``'s
        values), so its upload runs asynchronously; else slot 0 is
        ``mem`` itself and the rest are new arrays."""
        with self._lock_:
            if self._mem is None:
                raise ValueError("stage_init() before mem is allocated")
            if pin:
                pinned = [torch.empty(self._mem.shape,
                                      dtype=_TORCH_DTYPES[self._mem.dtype],
                                      pin_memory=True)
                          for _ in range(nslots)]
                bufs = [t.numpy() for t in pinned]
                bufs[0][...] = self._mem
            else:
                pinned = None
                bufs = [self._mem] + [numpy.empty_like(self._mem)
                                      for _ in range(nslots - 1)]
            self._stage_bufs_ = bufs
            self._stage_pinned_ = pinned
            self._stage_pending_ = [None] * nslots
            self._stage_slot_ = 0
            self._mem = bufs[0]

    def stage_begin(self, slot):
        """Point ``mem`` at ``slot``'s host buffer for a fill, after the
        slot's last upload has read it (its event; the reference's rule
        that a transfer in flight is never overwritten).  No-op when
        unstaged."""
        with self._lock_:
            if self._stage_bufs_ is None:
                return
            pending = self._stage_pending_[slot]
            self._stage_pending_[slot] = None
        if pending is not None:
            pending.synchronize()
        with self._lock_:
            if self._stage_bufs_ is None:
                return
            self._mem = self._stage_bufs_[slot]
            self._stage_slot_ = slot
            # the fill makes the host buffer the current copy; no
            # map_read may replace it with a device fetch meanwhile
            self._state_ = (_HOST_DIRTY if self._device_ is not None
                            else _HOST_ONLY)

    def stage_put(self, device):
        """Upload the current host buffer to ``device`` and return the
        tensor at once.  A pinned slot goes with ``non_blocking=True`` on
        the current stream, its event recorded for ``stage_begin``;
        otherwise ``Device.put`` copies.  The coherence state is left as
        it is: the caller owns the tensor."""
        with self._lock_:
            target = device.torch_device
            if self._stage_pinned_ is not None and target.type == "cuda":
                slot = self._stage_slot_
                tensor = self._stage_pinned_[slot].to(target,
                                                      non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(target))
                self._stage_pending_[slot] = event
            else:
                tensor = device.put(self._mem)
            self._track_device_bytes(self._mem.nbytes)
            return tensor

    def staged_capture(self, device):
        """The device tensor of the minibatch just served: the adopted
        one where a device path produced it (``set_device_array``), else
        a ``stage_put`` of the host fill."""
        with self._lock_:
            if self._state_ == _DEVICE_DIRTY and self._devmem_ is not None:
                return self._devmem_
        return self.stage_put(device)

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

    def host_tensor(self):
        """The host run's operand: a CPU tensor holding a copy of the
        host buffer (read back first when the device is newer), None
        when the Array is empty."""
        self.map_read()
        return None if self._mem is None else torch.tensor(self._mem)

    def set_host(self, value):
        """Adopt a host run's result, a CPU tensor or a numpy array, as
        the host buffer: a numpy copy, so ``mem`` never shares a
        tensor's memory."""
        if isinstance(value, torch.Tensor):
            value = value.detach()
            if value.dtype == torch.bfloat16:
                value = value.float()
            value = value.numpy()
        self.map_invalidate()
        self.mem = numpy.array(value)

    def _track_device_bytes(self, nbytes):
        """Keep Watcher in sync with exactly what this Array contributed."""
        if nbytes != self._watched_nbytes_:
            if self._watched_nbytes_:
                Watcher.remove(self._watched_nbytes_)
            if nbytes:
                Watcher.add(nbytes)
            self._watched_nbytes_ = nbytes

    def set_device_array(self, tensor, device=None):
        """Adopt a device tensor (a unit's result) without a host round
        trip; the host copy becomes stale.  The tensor is kept as it is,
        not copied.  A producer that updates it in place afterwards (a
        donated train step's state, a loader's minibatch buffer) calls
        this again after each update, so that the next host read copies
        the new values; a host write uploads into a new tensor and
        leaves the producer's alone."""
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
        # a shallow pickle keeps the shape and dtype only: no device read
        # (a pipeline worker may be refilling the tensor meanwhile)
        if not self.shallow_pickle:
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
