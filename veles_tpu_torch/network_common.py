"""Wire protocol of the master-slave control plane and the serve tier.

Counterpart of ``veles_tpu/network_common.py``:
length-prefixed binary frames, ``!IIB`` (header_len, payload_len,
mac_len) + JSON header + raw payload + optional HMAC-SHA256 over
header||payload.  A frame packed here is byte for byte the JAX
package's, so a client of either package talks to a server of the
other.  Payload codecs: none/gzip/bz2/xz (+snappy when installed).
Same-host peers hand payload bytes over :class:`ShmChannel` shared
memory.

Trust boundary: when a shared secret is set (``VELES_TPU_SECRET`` or
``secret=``), every frame is authenticated with HMAC-SHA256 and an
unauthenticated frame is rejected before its header is even parsed.

The control plane's payloads are pickles (protocol 4) of numpy arrays,
dicts, lists and Python scalars, never tensors: :func:`pack_payload`
gives the JAX package's bytes for the same object, so a master of
either package serves slaves of the other.  ``write_frame`` and
``read_frame`` fire the ``net.send`` and ``net.recv`` chaos points
(generic first, then the peer-scoped ``net.recv:slave``).
"""

import asyncio
import bz2
import gzip
import hashlib
import hmac
import json
import lzma
import os
import pickle
import struct
import threading
import time
import uuid

from veles_tpu_torch import chaos

try:  # optional codec, as in the JAX package
    import snappy as _snappy
except ImportError:
    _snappy = None

__all__ = ["pack_payload", "unpack_payload", "read_frame", "write_frame",
           "pack_frame", "read_frame_sync", "get_codec",
           "parse_address", "new_id", "default_secret", "ProtocolError",
           "encode_payload", "decode_payload", "available_codecs",
           "ShmChannel", "machine_id"]

_FRAME = struct.Struct("!IIB")
_MAC_LEN = hashlib.sha256().digest_size
# a 1 GiB ceiling guards against hostile length prefixes
_MAX_LEN = 1 << 30


class ProtocolError(Exception):
    pass


def default_secret():
    """Shared secret from the environment, or None (localhost trust)."""
    sec = os.environ.get("VELES_TPU_SECRET")
    return sec.encode() if sec else None


_COMPRESS = {
    "none": (lambda raw: raw, lambda raw: raw),
    "gzip": (lambda raw: gzip.compress(raw, 1), gzip.decompress),
    "bz2": (lambda raw: bz2.compress(raw, 1), bz2.decompress),
    "xz": (lambda raw: lzma.compress(raw, preset=1), lzma.decompress),
}
if _snappy is not None:
    _COMPRESS["snappy"] = (_snappy.compress, _snappy.decompress)


def available_codecs():
    return tuple(_COMPRESS)


def get_codec(name):
    """``(compress, decompress)`` pair for a codec name."""
    try:
        return _COMPRESS[name]
    except KeyError:
        raise ValueError("unknown codec %r" % name)


def pack_payload(obj, codec="none"):
    """Pickle (protocol 4) and compress a payload."""
    try:
        compress = _COMPRESS[codec][0]
    except KeyError:
        raise ValueError("unknown codec %r" % codec)
    return compress(pickle.dumps(obj, protocol=4))


def unpack_payload(raw, codec="none"):
    try:
        decompress = _COMPRESS[codec][1]
    except KeyError:
        raise ValueError("unknown codec %r" % codec)
    return pickle.loads(decompress(raw))


def _flip_byte(blob):
    """Invert one byte (the ``corrupt`` action): the MAC was computed
    over the clean bytes, so verification catches it."""
    buf = bytearray(blob)
    buf[len(buf) // 2] ^= 0xFF
    return bytes(buf)


def _fire_net_fault(point, peer):
    """The chaos lookup of a frame operation: the generic point first,
    then the peer-scoped one (``net.recv:slave``), which keeps Nth-hit
    triggers deterministic when master and slave share one plan in one
    process."""
    fault = chaos.plan.fire(point)
    if fault is None and peer:
        fault = chaos.plan.fire("%s:%s" % (point, peer))
    return fault


def pack_frame(msg, payload=b"", secret=None):
    """Serialize one frame to bytes: ``!IIB`` prefix + JSON header +
    raw payload + optional HMAC-SHA256 over header||payload.  The one
    encoder behind the asyncio writer (:func:`write_frame`) and the
    blocking client."""
    header = json.dumps(msg).encode()
    mac = (hmac.new(secret, header + payload, hashlib.sha256).digest()
           if secret else b"")
    return _FRAME.pack(len(header), len(payload), len(mac)) + \
        header + payload + mac


def _check_lengths(hlen, plen, mlen, max_len=None):
    ceiling = _MAX_LEN if max_len is None else int(max_len)
    if hlen > ceiling or plen > ceiling or mlen > _MAC_LEN:
        raise ProtocolError("oversized frame (%d/%d/%d)" %
                            (hlen, plen, mlen))


def _finish_frame(header, payload, mac, secret):
    """Shared tail of the async and blocking readers: the MAC checked
    before the header is parsed, then the JSON decode, a mangled header
    being a protocol violation, not a crash."""
    if secret is not None:
        want = hmac.new(secret, header + payload, hashlib.sha256).digest()
        if not hmac.compare_digest(want, mac):
            raise ProtocolError("frame authentication failed")
    try:
        return json.loads(header.decode()), payload
    except (UnicodeDecodeError, ValueError) as exc:
        raise ProtocolError("malformed frame header (%s)" % exc)


def write_frame(writer, msg, payload=b"", secret=None, peer=None):
    """Serialize one frame onto an asyncio StreamWriter."""
    frame = pack_frame(msg, payload, secret)
    if chaos.plan is not None:
        fault = _fire_net_fault("net.send", peer)
        if fault is not None:
            frame = _apply_send_fault(fault, frame, writer)
            if frame is None:
                return
    writer.write(frame)


def _apply_send_fault(fault, frame, writer):
    """The wire faults of an outgoing frame (``net.send``)."""
    if fault.action == "drop":
        return None
    if fault.action == "delay":
        # blocks the sender's event loop on purpose: a stalled sender
        # process (a GC pause) freezes everything that peer multiplexes;
        # per-frame network latency is net.recv's delay, which awaits
        time.sleep(fault.param or 0.05)
        return frame
    if fault.action == "truncate":
        # a partial frame, then close: the peer's readexactly raises
        # IncompleteReadError, the connection-loss recovery path
        writer.write(frame[:max(1, len(frame) * 2 // 3)])
        writer.close()
        return None
    if fault.action == "corrupt":
        return _flip_byte(frame)
    return frame


async def read_frame(reader, secret=None, peer=None, max_len=None):
    """Read one frame from an asyncio StreamReader -> (msg dict,
    payload bytes).  With ``secret`` the MAC is verified before the
    header is parsed; ``max_len`` tightens the 1 GiB length ceiling, so
    a hostile length prefix fails here instead of parking the
    connection on bytes that never come."""
    prefix = await reader.readexactly(_FRAME.size)
    hlen, plen, mlen = _FRAME.unpack(prefix)
    _check_lengths(hlen, plen, mlen, max_len)
    header = await reader.readexactly(hlen)
    payload = await reader.readexactly(plen) if plen else b""
    mac = await reader.readexactly(mlen) if mlen else b""
    if chaos.plan is not None:
        fault = _fire_net_fault("net.recv", peer)
        if fault is not None:
            if fault.action == "delay":
                await asyncio.sleep(fault.param or 0.05)
            elif fault.action == "corrupt":
                if payload:
                    payload = _flip_byte(payload)
                else:
                    header = _flip_byte(header)
    return _finish_frame(header, payload, mac, secret)


def read_frame_sync(recv_exactly, secret=None, max_len=None):
    """Blocking twin of :func:`read_frame`: ``recv_exactly(n)`` returns
    exactly ``n`` bytes or raises.  Same bounds and MAC order."""
    hlen, plen, mlen = _FRAME.unpack(recv_exactly(_FRAME.size))
    _check_lengths(hlen, plen, mlen, max_len)
    header = recv_exactly(hlen)
    payload = recv_exactly(plen) if plen else b""
    mac = recv_exactly(mlen) if mlen else b""
    return _finish_frame(header, payload, mac, secret)


def parse_address(address, default_host="127.0.0.1"):
    """``host:port`` -> (host, int port); an empty host is
    ``default_host``."""
    host, sep, port = address.rpartition(":")
    if not sep:
        raise ValueError("address must be host:port, got %r" % address)
    return (host or default_host), int(port)


def new_id():
    return str(uuid.uuid4())


def machine_id():
    """Stable per-host identifier for same-machine detection."""
    return "%x-%s" % (uuid.getnode(), os.uname().nodename)


class ShmChannel(object):
    """One-directional shared-memory payload channel.

    The protocol is strict request-reply per connection, so at most one
    payload per direction is unconsumed at a time; two alternating
    slots mean the writer never touches the slot the reader may still
    be consuming.  Payloads in shared memory are not covered by the
    frame HMAC: the segment is same-host and named by a random name, so
    the OS user boundary is the protection.
    """

    #: names created by this process (an attach must not unregister them)
    _local_creations = set()
    #: every channel not yet closed in this process (tests check that
    #: none leaks); channels open and close on network threads
    _open_channels = set()
    _open_lock = threading.Lock()

    def __init__(self, shm, created):
        self._shm = shm
        self._created = created
        self._slot = 0
        self.name = shm.name
        self.slot_size = shm.size // 2
        if created:
            ShmChannel._local_creations.add(shm.name)
        with ShmChannel._open_lock:
            ShmChannel._open_channels.add(self)

    @classmethod
    def open_channels(cls):
        """A snapshot of the channels not yet closed."""
        with cls._open_lock:
            return set(cls._open_channels)

    @classmethod
    def create(cls, size):
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(
            create=True, size=max(int(size), 2), name=None)
        return cls(shm, created=True)

    @classmethod
    def attach(cls, name):
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=name)
        if name not in cls._local_creations:
            # the creator owns the segment's lifetime (it unlinks in
            # close()); keep the resource tracker from warning about it
            # at a cross-process attacher's exit
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:
                pass
        return cls(shm, created=False)

    def write(self, raw):
        """Write bytes into the next slot -> (offset, length), or None
        when the payload does not fit (the caller sends it inline)."""
        if len(raw) > self.slot_size:
            return None
        offset = self._slot * self.slot_size
        self._slot ^= 1
        self._shm.buf[offset:offset + len(raw)] = raw
        return offset, len(raw)

    def read(self, offset, length):
        if offset < 0 or length < 0 or offset + length > self._shm.size:
            raise ProtocolError("shm descriptor out of bounds")
        return bytes(self._shm.buf[offset:offset + length])

    def close(self):
        with ShmChannel._open_lock:
            ShmChannel._open_channels.discard(self)
        try:
            self._shm.close()
            if self._created:
                self._shm.unlink()
                ShmChannel._local_creations.discard(self.name)
        except Exception:
            pass


# -- the dict codec (tools and tests that round-trip payloads) -------------

def encode_payload(obj, codec="none"):
    import base64
    return {"codec": codec,
            "b64": base64.b64encode(pack_payload(obj, codec)).decode()}


def decode_payload(blob):
    import base64
    if blob is None:
        return None
    return unpack_payload(base64.b64decode(blob["b64"]), blob["codec"])
