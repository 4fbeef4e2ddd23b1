"""Wire framing shared by the serve tier's binary transport.

Counterpart of the framing half of ``veles_tpu/network_common.py``:
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

The master-slave control plane (pickled payloads, ``parse_address``,
``new_id``) and the ``net.send`` / ``net.recv`` chaos points wait for
ROADMAP.md Queue 1 item 12.
"""

import bz2
import gzip
import hashlib
import hmac
import json
import lzma
import os
import struct
import threading
import uuid

try:  # optional codec, as in the JAX package
    import snappy as _snappy
except ImportError:
    _snappy = None

__all__ = ["read_frame", "write_frame", "pack_frame", "read_frame_sync",
           "get_codec", "default_secret", "ProtocolError",
           "available_codecs", "ShmChannel", "machine_id"]

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


def write_frame(writer, msg, payload=b"", secret=None):
    """Serialize one frame onto an asyncio StreamWriter."""
    writer.write(pack_frame(msg, payload, secret))


async def read_frame(reader, secret=None, max_len=None):
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
