"""Multi-host serve tier: one front, many hosts, hedged tails.

Counterpart of ``veles_tpu/serve/fleet.py``, whole: the router is plain
Python over the pipelined binary link (``serve/transport.py``), its
frames are byte for byte the JAX package's, so a front of either
package drives hosts of the other.  A :class:`ReplicaPool` scales
serving across one host's cards; this tier spans HOSTS and survives
losing one mid-stream.  Inference is p99-bound, so a straggling or dying
host must cost bounded tail latency and never a failed request:

- **membership** rides :class:`veles_tpu_torch.elastic.FleetView`: every
  host join and leave bumps a membership epoch.  A host joins when its
  pipelined link (``"pipeline": true`` hello, HMAC handshake) answers
  with the fleet's model digest; it leaves when the link severs
  (connection error, SIGKILL, chaos ``serve.host.preempt``).  Shares
  are weighted by the measured per-host throughput EMA
  (``FleetView.observe_throughput``): the router observes every
  completion, so a host that slows down loses routing weight within a
  handful of requests.
- **routing** is the pool's least-loaded pick with overload cascade,
  lifted to hosts: each request goes to the live host with the lowest
  throughput-weighted in-flight count; a host that sheds (a transient
  error frame) cascades the request to its siblings, and only when
  every live host shed does the front raise :class:`ServeOverload`
  with the fleet-minimum ``retry_after``.
- **request hedging**: a watchdog compares every single-copy in-flight
  request against :func:`veles_tpu_torch.elastic.speculation_threshold`
  (the power-corrected speculative-dispatch bar, fed the throughput
  EMAs) and past it sends the request to a sibling host.  The first
  result wins; the loser is cancelled over the wire (best-effort:
  exactly-once is the router's accounting, not the cancel's).
- **exactly-once fences**: every dispatched copy gets a fresh wire id
  and bumps its request's *epoch*; a result is accepted only while its
  wire id is registered and the request unresolved.  A hedged request
  is never answered twice (the second result finds the entry resolved:
  ``serve.hedge.duplicates_dropped``) and never dropped when its copies
  race a host death (a dead host's copies are retired and, with no live
  sibling copy left, the request is requeued to a survivor under a new
  epoch: ``serve.fleet.requeues``).
- **re-warm before rotation**: a (re)joining host's hello carries its
  pool's compile receipt (``new_compiles``, ``kernel_builds``,
  ``captures``); the host is counted live only once that hello arrived,
  which a host sends only after its ladder is captured.
"""

import itertools
import random
import socket as _socketmod
import threading
import time
from collections import deque

import numpy

from veles_tpu_torch import chaos, elastic
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.network_common import (
    ProtocolError, default_secret, machine_id, pack_frame,
    read_frame_sync)
from veles_tpu_torch.observe import requests as reqtrace
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.serve import qos
from veles_tpu_torch.serve.batcher import ServeOverload
from veles_tpu_torch.serve.transport import (
    MAX_FRAME_BYTES, decode_tensor, encode_tensor)

__all__ = ["FleetRequest", "FleetRouter", "HostLink"]


class _LinkIdle(Exception):
    """The link had NO traffic for a keepalive interval (timeout at a
    frame boundary, zero bytes read): not a failure — the reader
    pings and keeps listening.  A timeout MID-frame is a real link
    problem and stays an error."""


class HostLink(object):
    """One pipelined router→host connection.

    The hello carries ``"pipeline": true`` so the host dispatches every
    ``infer`` frame concurrently and answers by id (out of order); the
    link then supports many in-flight requests — sends serialized by
    one lock, replies dispatched by a reader thread through the
    router's callbacks.  ``send_cancel`` retires a hedged loser
    best-effort.  The reader thread MUST be joined (:meth:`close`);
    the router joins links it retired at :meth:`FleetRouter.stop`.

    After the handshake the socket timeout drops to ``keepalive_s``:
    an idle interval at a frame boundary makes the reader PING the
    host and keep listening (an idle fleet must not retire healthy
    hosts just for having no traffic), while a dead peer fails the
    ping/read and reports down.  The short timeout also bounds how
    long a send into a wedged host's full buffer can stall (the
    router dispatches under its lock, so that bound is fleet-wide
    back-pressure, not just this link's).
    """

    def __init__(self, sock=None, host=None, port=None, secret=None,
                 timeout=30.0, keepalive_s=5.0):
        if sock is None:
            sock = _socketmod.create_connection((host, port), timeout)
        else:
            sock.settimeout(timeout)
        self._sock = sock
        self._secret = default_secret() if secret is None \
            else (secret or None)
        self._send_lock = threading.Lock()
        self._thread = None
        self._frame_started = False
        self.keepalive_s = float(keepalive_s)
        self.closed = False
        self._send({"op": "hello", "mid": machine_id(),
                    "pipeline": True})
        reply, _ = self._read()
        if reply.get("op") != "hello":
            raise ProtocolError("expected hello reply, got %r"
                                % reply.get("op"))
        if not reply.get("pipeline"):
            raise ProtocolError(
                "host does not speak the pipelined fleet link "
                "(pre-fleet serve transport?)")
        self.digest = reply.get("digest")
        self.dtype = numpy.dtype(str(reply.get("dtype", "<f4")))
        self.sample_shape = tuple(reply.get("sample_shape", ()))
        self.max_batch = int(reply.get("max_batch", 1))
        self.ladder = tuple(int(b) for b in
                            reply.get("ladder", (self.max_batch,)))
        #: the hello's "host" block: host id + the re-warm receipt
        #: summary ({"host_id", "new_compiles", "cache_hits"})
        self.host_info = dict(reply.get("host") or {})
        # handshake done: drop to the keepalive timeout (see class
        # docstring — idle survival + bounded send stalls)
        self._sock.settimeout(self.keepalive_s)

    # -- framing ------------------------------------------------------------

    def _recv_exactly(self, n):
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except _socketmod.timeout:
                if not self._frame_started and not buf:
                    raise _LinkIdle()  # quiet link, not a dead one
                raise  # a frame stalled mid-read: real link trouble
            if not chunk:
                raise ConnectionError("host closed the connection")
            buf += chunk
            self._frame_started = True
        return bytes(buf)

    def _send(self, msg, payload=b""):
        with self._send_lock:
            self._sock.sendall(pack_frame(msg, payload, self._secret))

    def _read(self):
        self._frame_started = False
        return read_frame_sync(self._recv_exactly, self._secret,
                               max_len=MAX_FRAME_BYTES)

    # -- API ----------------------------------------------------------------

    def send_infer(self, wid, arr, slo_class=None, shadow=False,
                   trace=None):
        meta, raw = encode_tensor(arr)
        msg = {"op": "infer", "id": wid}
        if slo_class is not None:
            # the front's QoS label travels with the copy so the
            # host's batcher sheds and accounts by the SAME class
            msg["slo_class"] = slo_class
        if shadow:
            # canary-slice mirror: the host serves it via
            # submit_shadow — computed and answered, never counted in
            # the served/tenant metrics
            msg["shadow"] = True
        if trace is not None:
            # request trace id rides the copy so both hedge legs of
            # one request stamp the SAME id on their host timelines
            # (plain bounded string — observe/requests.py contract)
            msg["trace"] = trace
        msg.update(meta)
        self._send(msg, raw)

    def send_cancel(self, wid):
        self._send({"op": "cancel", "id": wid})

    def send_telemetry_poll(self):
        """One telemetry poll frame (transport ``telemetry`` op):
        ``t0`` stamps the send so the reply's t1/t2 plus receipt t3
        close an NTP clock-probe sample.  Thread-safe (the send lock)
        — the router's watchdog fires it off-reader."""
        self._send({"op": "telemetry", "id": -2, "t0": time.time()})

    def start_reader(self, on_result, on_error, on_down,
                     on_telemetry=None):
        """Spawn the reply-dispatch thread: ``on_result(wid, arr,
        msg)`` / ``on_error(wid, exc)`` per answered frame (``msg`` is
        the reply header — carries the host's echoed ``trace``/
        ``segs``), ``on_down()`` once when the link dies (or closes),
        ``on_telemetry(msg, t3)`` per telemetry-poll reply (``t3`` is
        the receipt wall stamp that closes the clock sample)."""

        def loop():
            try:
                while True:
                    try:
                        msg, payload = self._read()
                    except _LinkIdle:
                        # no traffic for a keepalive interval: PROVE
                        # the peer is alive instead of retiring it —
                        # a dead one fails the ping or the next read
                        self._send({"op": "ping", "id": -1})
                        continue
                    op = msg.get("op")
                    if op == "result":
                        try:
                            arr = decode_tensor(msg, payload)
                        except ProtocolError as exc:
                            on_error(msg.get("id"), exc)
                            continue
                        on_result(msg.get("id"), arr, msg)
                    elif op == "error":
                        if msg.get("transient"):
                            exc = ServeOverload(
                                msg.get("error", "overloaded"),
                                retry_after=float(
                                    msg.get("retry_after", 0.1)))
                        else:
                            exc = RuntimeError(
                                msg.get("error", "serve error"))
                        on_error(msg.get("id"), exc)
                    elif op == "telemetry":
                        if on_telemetry is not None:
                            try:
                                on_telemetry(msg, time.time())
                            except Exception:
                                pass  # telemetry never kills a link
                    # pong / unknown: ignore
            except (ConnectionError, OSError, ProtocolError,
                    ValueError):
                pass
            finally:
                on_down()

        self._thread = threading.Thread(target=loop, name="fleet-link")
        self._thread.start()
        return self._thread

    def close(self, join=True):
        """Close the socket (unblocking the reader) and join the
        reader thread.  ``join=False`` when called FROM the reader's
        own ``on_down`` — the router joins retired threads later."""
        if not self.closed:
            self.closed = True
            try:
                self._send({"op": "bye"})
            except Exception:
                pass
        try:
            self._sock.close()
        except Exception:
            pass
        if join and self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=10)


class FleetRequest(object):
    """One client request in the front tier — duck-types the batcher's
    ``_Request`` surface (``done``/``result``/``error``/``cancelled``)
    so :class:`ServeService` and the binary transport drive a
    :class:`FleetRouter` exactly like a pool.  ``epoch`` counts
    dispatched copies (the request-epoch half of the exactly-once
    fence); ``copies`` maps live wire ids → host ids."""

    __slots__ = ("sample", "rows", "block", "enqueued", "done",
                 "result", "error", "cancelled", "epoch", "copies",
                 "sheds", "hedges", "resolved", "slo_class", "latency",
                 "mirror", "trace", "requeues", "legs")

    def __init__(self, sample, block=False, slo_class=None,
                 trace=None):
        self.sample = sample
        self.rows = sample.shape[0] if block else 1
        self.block = block
        self.enqueued = time.perf_counter()
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.cancelled = False
        self.epoch = 0
        self.copies = {}        # wid -> host_id
        self.sheds = {}         # host_id -> retry_after offered
        self.hedges = 0
        self.resolved = False
        #: canonical SLO class — decides the class-aware inflight
        #: bound, the per-class hedge budget, and the class the host's
        #: batcher accounts the copy under
        self.slo_class = qos.normalize_class(slo_class)
        #: end-to-end seconds, stamped at resolution — the canary
        #: comparator reads it off mirrored pairs
        self.latency = None
        #: _ShadowCopy when the canary slice mirrored this request to
        #: the canary host; cleared once the pair is emitted (or the
        #: shadow failed)
        self.mirror = None
        #: request trace id (observe/requests.py) — rides every
        #: dispatched copy so hedge legs stitch under one id
        self.trace = trace
        #: times this request was requeued to a survivor after losing
        #: ALL its live copies (host death / send failure)
        self.requeues = 0
        #: dispatch-leg records, appended per copy: {"host", "start",
        #: "end", "hedge", "outcome", "segs"} — the front-tier
        #: critical-path story (serve.req.leg spans + exemplars)
        self.legs = []


class _Copy(object):
    """One dispatched copy of a request (original or hedge)."""

    __slots__ = ("wid", "entry", "host_id", "epoch", "sent_at",
                 "hedge", "leg")

    def __init__(self, wid, entry, host_id, epoch, hedge):
        self.wid = wid
        self.entry = entry
        self.host_id = host_id
        self.epoch = epoch
        self.sent_at = time.perf_counter()
        self.hedge = hedge
        #: this copy's record in entry.legs (None when untraced)
        self.leg = None


class _Host(object):
    """Router-side record of one serve host."""

    __slots__ = ("host_id", "link", "state", "inflight", "info",
                 "joined_epoch")

    def __init__(self, host_id, link, joined_epoch):
        self.host_id = host_id
        self.link = link
        self.state = "live"     # live | dead | leaving | canary
        self.inflight = set()   # wire ids currently on this host
        self.info = dict(link.host_info)
        self.joined_epoch = joined_epoch


class _ShadowCopy(object):
    """The canary-slice mirror of one request: dispatched to the
    canary host beside (never instead of) the primary copy, tracked in
    the router's SEPARATE shadow wire map so it can never trip the
    exactly-once fence, resolve the entry, or count as served."""

    __slots__ = ("entry", "host_id", "sent_at", "out", "latency")

    def __init__(self, entry, host_id):
        self.entry = entry
        self.host_id = host_id
        self.sent_at = time.perf_counter()
        self.out = None
        self.latency = None


class _CanarySlice(object):
    """Router-side state of an active fleet-canary traffic slice: ONE
    host out of rotation, a seeded fraction of single-sample traffic
    mirrored to it as shadow copies, mirrored (primary, shadow) pairs
    fed to ``on_pair`` for the comparator's verdict."""

    __slots__ = ("host_id", "fraction", "rng", "on_pair", "mirrored",
                 "pairs", "shadow_errors", "link_down", "armed")

    def __init__(self, host_id, fraction, seed, on_pair):
        self.host_id = host_id
        self.fraction = float(fraction)
        self.rng = random.Random(seed)
        self.on_pair = on_pair
        self.mirrored = 0
        self.pairs = 0
        self.shadow_errors = 0
        self.link_down = False
        #: mirroring is held off until the controller ARMS the slice —
        #: after the candidate is staged — so every judged pair really
        #: compares candidate output, never stale old-vs-old evidence
        self.armed = False


class _FleetProfile(object):
    """What the front knows about the model it fronts — learned from
    the first host's hello and enforced on every later join (the
    bit-identity contract needs ONE digest fleet-wide)."""

    __slots__ = ("digest", "dtype", "sample_shape", "max_batch",
                 "ladder")

    def __init__(self, link):
        self.digest = link.digest
        self.dtype = link.dtype
        self.sample_shape = link.sample_shape
        self.max_batch = link.max_batch
        self.ladder = link.ladder


class FleetRouter(Logger):
    """The front tier: dispatch over many serve hosts with hedged
    tails and exactly-once completion under host loss.

    Duck-types the :class:`ContinuousBatcher` submit surface
    (``submit``/``submit_block``/``infer``/``start``/``stop``/
    ``engine``/``snapshot``), so :class:`ServeService` and the binary
    transport can front a host fleet exactly like a local pool.

    ``hedge_factor``/``hedge_floor_s`` feed
    :func:`elastic.speculation_threshold` (``hedge=False`` disables
    the watchdog entirely); ``max_hedges`` bounds copies per request
    (default 1 backup); ``hedge_warmup``
    completed requests must land before the first hedge fires — with
    no latency evidence the threshold would collapse to the floor and
    a cold front under load would duplicate its entire first wave of
    traffic.
    """

    def __init__(self, secret=None, hedge=True, hedge_factor=2.0,
                 hedge_floor_s=0.05, hedge_tick_s=0.02, max_hedges=1,
                 hedge_warmup=8, throughput_alpha=0.2,
                 link_timeout=30.0, keepalive_s=5.0, hedge_budget=None,
                 max_inflight=None, retry_jitter=None,
                 telemetry_interval_s=2.0, alert_rules=None,
                 **kwargs):
        super(FleetRouter, self).__init__(**kwargs)
        self._secret = secret
        self.hedge = bool(hedge)
        self.hedge_factor = float(hedge_factor)
        self.hedge_floor_s = float(hedge_floor_s)
        self.hedge_tick_s = float(hedge_tick_s)
        self.max_hedges = int(max_hedges)
        self.hedge_warmup = int(hedge_warmup)
        self.link_timeout = float(link_timeout)
        self.keepalive_s = float(keepalive_s)
        #: per-class hedge token buckets (qos.HedgeBudget): an
        #: exhausted class routes normally (no hedge this tick), it
        #: never fails; None = unlimited (legacy behavior)
        self.hedge_budget = hedge_budget
        #: class-aware bound on unresolved front requests: past it an
        #: incoming request evicts one of STRICTLY lower class (shed
        #: attributed to the victim) or is shed itself; None =
        #: unbounded (legacy behavior — hosts shed at their queues)
        self.max_inflight = max_inflight
        self.retry_jitter = retry_jitter if retry_jitter is not None \
            else qos.RetryJitter()
        #: unresolved entries per class — the eviction pool behind
        #: max_inflight
        self._unresolved = {cls: set() for cls in qos.SLO_CLASSES}
        #: active _CanarySlice (begin_canary_slice), or None
        self._canary = None
        #: wid -> _ShadowCopy: the canary mirror's OWN wire map —
        #: checked before the primary map so shadow replies can never
        #: trip the duplicate fence or resolve an entry
        self._shadow_wire = {}
        self.fleet = elastic.FleetView(
            throughput_alpha=throughput_alpha)
        self._lock = threading.RLock()
        self._hosts = {}            # host_id -> _Host
        self._retired = []          # dead links awaiting thread join
        self._wire = {}             # wid -> _Copy
        self._wids = itertools.count(1)
        self._auto_ids = itertools.count(1)
        self._latencies = deque(maxlen=256)
        self._profile = None
        self._stop_ = threading.Event()
        self._watchdog = None
        self._g_live = _registry.gauge("serve.fleet.hosts_live")
        self._g_epoch = _registry.gauge(
            "serve.fleet.membership_epoch")
        self._m_requests = _registry.counter("serve.fleet.requests")
        self._m_failed = _registry.counter("serve.fleet.failed")
        self._m_requeues = _registry.counter("serve.fleet.requeues")
        self._m_cascades = _registry.counter("serve.fleet.cascades")
        self._m_hedges = _registry.counter("serve.hedge.fired")
        self._m_hedge_wins = _registry.counter("serve.hedge.wins")
        self._m_dup = _registry.counter(
            "serve.hedge.duplicates_dropped")
        self._m_shed = _registry.counter("serve.fleet.shed")
        self._m_mirrors = _registry.counter("serve.fleet.canary.mirrors")
        self._m_latency = _registry.histogram("serve.fleet.latency_s")
        self._g_live.set(0)
        self._g_epoch.set(0)
        #: the fleet telemetry plane (observe/timeseries.py +
        #: observe/alerts.py): the watchdog polls every live host's
        #: link every ``telemetry_interval_s`` (0/None disables), the
        #: reply's NTP echo feeds the clock offsets, and the router's
        #: OWN alert manager evaluates ``alert_rules`` (declarative
        #: specs or AlertRule objects; None = the stock serve set)
        #: over the offset-corrected rollup after each poll round.
        self.telemetry_interval_s = float(telemetry_interval_s or 0.0)
        self.telemetry = None
        self.alerts = None
        if self.telemetry_interval_s > 0:
            from veles_tpu_torch.observe.alerts import (AlertManager,
                                                  default_rules,
                                                  rule_from_spec)
            from veles_tpu_torch.observe.timeseries import FleetTelemetry
            self.telemetry = FleetTelemetry(
                interval_s=self.telemetry_interval_s)
            if alert_rules is None:
                # fleet scope: the burn rules watch the front's
                # end-to-end class histograms (the ones that see
                # transport stalls), not the host serving-edge ones
                rules = default_rules(scope="fleet")
            else:
                rules = [rule_from_spec(r) if isinstance(r, dict)
                         else r for r in alert_rules]
            self.alerts = AlertManager(rules)
        self._last_poll = 0.0

    # -- membership ---------------------------------------------------------

    def add_host(self, address=None, sock=None, host_id=None):
        """Handshake a serve host into the fleet; returns its host id.

        ``address`` is ``"host:port"`` (or a ``(host, port)`` pair);
        ``sock`` adopts an established socket (tests pair it with
        ``BinaryTransportServer.serve_socket`` — no port binds).  A
        digest mismatch with the fleet's profile is REFUSED: routed
        and hedged copies must be bit-identical wherever they land,
        so one fleet serves one digest."""
        if address is not None and sock is None:
            if isinstance(address, str):
                host, _, port = address.partition(":")
                address = (host, int(port))
            link = HostLink(host=address[0], port=address[1],
                            secret=self._secret,
                            timeout=self.link_timeout,
                            keepalive_s=self.keepalive_s)
        else:
            link = HostLink(sock=sock, secret=self._secret,
                            timeout=self.link_timeout,
                            keepalive_s=self.keepalive_s)
        hid = host_id or link.host_info.get("host_id") or \
            "host-%d" % next(self._auto_ids)
        with self._lock:
            if self._profile is None:
                self._profile = _FleetProfile(link)
            elif link.digest != self._profile.digest:
                link.close()
                raise ValueError(
                    "host %s serves digest %s, fleet serves %s — "
                    "refusing a mixed fleet" %
                    (hid, link.digest, self._profile.digest))
            if hid in self._hosts and \
                    self._hosts[hid].state == "live":
                link.close()
                raise ValueError("host id %r already live" % hid)
            epoch = self.fleet.join(hid, 1.0)
            host = self._hosts[hid] = _Host(hid, link, epoch)
            self._publish_membership()
        link.start_reader(
            lambda wid, arr, msg=None: self._on_result(
                host, wid, arr, msg),
            lambda wid, exc: self._on_error(host, wid, exc),
            lambda: self._on_link_down(host),
            on_telemetry=(
                (lambda msg, t3: self._on_telemetry(hid, msg, t3))
                if self.telemetry is not None else None))
        _tracer.instant("serve.fleet.join", cat="serve", host=hid,
                        epoch=epoch,
                        new_compiles=host.info.get("new_compiles"))
        self.info("fleet host %s joined at membership epoch %d "
                  "(digest %s, re-warm new_compiles=%s)", hid, epoch,
                  link.digest, host.info.get("new_compiles"))
        return hid

    def remove_host(self, host_id):
        """Graceful leave: the host is taken out of rotation, its
        in-flight copies requeue to survivors, the link closes."""
        with self._lock:
            host = self._hosts.get(host_id)
            if host is None or host.state != "live":
                return
            host.state = "leaving"
            self._retire_host(host, reason="removed")
        host.link.close()

    def _on_link_down(self, host):
        with self._lock:
            if host.state not in ("live", "canary"):
                # graceful close or already handled: just park the
                # thread for the final join
                self._retired.append(host.link)
                return
            if host.state == "canary" and self._canary is not None \
                    and self._canary.host_id == host.host_id:
                # the canary host died mid-judgment: the slice is
                # over (the controller sees link_down and rolls back);
                # shadow copies die with it — mirrors are
                # observations, nothing requeues
                self._canary.link_down = True
            host.state = "dead"
            self._retire_host(host, reason="link down")
            self._retired.append(host.link)
        host.link.close(join=False)
        self.warning("fleet host %s LOST (membership epoch %d); "
                     "in-flight requests requeued to survivors",
                     host.host_id, self.fleet.membership_epoch)

    def _retire_host(self, host, reason):
        """Under the lock: epoch-bumped membership removal + requeue
        of every in-flight copy that has no live sibling.  The half of
        the elasticity contract that makes a SIGKILL mid-stream cost
        latency, never a failed request."""
        epoch = self.fleet.leave(host.host_id)
        self._publish_membership()
        _tracer.instant("serve.fleet.leave", cat="serve",
                        host=host.host_id, epoch=epoch, reason=reason)
        now = time.perf_counter()
        wids, host.inflight = list(host.inflight), set()
        for wid in wids:
            shadow = self._shadow_wire.pop(wid, None)
            if shadow is not None:
                # a canary mirror dies with its host: drop the record
                # so the entry's pair simply never emits
                shadow.entry.mirror = None
                continue
            copy = self._wire.pop(wid, None)
            if copy is None:
                continue
            entry = copy.entry
            entry.copies.pop(wid, None)
            if copy.leg is not None and copy.leg["end"] is None:
                copy.leg["end"] = now
                copy.leg["outcome"] = "lost"
            if entry.resolved or entry.cancelled:
                continue
            if entry.copies:
                continue  # a hedged sibling still lives: let it win
            self._m_requeues.inc()
            entry.requeues += 1
            if _tracer.active:
                # cat stays "serve": instants land on the caller's
                # thread track, which mixes request ids — the analyzer
                # matches by NAME, the trace arg attributes it
                kwargs = {"host": host.host_id, "reason": reason}
                if entry.trace is not None:
                    kwargs["trace"] = entry.trace
                _tracer.instant("serve.fleet.requeue", cat="serve",
                                **kwargs)
            try:
                self._send_copy(entry, exclude=set(entry.sheds))
            except ServeOverload as exc:
                self._resolve_error(entry, exc)

    def _publish_membership(self):
        self._g_live.set(sum(1 for h in self._hosts.values()
                             if h.state == "live"))
        self._g_epoch.set(self.fleet.membership_epoch)

    def _live_hosts(self):
        return [h for h in self._hosts.values() if h.state == "live"]

    # -- dispatch -----------------------------------------------------------

    def _host_weight(self, host_id, mean_tp):
        """Routing weight: the measured throughput EMA, or — for a
        cold (just-joined) host — the fleet mean, so it competes for
        traffic and earns a real measurement instead of starving
        against absolute rates (the neutral 1.0 is orders of
        magnitude off a measured rows/sec)."""
        tp = self.fleet.throughput(host_id, default=None)
        return tp if tp is not None else mean_tp

    def _mean_throughput(self):
        observed = [tp for tp in
                    (self.fleet.throughput(h.host_id, default=None)
                     for h in self._live_hosts()) if tp is not None]
        return sum(observed) / len(observed) if observed else 1.0

    def _pick(self, exclude):
        """Least-loaded live host outside ``exclude``, in-flight count
        weighted by the measured throughput EMA — a host that slowed
        down carries proportionally less."""
        best, best_load = None, None
        mean_tp = self._mean_throughput()
        for host in self._live_hosts():
            if host.host_id in exclude:
                continue
            load = (len(host.inflight) + 1) / \
                self._host_weight(host.host_id, mean_tp)
            if best_load is None or load < best_load:
                best, best_load = host, load
        return best

    def _send_copy(self, entry, exclude=(), hedge=False):
        """Under the lock: dispatch one copy of ``entry`` to the best
        live host outside ``exclude``; raises :class:`ServeOverload`
        with the fleet's best ``retry_after`` promise when no host is
        available.  A link that dies at send time retires its host
        (requeueing THAT host's other work) and the dispatch moves on
        to the next survivor."""
        exclude = set(exclude)
        while True:
            host = self._pick(exclude)
            if host is None:
                retry = min(entry.sheds.values()) \
                    if entry.sheds else 0.5
                raise ServeOverload(
                    "no live serve host available "
                    "(%d shed, %d live)" %
                    (len(entry.sheds), len(self._live_hosts())),
                    retry_after=retry)
            wid = next(self._wids)
            entry.epoch += 1
            copy = _Copy(wid, entry, host.host_id, entry.epoch, hedge)
            self._wire[wid] = copy
            entry.copies[wid] = host.host_id
            host.inflight.add(wid)
            if reqtrace.enabled:
                copy.leg = {"host": host.host_id,
                            "start": copy.sent_at, "end": None,
                            "hedge": hedge, "outcome": None,
                            "segs": None}
                entry.legs.append(copy.leg)
            try:
                host.link.send_infer(wid, entry.sample,
                                     slo_class=entry.slo_class,
                                     trace=entry.trace)
                return copy
            except Exception:
                del self._wire[wid]
                entry.copies.pop(wid, None)
                host.inflight.discard(wid)
                if copy.leg is not None:
                    copy.leg["end"] = time.perf_counter()
                    copy.leg["outcome"] = "send_failed"
                exclude.add(host.host_id)
                if host.state == "live":
                    host.state = "dead"
                    self._retire_host(host, reason="send failed")
                    self._retired.append(host.link)
                    host.link.close(join=False)

    def submit(self, sample, slo_class=None, trace=None):
        """Enqueue one sample on the fleet; returns the pending
        request (the batcher contract).  Raises ServeOverload when
        every live host sheds.  ``slo_class`` labels the request for
        the QoS layer; un-labelled callers default to ``batch``.
        ``trace`` is the request's trace id (observe/requests.py),
        already normalized by the front door."""
        if self._profile is None:
            raise ServeOverload("fleet has no hosts", retry_after=1.0)
        sample = numpy.ascontiguousarray(sample, self._profile.dtype)
        if sample.shape != self._profile.sample_shape:
            raise ValueError("expected sample shape %s, got %s" %
                             (self._profile.sample_shape, sample.shape))
        return self._submit_entry(
            FleetRequest(sample, slo_class=slo_class, trace=trace))

    def submit_block(self, block, slo_class=None, trace=None):
        """Enqueue a contiguous batch as ONE request (the transport's
        block path); rows stay together on one host per copy."""
        if self._profile is None:
            raise ServeOverload("fleet has no hosts", retry_after=1.0)
        block = numpy.ascontiguousarray(block, self._profile.dtype)
        if block.ndim != len(self._profile.sample_shape) + 1 or \
                block.shape[1:] != self._profile.sample_shape:
            raise ValueError("expected a (n,) + %s block, got %s" %
                             (self._profile.sample_shape, block.shape))
        if not 1 <= block.shape[0] <= self._profile.max_batch:
            raise ValueError(
                "block of %d rows overflows the fleet ladder (max %d);"
                " chunk at the caller" %
                (block.shape[0], self._profile.max_batch))
        return self._submit_entry(
            FleetRequest(block, block=True, slo_class=slo_class,
                         trace=trace))

    def _inflight_total(self):
        return sum(len(pool) for pool in self._unresolved.values())

    def _evict_lower(self, incoming_cls):
        """Under the lock: resolve one unresolved entry of STRICTLY
        lower class with ServeOverload (copies cancelled over the
        wire, shed attributed to the victim's class) to admit an
        incoming ``incoming_cls`` request past ``max_inflight``.
        Returns False when nothing lower is pending — the incoming
        request must be shed instead."""
        incoming_rank = qos.class_rank(incoming_cls)
        for victim_cls in qos.SHED_ORDER:
            if qos.class_rank(victim_cls) >= incoming_rank:
                return False
            pool = self._unresolved[victim_cls]
            while pool:
                victim = pool.pop()
                if victim.resolved or victim.cancelled:
                    continue
                victim.resolved = True
                for wid, hid in list(victim.copies.items()):
                    self._wire.pop(wid, None)
                    host = self._hosts.get(hid)
                    if host is not None:
                        host.inflight.discard(wid)
                        if host.state == "live":
                            try:
                                host.link.send_cancel(wid)
                            except Exception:
                                pass
                victim.copies.clear()
                victim.mirror = None
                self._m_shed.inc()
                qos.note_shed(victim_cls)
                victim.error = ServeOverload(
                    "shed for %s admission (class-ordered eviction)"
                    % incoming_cls,
                    retry_after=self.retry_jitter.apply(
                        self._retry_estimate(), victim_cls))
                if _tracer.active:
                    _tracer.instant("serve.fleet.shed", cat="serve",
                                    slo_class=victim_cls,
                                    evicted_for=incoming_cls)
                victim.done.set()
                return True
        return False

    def _retry_estimate(self):
        """Base retry_after for front-side sheds: the recent mean
        end-to-end latency, floored for cold fronts."""
        if self._latencies:
            return max(0.05,
                       sum(self._latencies) / len(self._latencies))
        return 0.1

    def _submit_entry(self, entry):
        self._m_requests.inc()
        with self._lock:
            if self.max_inflight is not None and \
                    self._inflight_total() >= self.max_inflight and \
                    not self._evict_lower(entry.slo_class):
                self._m_shed.inc()
                qos.note_shed(entry.slo_class)
                raise ServeOverload(
                    "fleet front full (%d unresolved)"
                    % self._inflight_total(),
                    retry_after=self.retry_jitter.apply(
                        self._retry_estimate(), entry.slo_class))
            self._send_copy(entry, exclude=set())
            self._unresolved[entry.slo_class].add(entry)
            self._maybe_mirror(entry)
        return entry

    def _maybe_mirror(self, entry):
        """Under the lock: canary-slice mirroring — a seeded fraction
        of single-sample traffic gets a shadow copy on the canary
        host, tracked in the SEPARATE shadow wire map.  Never raises:
        mirroring is an observation, the primary dispatch already
        succeeded and stands either way."""
        slice_ = self._canary
        if slice_ is None or not slice_.armed or entry.block:
            return
        if slice_.rng.random() >= slice_.fraction:
            return
        host = self._hosts.get(slice_.host_id)
        if host is None or host.state != "canary":
            return
        wid = next(self._wids)
        shadow = _ShadowCopy(entry, slice_.host_id)
        self._shadow_wire[wid] = shadow
        host.inflight.add(wid)
        try:
            host.link.send_infer(wid, entry.sample,
                                 slo_class=entry.slo_class,
                                 shadow=True, trace=entry.trace)
        except Exception:
            self._shadow_wire.pop(wid, None)
            host.inflight.discard(wid)
            slice_.shadow_errors += 1
            return
        entry.mirror = shadow
        slice_.mirrored += 1
        self._m_mirrors.inc()

    def infer(self, sample, timeout=30.0, slo_class=None, trace=None):
        """Blocking single-sample round-trip through the fleet."""
        return self._wait(
            self.submit(sample, slo_class=slo_class, trace=trace),
            timeout)

    def infer_block(self, block, timeout=30.0, slo_class=None,
                    trace=None):
        return self._wait(
            self.submit_block(block, slo_class=slo_class, trace=trace),
            timeout)

    def _wait(self, entry, timeout):
        if not entry.done.wait(timeout):
            self._abandon(entry)
            raise TimeoutError("fleet inference timed out after %.1fs"
                               % timeout)
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _abandon(self, entry):
        """Caller gave up: retire the entry's copies (cancels over the
        wire) so hosts stop computing for nobody and late results are
        rejected as duplicates."""
        with self._lock:
            entry.cancelled = True
            self._unresolved[entry.slo_class].discard(entry)
            entry.mirror = None
            for wid, hid in list(entry.copies.items()):
                self._wire.pop(wid, None)
                host = self._hosts.get(hid)
                if host is not None:
                    host.inflight.discard(wid)
                    if host.state == "live":
                        try:
                            host.link.send_cancel(wid)
                        except Exception:
                            pass
            entry.copies.clear()

    # -- completion (reader-thread callbacks) -------------------------------

    def _on_result(self, host, wid, arr, msg=None):
        now = time.perf_counter()
        with self._lock:
            shadow = self._shadow_wire.pop(wid, None)
            if shadow is not None:
                # canary mirror reply: pure evidence, NEVER a caller
                # answer — record and try to emit the judgment pair
                host.inflight.discard(wid)
                shadow.out = arr[0] if arr.ndim == 2 and \
                    not shadow.entry.block else arr
                shadow.latency = now - shadow.sent_at
                entry = shadow.entry
            else:
                entry = None
        if entry is not None:
            self._maybe_emit_pair(entry)
            return
        with self._lock:
            copy = self._wire.pop(wid, None)
            if copy is None or copy.entry.resolved or \
                    copy.entry.cancelled:
                # the exactly-once fence: a late duplicate (hedge
                # loser whose cancel lost the race, or chaos
                # serve.hedge.lose_race skipping the cancel) finds its
                # wire id retired or its entry resolved — rejected,
                # never answered twice
                self._m_dup.inc()
                host.inflight.discard(wid)
                return
            entry = copy.entry
            entry.resolved = True
            self._unresolved[entry.slo_class].discard(entry)
            host.inflight.discard(wid)
            entry.copies.pop(wid, None)
            if copy.leg is not None:
                copy.leg["end"] = now
                copy.leg["outcome"] = "win"
                copy.leg["segs"] = self._leg_segments(msg)
            latency = now - copy.sent_at
            self.fleet.observe_throughput(
                host.host_id, entry.rows / max(latency, 1e-9))
            if copy.hedge:
                self._m_hedge_wins.inc()
                if _tracer.active:
                    _tracer.instant("serve.hedge.win", cat="serve",
                                    host=host.host_id, epoch=copy.epoch)
            self._cancel_losers(entry)
        # the batcher result contract: a single-sample submit resolves
        # to the output ROW, a block submit to the 2-D block — the
        # host's transport always replies 2-D, so unwrap singles here
        # (ServeService.infer_payload and the front's own binary
        # transport both rely on row semantics)
        entry.result = arr if entry.block or arr.ndim != 2 else arr[0]
        entry.error = None
        # tenant served counters are bumped at the HOST batcher (the
        # serving edge), never here: an in-process front + host pair
        # shares one registry and would double-count otherwise
        # end-to-end latency is anchored at the ORIGINAL front-door
        # arrival (entry.enqueued, stamped once in FleetRequest): a
        # requeue or hedge re-dispatch must never restart the clock
        entry.latency = now - entry.enqueued
        self._m_latency.observe(entry.latency)
        # per-class END-TO-END latency under the FLEET name (distinct
        # from the host batcher's serve.tenant.* serving-edge series,
        # which an in-process front+host pair would double-count):
        # this is the digest the fleet-scoped SLO burn rules watch —
        # it includes transport stalls the batcher clock never sees
        _registry.histogram(
            "serve.fleet.%s.latency_s" % entry.slo_class).observe(
                entry.latency)
        self._latencies.append(entry.latency)
        entry.done.set()
        self._emit_entry(entry, now)
        self._maybe_emit_pair(entry)

    @staticmethod
    def _leg_segments(msg):
        """The host's echoed per-segment totals off a result frame —
        defensively re-validated (plain floats, known segment names
        only) even though the link is HMAC-authenticated."""
        segs = (msg or {}).get("segs")
        if not isinstance(segs, dict):
            return None
        clean = {}
        for name in reqtrace.SEGMENTS:
            value = segs.get(name)
            if isinstance(value, (int, float)) and value >= 0:
                clean[name] = float(value)
        return clean or None

    def _emit_entry(self, entry, now):
        """Outside the lock: the front tier's request-scoped
        observability for one resolved entry — tail exemplar + (for
        sampled ids) a ``serve.request`` span with ``serve.req.leg``
        children on the entry's own request track.  Per-SEGMENT spans
        live on the HOST tracks under the same id; the merge stitch
        (observe/merge.py) is what joins the two tiers."""
        if not reqtrace.enabled:
            return
        start = entry.enqueued
        marks = []
        win_segs = None
        for leg in entry.legs:
            end = min(leg["end"] if leg["end"] is not None else now,
                      now)
            marks.append(("leg", leg["start"],
                          max(0.0, end - leg["start"])))
            if leg["outcome"] == "win" and leg["segs"]:
                win_segs = (leg["start"], leg["segs"])
        if win_segs is not None:
            # synthesize sequential segment marks from the winning
            # leg's echoed totals so the exemplar timeline carries a
            # real breakdown even when the host dump is not at hand
            cursor, segs = win_segs
            for name in reqtrace.SEGMENTS:
                if name in segs:
                    marks.append((name, cursor, segs[name]))
                    cursor += segs[name]
        reqtrace.exemplars.note(
            entry.trace, entry.latency, marks=marks, t0=start,
            slo_class=entry.slo_class,
            budget_s=qos.slo_budget_s(entry.slo_class), kind="fleet",
            extra={"hedges": entry.hedges,
                   "requeues": entry.requeues,
                   "legs": [{"host": leg["host"],
                             "hedge": leg["hedge"],
                             "outcome": leg["outcome"]}
                            for leg in entry.legs]})
        if entry.trace is None or not _tracer.active or \
                not reqtrace.sampled(entry.trace):
            return
        tid = _tracer.request_track((entry.trace, start),
                                    "req:%s" % entry.trace)
        _registry.counter("serve.reqtrace.sampled").inc()
        _tracer.complete(
            reqtrace.REQUEST_SPAN, start, max(0.0, now - start),
            cat="req", args={"trace": entry.trace, "tier": "fleet",
                             "slo_class": entry.slo_class,
                             "hedges": entry.hedges,
                             "requeues": entry.requeues,
                             "legs": len(entry.legs)}, tid=tid)
        for leg in entry.legs:
            # clamp to the parent span so a loser cancelled
            # microseconds after resolution still nests
            end = min(leg["end"] if leg["end"] is not None else now,
                      now)
            args = {"trace": entry.trace, "host": leg["host"],
                    "hedge": leg["hedge"]}
            if leg["outcome"]:
                args["outcome"] = leg["outcome"]
            _tracer.complete(
                reqtrace.LEG_SPAN, leg["start"],
                max(0.0, end - leg["start"]), cat="req", args=args,
                tid=tid)

    def _cancel_losers(self, entry):
        """Under the lock: retire every other live copy of a resolved
        entry and cancel it over the wire — unless chaos
        ``serve.hedge.lose_race`` says to skip the cancel, in which
        case the loser completes and its late result deterministically
        exercises the duplicate-rejection fence.

        The loser's burned time also PENALIZES its host's throughput
        EMA: the copy ran at least this long without answering, which
        bounds that host's rate from above.  Without the penalty a
        straggler whose slow copies always get cancelled never feeds
        the EMA a bad sample — it keeps its healthy rating, stays in
        rotation, and the fleet hedges forever instead of routing
        around a persistently sick host."""
        now = time.perf_counter()
        for wid, hid in list(entry.copies.items()):
            lcopy = self._wire.pop(wid, None)
            entry.copies.pop(wid, None)
            if lcopy is not None and lcopy.leg is not None and \
                    lcopy.leg["end"] is None:
                lcopy.leg["end"] = now
                lcopy.leg["outcome"] = "cancelled"
            loser = self._hosts.get(hid)
            if loser is None:
                continue
            loser.inflight.discard(wid)
            if lcopy is not None:
                self.fleet.observe_throughput(
                    hid, entry.rows / max(now - lcopy.sent_at, 1e-9))
            skip = chaos.plan is not None and \
                chaos.plan.fire("serve.hedge.lose_race") is not None
            if not skip and loser.state == "live":
                try:
                    loser.link.send_cancel(wid)
                except Exception:
                    pass  # the link will report its own death

    def _on_error(self, host, wid, exc):
        with self._lock:
            shadow = self._shadow_wire.pop(wid, None)
            if shadow is not None:
                # a failed mirror is lost evidence, never a failed
                # request — the primary copy answers the caller
                host.inflight.discard(wid)
                if self._canary is not None:
                    self._canary.shadow_errors += 1
                shadow.entry.mirror = None
                return
            copy = self._wire.pop(wid, None)
            if copy is None or copy.entry.resolved or \
                    copy.entry.cancelled:
                host.inflight.discard(wid)
                return
            entry = copy.entry
            host.inflight.discard(wid)
            entry.copies.pop(wid, None)
            if copy.leg is not None and copy.leg["end"] is None:
                copy.leg["end"] = time.perf_counter()
                copy.leg["outcome"] = "shed" \
                    if isinstance(exc, ServeOverload) else "error"
            if isinstance(exc, ServeOverload):
                # host-granular overload cascade: remember this host's
                # promise, try the next live sibling; only when every
                # live host shed does the FLEET shed — with the
                # smallest retry_after any host offered
                entry.sheds[copy.host_id] = exc.retry_after
                if entry.copies:
                    return  # a sibling copy still runs: let it win
                try:
                    self._send_copy(entry, exclude=set(entry.sheds))
                    self._m_cascades.inc()
                except ServeOverload as fleet_exc:
                    self._resolve_error(entry, fleet_exc)
                return
            if entry.copies:
                return  # the sibling copy may still succeed
            self._resolve_error(entry, exc)

    def _resolve_error(self, entry, exc):
        entry.resolved = True
        self._unresolved[entry.slo_class].discard(entry)
        for wid in list(entry.copies):
            self._wire.pop(wid, None)
        entry.copies.clear()
        entry.mirror = None
        self._m_failed.inc()
        entry.error = exc
        entry.done.set()

    # -- telemetry polling --------------------------------------------------

    def _on_telemetry(self, host_id, msg, t3):
        """One host's telemetry-poll reply (reader thread): the NTP
        echo closes a clock-probe sample (min-delay estimate, same as
        trace merging), the carried series chunk lands in the fleet
        merge, then the alert rules sweep the offset-corrected
        rollup.  The router's own alert manager is EDGE-triggered —
        a stall that keeps burning fires once, with the flight +
        exemplar evidence dump riding the firing."""
        telemetry = self.telemetry
        if telemetry is None:
            return
        t0, t1, t2 = msg.get("t0"), msg.get("t1"), msg.get("t2")
        if all(isinstance(t, (int, float)) for t in (t0, t1, t2)):
            # convention matches cluster.estimate_offset: host_wall +
            # offset = router_wall
            telemetry.add_probe(host_id, (t0, t1, t2, t3))
        chunk = msg.get("series")
        if chunk:
            telemetry.add_chunk(host_id, chunk)
        alerts = self.alerts
        if alerts is not None:
            fired = alerts.evaluate(
                telemetry.rollup(window=64),
                context={"scope": "fleet", "host": host_id})
            for record in fired:
                self.warning("fleet alert %s: %s", record["alert"],
                             record["reason"])

    def _poll_telemetry(self, now):
        if self.telemetry is None or \
                now - self._last_poll < self.telemetry_interval_s:
            return
        self._last_poll = now
        # the router's own process metrics join the merge as host
        # "front" (offset 0 by construction — it IS the reference
        # clock); front + host series then roll up in one pass
        try:
            from veles_tpu_torch.observe.timeseries import series
            series.maybe_tick()
            chunk = series.take_chunk(label="front")
            if chunk is not None:
                self.telemetry.add_chunk("front", chunk)
        except Exception:
            pass
        with self._lock:
            hosts = self._live_hosts()
        for host in hosts:
            try:
                host.link.send_telemetry_poll()
            except Exception:
                pass  # a dying link's reader handles the death

    # -- hedging watchdog ---------------------------------------------------

    def _watch_loop(self):
        while not self._stop_.wait(self.hedge_tick_s):
            now = time.perf_counter()
            self._poll_telemetry(now)
            if not self.hedge:
                continue
            with self._lock:
                if len(self._live_hosts()) < 2:
                    continue  # nobody to hedge to
                if len(self._latencies) < self.hedge_warmup:
                    # no evidence yet: a floor-collapsed threshold on
                    # a cold front would hedge-storm the first wave
                    continue
                mean = sum(self._latencies) / len(self._latencies)
                mean_tp = self._mean_throughput()
                for copy in list(self._wire.values()):
                    entry = copy.entry
                    if entry.resolved or entry.cancelled or \
                            len(entry.copies) != 1 or \
                            entry.hedges >= self.max_hedges:
                        continue
                    threshold = elastic.speculation_threshold(
                        mean, self.hedge_factor, self.hedge_floor_s,
                        owner_power=self._host_weight(copy.host_id,
                                                      mean_tp),
                        mean_power=mean_tp)
                    if now - copy.sent_at <= threshold:
                        continue
                    if self.hedge_budget is not None and \
                            not self.hedge_budget.try_take(
                                entry.slo_class):
                        # budget exhausted for this class: route
                        # normally — the primary copy stands, the
                        # request NEVER fails for lack of hedge tokens
                        continue
                    entry.hedges += 1
                    try:
                        self._send_copy(
                            entry,
                            exclude={copy.host_id} | set(entry.sheds),
                            hedge=True)
                    except ServeOverload:
                        entry.hedges -= 1  # retry a later tick
                        continue
                    self._m_hedges.inc()
                    if _tracer.active:
                        _tracer.instant(
                            "serve.hedge.fired", cat="serve",
                            owner=copy.host_id,
                            age_ms=round((now - copy.sent_at) * 1e3,
                                         3),
                            threshold_ms=round(threshold * 1e3, 3))

    # -- lifecycle (batcher duck-type) --------------------------------------

    @property
    def running(self):
        return self._watchdog is not None or \
            bool(self._live_hosts())

    def start(self):
        if (self.hedge or self.telemetry is not None) and \
                self._watchdog is None:
            self._stop_.clear()
            self._watchdog = threading.Thread(
                target=self._watch_loop, name="fleet-hedge")
            self._watchdog.start()
        return self

    def stop(self):
        self._stop_.set()
        watchdog, self._watchdog = self._watchdog, None
        if watchdog is not None:
            watchdog.join(timeout=10)
        with self._lock:
            hosts = list(self._hosts.values())
            self._hosts.clear()
            retired, self._retired = list(self._retired), []
            for host in hosts:
                # a front shutting down is not a host death: the
                # links' readers must not count membership losses
                if host.state == "live":
                    host.state = "leaving"
            # fail whatever is still pending: callers must not block
            # out their timeouts on a stopped front
            for copy in list(self._wire.values()):
                if not copy.entry.resolved:
                    self._resolve_error(
                        copy.entry,
                        ServeOverload("fleet front shutting down",
                                      retry_after=1.0))
            self._wire.clear()
            self._shadow_wire.clear()
            self._canary = None
            for pool in self._unresolved.values():
                pool.clear()
        for host in hosts:
            host.link.close()
        for link in retired:
            link.close()
        self._g_live.set(0)

    # -- canary slicing (fleet canary controller hooks) ---------------------

    def begin_canary_slice(self, host_id, fraction=0.25, seed=0,
                           on_pair=None):
        """Take ``host_id`` out of the routing rotation and mirror a
        seeded ``fraction`` of live single-sample traffic to it as
        shadow copies.  ``on_pair(primary_out, shadow_out,
        primary_latency, shadow_latency)`` fires (outside the lock)
        once BOTH sides of a mirrored request answered — the fleet
        canary controller's evidence stream.

        The host keeps draining its previously-assigned inflight work
        (it is ``canary``, not ``dead``); it just receives no new
        PRIMARY dispatches, so the staged candidate only ever answers
        shadow traffic until promotion."""
        with self._lock:
            if self._canary is not None:
                raise RuntimeError(
                    "a canary slice is already active on %r"
                    % self._canary.host_id)
            host = self._hosts.get(host_id)
            if host is None or host.state != "live":
                raise RuntimeError(
                    "cannot slice host %r: not a live host" % host_id)
            if not any(h.state == "live"
                       for h in self._hosts.values()
                       if h.host_id != host_id):
                raise RuntimeError(
                    "cannot slice host %r: no live sibling would "
                    "remain to serve primary traffic" % host_id)
            host.state = "canary"
            self._canary = _CanarySlice(host_id, fraction, seed,
                                        on_pair)
            if _tracer.active:
                _tracer.instant("serve.fleet.canary.begin",
                                cat="serve", host=host_id,
                                fraction=fraction)
            return self._canary

    def end_canary_slice(self):
        """Tear down the active slice: purge the shadow wire, restore
        the host to the routing rotation (unless it died mid-slice)
        and return the slice's evidence counters."""
        with self._lock:
            slice_, self._canary = self._canary, None
            if slice_ is None:
                return None
            for wid in list(self._shadow_wire):
                rec = self._shadow_wire.pop(wid)
                rec.entry.mirror = None
                host = self._hosts.get(rec.host_id)
                if host is not None:
                    host.inflight.discard(wid)
            host = self._hosts.get(slice_.host_id)
            if host is not None and host.state == "canary":
                host.state = "live"
            if _tracer.active:
                _tracer.instant("serve.fleet.canary.end", cat="serve",
                                host=slice_.host_id,
                                mirrored=slice_.mirrored,
                                pairs=slice_.pairs)
            return {"host_id": slice_.host_id,
                    "mirrored": slice_.mirrored,
                    "pairs": slice_.pairs,
                    "shadow_errors": slice_.shadow_errors,
                    "link_down": slice_.link_down}

    def host_inflight(self, host_id):
        """How many wire ids (primary + shadow) the host still owes —
        the controller drains this to 0 before staging a candidate so
        old-model work never mixes with new-model judging."""
        with self._lock:
            host = self._hosts.get(host_id)
            return len(host.inflight) if host is not None else 0

    def _maybe_emit_pair(self, entry):
        """Emit the (primary, shadow) judgment pair once both sides of
        a mirrored request answered.  The callback runs OUTSIDE the
        lock — comparator judging must never stall reader threads."""
        with self._lock:
            shadow = entry.mirror
            if shadow is None or shadow.out is None or \
                    entry.result is None or not entry.resolved:
                return
            entry.mirror = None
            slice_ = self._canary
            if slice_ is None:
                return
            slice_.pairs += 1
            on_pair = slice_.on_pair
        if on_pair is None:
            return
        try:
            on_pair(entry.result, shadow.out, entry.latency,
                    shadow.latency)
        except Exception:
            pass  # judging is evidence collection, never a fault path

    # -- metadata (pool duck-type) ------------------------------------------

    @property
    def engine(self):
        """The fleet's model profile (digest/dtype/sample shape/
        ladder), learned at the first host's handshake — what
        /healthz reports the fleet serves."""
        if self._profile is None:
            raise RuntimeError("fleet has no hosts yet")
        return self._profile

    @property
    def digest(self):
        return self._profile.digest if self._profile else None

    @property
    def compile_receipt(self):
        """Aggregate of the per-host hello re-warm receipts."""
        hosts = {hid: dict(h.info) for hid, h in self._hosts.items()}
        if not hosts:
            return None
        return {
            "hosts": hosts,
            "new_compiles": sum(
                h.get("new_compiles") or 0 for h in hosts.values()),
        }

    def reload(self, *args, **kwargs):
        raise RuntimeError(
            "the fleet front holds no model: reload/publish on the "
            "serve HOSTS (each runs its own freshness loop) and "
            "rejoin them")

    reload_workflow = reload

    # -- observability ------------------------------------------------------

    def snapshot(self):
        """Plain-data fleet state for /healthz and the dashboard."""
        with self._lock:
            hosts = {
                h.host_id: {
                    "state": h.state,
                    "inflight": len(h.inflight),
                    "throughput_ema": round(
                        self.fleet.throughput(h.host_id), 3),
                    "joined_epoch": h.joined_epoch,
                    "new_compiles": h.info.get("new_compiles"),
                }
                for h in self._hosts.values()}
            return {
                "hosts": hosts,
                "hosts_live": sum(1 for h in self._hosts.values()
                                  if h.state == "live"),
                "membership_epoch": self.fleet.membership_epoch,
                "digest": self.digest,
                "hedging": self.hedge,
                "hedges_fired": self._m_hedges.value,
                "hedge_wins": self._m_hedge_wins.value,
                "duplicates_dropped": self._m_dup.value,
                "requeues": self._m_requeues.value,
                "max_inflight": self.max_inflight,
                "unresolved": {
                    cls: len(pool)
                    for cls, pool in self._unresolved.items()},
                "canary": None if self._canary is None else {
                    "host_id": self._canary.host_id,
                    "fraction": self._canary.fraction,
                    "mirrored": self._canary.mirrored,
                    "pairs": self._canary.pairs,
                    "shadow_errors": self._canary.shadow_errors,
                },
                "telemetry": None if self.telemetry is None
                else self.telemetry.snapshot(),
                "alerts": None if self.alerts is None
                else self.alerts.snapshot(),
            }

    def fleet_rollup(self, window=None):
        """Offset-corrected fleet rollup buckets (empty when
        telemetry is off) — the ``observe fleet`` CLI's live
        counterpart."""
        if self.telemetry is None:
            return []
        return self.telemetry.rollup(window=window)
