"""Replica pool and request router: one engine and batcher per replica.

Counterpart of ``veles_tpu/serve/router.py``.  A **replica** is an
:class:`~veles_tpu_torch.serve.engine.AOTEngine` on one device plus its
own :class:`~veles_tpu_torch.serve.batcher.ContinuousBatcher` worker,
and the :class:`ReplicaPool` is the front:

- **placement**: one replica per visible CUDA card
  (``torch.cuda.device_count()``); ``replicas=`` asking for more cycles
  the cards, so on one card two replicas share ``cuda:0``, each engine
  with its own captured graphs and each worker on its own stream;
- **routing**: each request goes to the least-loaded live replica
  (queue depth at submit); an overloaded replica cascades the request
  to its siblings before the pool sheds with a :class:`ServeOverload`
  whose ``retry_after`` is the best any replica offered;
- **metrics**: per-replica ``serve.replica.N.*`` gauges beside the
  process-shared serve counters and histograms, ``serve.replicas`` and
  the aggregate ``serve.queue_depth``;
- **hot reload** (:func:`reload_replicas`): the same digest copies the
  new weights into every engine's graph buffers (``swap_params``, no
  new capture); a new digest captures a new engine per replica off the
  dispatch path, then each batcher cuts over between batches; the queue
  is never dropped;
- **canary** (:class:`CanaryCutover`): the mechanics of the freshness
  loop's begin, shadow, promote and rollback.

The compile receipts count captures where the JAX package counts
backend compiles: a reload's or a promotion's sums those of the
engines it compiled (:func:`_compiled`).  Reloads and promotions run
in ``serve.reload`` / ``serve.canary.promote`` tracer spans, the canary
transitions mark ``serve.canary`` instants, and
:meth:`ReplicaPool.snapshot` names the process alert manager's active
alerts.  The next rung up is :mod:`veles_tpu_torch.serve.fleet`: a
``FleetRouter`` front over many serve hosts, each one of these pools
behind its binary transport.
"""

import threading
import time

import numpy
import torch

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer
from veles_tpu_torch.serve.batcher import ContinuousBatcher, ServeOverload
from veles_tpu_torch.serve.engine import (
    AOTEngine, DEFAULT_LADDER, engine_digest_extra, model_digest,
    publish_quantized_state)

__all__ = ["CanaryCutover", "Replica", "ReplicaPool", "local_devices",
           "reload_replicas"]


def local_devices(count=None, backend="cuda"):
    """Device handles for a replica fleet: one
    :class:`~veles_tpu_torch.backends.Device` per visible CUDA card,
    cycled when ``count`` asks for more replicas than cards.  With
    ``backend="cpu"`` every replica runs on the CPU.  Raises without a
    card unless the CPU is asked for."""
    from veles_tpu_torch.backends import Device
    cards = torch.cuda.device_count() if backend == "cuda" else 1
    if backend == "cuda" and cards == 0:
        Device(backend)  # raises: no CUDA device
    n = int(count) if count else cards
    if n < 1:
        raise ValueError("need at least one replica")
    return [Device(backend=backend, device_index=i % cards)
            if backend == "cuda" else Device(backend="cpu")
            for i in range(n)]


class Replica(object):
    """One engine+batcher pair bound to one device."""

    __slots__ = ("index", "device", "engine", "batcher", "canary")

    def __init__(self, index, device, engine, batcher):
        self.index = index
        self.device = device
        self.engine = engine
        self.batcher = batcher
        #: True while this replica serves a candidate under canary: out
        #: of live rotation (never a routing pick or a cascade target),
        #: fed only mirrored shadow traffic
        self.canary = False


def _compiled(receipts):
    """``captures``, ``kernel_builds`` and ``new_compiles`` (their sum)
    over engine compile receipts: what a reload, a promotion or a
    rollback compiled (nothing, for weight swaps)."""
    captures = sum(r["captures"] for r in receipts)
    new = sum(r["new_compiles"] for r in receipts)
    return {"captures": captures, "kernel_builds": new - captures,
            "new_compiles": new}


def reload_replicas(replicas, params, plans=None, sample_shape=None,
                    ladder=None, engine_kwargs=None):
    """The one hot-reload state machine, shared by :class:`ReplicaPool`
    and the single-engine ``ServeService`` (a list of one Replica-shaped
    entry).  Callers hold their own reload lock.

    Same digest: each entry's weights are copied in place
    (``AOTEngine.swap_params``): no new capture.  New digest (or a
    ladder change): a new engine per entry is captured here, off the
    dispatch path, then each batcher cuts over between batches.
    Returns the receipt."""
    current = replicas[0].engine
    new_plans = list(plans) if plans is not None else current.plans
    new_shape = tuple(sample_shape) if sample_shape is not None \
        else current.sample_shape
    params = [dict(entry) for entry in params]
    # the engines' own digest recipe, the input dtype included: an f32
    # -> int8 reload is a different digest
    new_digest = model_digest(new_plans, params, new_shape,
                              extra=engine_digest_extra(current.dtype))
    same = (new_digest == current.digest and
            (ladder is None or
             tuple(sorted({int(b) for b in ladder})) == current.ladder))
    mode = "params" if same else "engine"
    start = time.perf_counter()
    compiled = []
    with _tracer.span("serve.reload", cat="serve", mode=mode,
                      digest=new_digest):
        if same:
            for rep in replicas:
                rep.engine.swap_params(params)
        else:
            kwargs = dict(engine_kwargs or {})
            if ladder is not None:
                kwargs["ladder"] = ladder
            fresh = []
            for rep in replicas:
                engine = AOTEngine(new_plans, params, new_shape,
                                   device=rep.device, **kwargs)
                compiled.append(engine.compile())
                fresh.append(engine)
            # warmed: cut over, oldest first
            for rep, engine in zip(replicas, fresh):
                rep.batcher.swap_engine(engine)
                rep.engine = engine
    receipt = dict(
        _compiled(compiled), mode=mode, digest=new_digest,
        previous_digest=current.digest, replicas=len(replicas),
        seconds=round(time.perf_counter() - start, 4))
    _registry.counter("serve.reloads").inc()
    publish_quantized_state(replicas[0].engine.quantized)
    return receipt


class CanaryCutover(Logger):
    """The canary state machine of the freshness loop: how a candidate
    digest enters a pool, earns (or loses) its place, and how the pool
    snaps back.

    States: ``idle`` -> ``canary`` (one replica serves the candidate,
    fed only mirrored shadow traffic) -> ``promoting`` (a rolling
    between-batches cutover of the live replicas) -> ``idle``; or
    ``canary`` / ``promoting`` -> ``idle`` through :meth:`rollback`.

    Every transition that replaces a replica's engine saves the previous
    (captured) engine, and every same-digest swap saves the previous
    params, so :meth:`rollback` only swaps back: no new capture.  The
    policy (watcher, mirroring, verdicts) lives in
    :mod:`veles_tpu_torch.serve.freshness`."""

    def __init__(self, pool):
        super(CanaryCutover, self).__init__()
        self.pool = pool
        self.state = "idle"
        self.digest = None           # candidate digest under test
        self._canary_index = None
        self._saved_engines = {}     # replica index -> pre-cutover engine
        self._saved_params = {}      # replica index -> pre-swap params
        # the pool's reload lock, shared: a cutover transition and a
        # reload exclude each other
        self._lock = pool._reload_lock
        self._m_promotions = _registry.counter(
            "serve.freshness.promotions")
        self._m_rollbacks = _registry.counter(
            "serve.freshness.rollbacks")

    @property
    def canary_replica(self):
        if self._canary_index is None:
            return None
        return self.pool.replicas[self._canary_index]

    @staticmethod
    def _await_engine(rep, engine, timeout=10.0):
        """Block until ``rep``'s worker adopted ``engine`` (swaps apply
        between batches; an idle worker within its 0.2 s queue poll)."""
        deadline = time.monotonic() + timeout
        while rep.batcher.engine is not engine and \
                rep.batcher.running and time.monotonic() < deadline:
            time.sleep(0.01)
        return rep.batcher.engine is engine

    def _unbegin(self, rep):
        rep.canary = False
        self._saved_engines = {}
        self._canary_index = None

    def begin(self, engine):
        """Enter ``canary``: the highest-index live replica drains its
        queue, swaps to the (compiled) candidate ``engine`` between
        batches and leaves live rotation.  Replica 0 stays live: it is
        the pool's metadata anchor."""
        with self._lock:
            if self.state != "idle":
                raise RuntimeError(
                    "canary cutover already in state %r" % self.state)
            if engine.compile_receipt is None:
                raise RuntimeError(
                    "begin() needs a compiled candidate engine")
            live = self.pool._live()
            if len(live) < 2:
                raise RuntimeError(
                    "canary cutover needs >= 2 live replicas (one keeps "
                    "serving while one tests the candidate); use "
                    "ReplicaPool.reload for a single-replica pool")
            rep = live[-1]
            saved = rep.engine
            self._saved_engines = {rep.index: saved}
            self._saved_params = {}
            self._canary_index = rep.index
            rep.canary = True
            # drain before posting the swap: requests already queued
            # were promised the live model
            deadline = time.monotonic() + 10.0
            while (rep.batcher._q.qsize() or
                   rep.batcher._carry is not None) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            if rep.batcher._q.qsize() or rep.batcher._carry is not None:
                self._unbegin(rep)
                raise RuntimeError(
                    "canary replica %d queue never drained; aborting "
                    "begin" % rep.index)
            rep.batcher.swap_engine(engine)
            rep.engine = engine
            if not self._await_engine(rep, engine):
                rep.batcher.swap_engine(saved)
                rep.engine = saved
                self._unbegin(rep)
                raise RuntimeError(
                    "canary replica %d did not adopt the candidate "
                    "engine within the swap window; aborting begin" %
                    rep.index)
            self.digest = engine.digest
            self.state = "canary"
            _tracer.instant("serve.canary", cat="serve", phase="begin",
                            replica=rep.index, digest=engine.digest)
            self.info("canary begun on replica %d: candidate digest %s",
                      rep.index, engine.digest)
            return rep

    def shadow(self, sample, trace=None):
        """Mirror one sample to the canary replica (best-effort, lock
        free); returns the shadow request or None."""
        rep = self.canary_replica if self.state == "canary" else None
        if rep is None:
            return None
        return rep.batcher.submit_shadow(sample, trace=trace)

    def promote(self):
        """The candidate judged healthy: roll it pool-wide.  Live
        replicas on the candidate's digest swap params in place; a
        digest change captures a new engine per replica, then cuts over
        between batches, one replica at a time.  The canary replica
        rejoins rotation last.  Returns the promotion receipt."""
        with self._lock:
            if self.state != "canary":
                raise RuntimeError(
                    "promote() from state %r (need 'canary')" %
                    self.state)
            self.state = "promoting"
            pool = self.pool
            canary = self.canary_replica
            candidate = canary.engine
            start = time.perf_counter()
            compiled = []
            try:
                with _tracer.span("serve.canary.promote", cat="serve",
                                  digest=candidate.digest):
                    for rep in pool.replicas:
                        if rep.index == self._canary_index:
                            continue
                        if rep.engine.digest == candidate.digest:
                            self._saved_params.setdefault(
                                rep.index, rep.engine.params)
                            rep.engine.swap_params(candidate.params)
                            continue
                        engine = AOTEngine(
                            candidate.plans, candidate.params,
                            candidate.sample_shape, device=rep.device,
                            **dict(pool._engine_kwargs,
                                   ladder=candidate.ladder))
                        compiled.append(engine.compile())
                        self._saved_engines[rep.index] = rep.engine
                        rep.batcher.swap_engine(engine)
                        rep.engine = engine
                        if not self._await_engine(rep, engine):
                            raise RuntimeError(
                                "replica %d never adopted the promoted "
                                "engine" % rep.index)
            except Exception:
                # a failed mid-roll promotion must not strand a mixed
                # pool: snap every replica already cut back
                self.exception(
                    "promotion of %s failed mid-roll; rolling back",
                    candidate.digest)
                self.rollback(reason="promotion failed")
                raise
            canary.canary = False
            self._canary_index = None
            self._saved_engines = {}
            self._saved_params = {}
            self.digest = None
            self.state = "idle"
            self._m_promotions.inc()
            publish_quantized_state(pool.engine.quantized)
            receipt = dict(
                _compiled(compiled), verdict="promoted",
                digest=candidate.digest, replicas=len(pool.replicas),
                seconds=round(time.perf_counter() - start, 4))
            _tracer.instant("serve.canary", cat="serve",
                            phase="promoted", digest=candidate.digest)
            self.info("canary PROMOTED pool-wide: %s (%d new compiles, "
                      "%.2fs)", candidate.digest,
                      receipt["new_compiles"], receipt["seconds"])
            return receipt

    def rollback(self, reason=""):
        """The candidate judged bad (or the promotion failed): restore
        the last good digest wherever it was displaced.  Swap-backs
        only, so ``new_compiles`` is 0."""
        with self._lock:
            if self.state not in ("canary", "promoting"):
                raise RuntimeError(
                    "rollback() from state %r (need 'canary' or "
                    "'promoting')" % self.state)
            pool = self.pool
            bad = self.digest
            start = time.perf_counter()
            for index, engine in self._saved_engines.items():
                rep = pool.replicas[index]
                rep.batcher.swap_engine(engine)
                rep.engine = engine
            for index, params in self._saved_params.items():
                pool.replicas[index].engine.swap_params(params)
            # the restored engines are live in their workers before any
            # replica rejoins rotation; one whose worker never adopts
            # stays out of rotation
            unadopted = [index for index, engine in
                         self._saved_engines.items()
                         if not self._await_engine(pool.replicas[index],
                                                   engine)]
            canary = self.canary_replica
            if canary is not None and canary.index not in unadopted:
                canary.canary = False
            for index in unadopted:
                pool.replicas[index].canary = True
                self.error(
                    "replica %d never adopted the restored engine; "
                    "leaving it out of live rotation (restart or reload "
                    "to recover it)", index)
            self._canary_index = None
            self._saved_engines = {}
            self._saved_params = {}
            self.digest = None
            self.state = "idle"
            self._m_rollbacks.inc()
            publish_quantized_state(pool.engine.quantized)
            receipt = dict(
                _compiled([]), verdict="rolled_back", digest=bad,
                restored_digest=pool.digest, reason=reason,
                seconds=round(time.perf_counter() - start, 4))
            if unadopted:
                receipt["unadopted_replicas"] = unadopted
            _tracer.instant("serve.canary", cat="serve",
                            phase="rolled_back", digest=bad,
                            reason=reason)
            self.warning(
                "canary ROLLED BACK: candidate %s rejected (%s); pool "
                "restored to %s with %d new compiles", bad,
                reason or "unspecified", receipt["restored_digest"],
                receipt["new_compiles"])
            return receipt

    def snapshot(self):
        """Plain-data state for /healthz (lock free)."""
        out = {"state": self.state}
        digest, index = self.digest, self._canary_index
        if digest is not None:
            out["candidate_digest"] = digest
        if index is not None:
            out["replica"] = index
        return out


class ReplicaPool(Logger):
    """N serving replicas behind one least-loaded router.

    Speaks the :class:`ContinuousBatcher` submit contract
    (``submit`` / ``submit_block`` / ``infer`` / ``start`` / ``stop``),
    so the HTTP service and the binary transport drive a pool and a
    single batcher alike.  ``devices`` (default :func:`local_devices`
    of ``backend``) places the replicas."""

    def __init__(self, plans, params, sample_shape, replicas=None,
                 ladder=DEFAULT_LADDER, devices=None, backend="cuda",
                 dtype=numpy.float32, **batcher_kwargs):
        super(ReplicaPool, self).__init__()
        if devices is None:
            devices = local_devices(replicas, backend=backend)
        elif replicas:
            devices = [devices[i % len(devices)]
                       for i in range(int(replicas))]
        self._engine_kwargs = dict(ladder=ladder, dtype=dtype)
        self._batcher_kwargs = dict(batcher_kwargs)
        self.replicas = []
        for i, device in enumerate(devices):
            engine = AOTEngine(plans, params, sample_shape,
                               device=device, **self._engine_kwargs)
            batcher = ContinuousBatcher(engine, replica=i,
                                        **self._batcher_kwargs)
            self.replicas.append(Replica(i, device, engine, batcher))
        self.compile_receipt = None
        # RLock: shared with CanaryCutover, whose promote() re-enters
        # through rollback() on a failed mid-roll
        self._reload_lock = threading.RLock()
        self.cutover = CanaryCutover(self)
        #: set by the freshness controller while a canary is live:
        #: ``hook(sample, primary_request)`` after every single-sample
        #: submit, to mirror a slice of the traffic
        self.mirror_hook = None
        self._m_replicas = _registry.gauge("serve.replicas")
        self._m_replicas.set(len(self.replicas))
        self._m_depth = _registry.gauge("serve.queue_depth")
        self._m_cascades = _registry.counter("serve.router.cascades")

    # -- workflow plumbing --------------------------------------------------

    @staticmethod
    def _workflow_spec(sw, sample_shape=None):
        """(plans, host params, sample shape) of a trained or restored
        StandardWorkflow; the params are read from the Arrays' host
        side (a restored snapshot has no device attached yet)."""
        from veles_tpu_torch.compiler import workflow_plan
        plans = workflow_plan(sw)
        params = []
        for fwd in sw.forwards:
            entry = {}
            for key, arr in (("weights", fwd.weights),
                             ("bias", fwd.bias)):
                if arr:
                    arr.map_read()
                    entry[key] = numpy.array(arr.mem, copy=True)
                else:
                    entry[key] = None
            params.append(entry)
        if sample_shape is None:
            loader = getattr(sw, "loader", None)
            if loader is not None and loader.minibatch_data:
                sample_shape = tuple(loader.minibatch_data.shape[1:])
            else:
                raise ValueError("workflow has no loader shape; pass "
                                 "sample_shape=")
        return plans, params, tuple(sample_shape)

    @classmethod
    def from_workflow(cls, sw, **kwargs):
        """Build a pool from a trained StandardWorkflow."""
        plans, params, sample_shape = cls._workflow_spec(
            sw, kwargs.pop("sample_shape", None))
        return cls(plans, params, sample_shape, **kwargs)

    # -- lifecycle ----------------------------------------------------------

    @property
    def engine(self):
        """The first live replica's engine: the pool's metadata anchor
        (digest, ladder, sample shape, dtype), live across reloads and
        canaries."""
        for rep in self.replicas:
            if not rep.canary:
                return rep.engine
        return self.replicas[0].engine

    @property
    def digest(self):
        return self.engine.digest

    def compile(self):
        """Capture every replica's ladder; returns the aggregate
        receipt."""
        start = time.perf_counter()
        per = [rep.engine.compile() for rep in self.replicas]
        self.compile_receipt = {
            "replicas": len(per),
            "rungs": per[0]["rungs"],
            "captures": sum(r["captures"] for r in per),
            "kernel_builds": max(r["kernel_builds"] for r in per),
            "new_compiles": sum(r["new_compiles"] for r in per),
            "seconds": round(time.perf_counter() - start, 4),
            "per_replica": per,
        }
        return self.compile_receipt

    @property
    def running(self):
        return any(rep.batcher.running for rep in self.replicas)

    def start(self):
        for rep in self.replicas:
            rep.batcher.start()
        return self

    def stop(self):
        for rep in self.replicas:
            rep.batcher.stop()
        self._m_depth.set(0)

    def set_host_tag(self, tag):
        """Give every replica's batcher the serving host's fleet
        identity, so its request spans carry ``host=<tag>``."""
        for rep in self.replicas:
            rep.batcher.set_host_tag(tag)

    # -- routing ------------------------------------------------------------

    def _update_depth(self):
        self._m_depth.set(sum(rep.batcher._q.qsize()
                              for rep in self.replicas))

    def _live(self):
        """Replicas in live rotation (a canary replica is neither a
        pick nor a cascade target); all of them if every one is
        canary."""
        live = [rep for rep in self.replicas if not rep.canary]
        return live or self.replicas

    def _submit(self, fn):
        """Least-queue-depth pick with overload cascade: live replicas
        in depth order; when every one sheds, the pool sheds with the
        smallest ``retry_after`` offered."""
        for _ in range(3):
            ranked = sorted(self._live(),
                            key=lambda rep: rep.batcher._q.qsize())
            sheds = []
            for nth, rep in enumerate(ranked):
                try:
                    req = fn(rep.batcher)
                except ServeOverload as exc:
                    sheds.append(exc)
                    continue
                if rep.canary:
                    # lost the race with CanaryCutover.begin(): cancel
                    # (the worker drops it) and route again
                    req.cancelled = True
                    continue
                if nth:
                    self._m_cascades.inc()
                self._update_depth()
                return req
            self._update_depth()
            if sheds:
                raise ServeOverload(
                    "all %d live replicas shedding (%s)" %
                    (len(ranked), sheds[-1]),
                    retry_after=min(exc.retry_after for exc in sheds))
        raise ServeOverload("pool reconfiguring", retry_after=0.1)

    def submit(self, sample, slo_class=None, trace=None):
        req = self._submit(
            lambda batcher: batcher.submit(sample, slo_class=slo_class,
                                           trace=trace))
        hook = self.mirror_hook
        if hook is not None:
            try:
                hook(sample, req)
            except Exception:
                # mirroring observes: it never fails the request
                self.exception("canary mirror hook failed")
        return req

    def submit_block(self, block, slo_class=None, trace=None):
        return self._submit(
            lambda batcher: batcher.submit_block(
                block, slo_class=slo_class, trace=trace))

    def infer(self, sample, timeout=30.0, slo_class=None, trace=None):
        """Blocking submit through the router (one sample)."""
        return self._wait(
            self.submit(sample, slo_class=slo_class, trace=trace),
            timeout)

    def infer_block(self, block, timeout=30.0, slo_class=None,
                    trace=None):
        """Blocking whole-batch submit: one request, the result the
        2-D block."""
        return self._wait(
            self.submit_block(block, slo_class=slo_class, trace=trace),
            timeout)

    @staticmethod
    def _wait(req, timeout):
        if not req.done.wait(timeout):
            raise TimeoutError("inference timed out after %.1fs"
                               % timeout)
        if req.error is not None:
            raise req.error
        return req.result

    # -- snapshot hot-reload ------------------------------------------------

    def reload(self, params, plans=None, sample_shape=None,
               ladder=None):
        """Swap the served model under load; returns the reload receipt
        (:func:`reload_replicas`).  No queued request is dropped."""
        with self._reload_lock:
            if self.cutover.state != "idle":
                raise RuntimeError(
                    "hot-reload refused: canary cutover in progress "
                    "(state %r); promote or roll back first" %
                    self.cutover.state)
            receipt = reload_replicas(
                self.replicas, params, plans=plans,
                sample_shape=sample_shape, ladder=ladder,
                engine_kwargs=self._engine_kwargs)
            # a full reload makes every replica alike again: one left
            # out of rotation by a rollback rejoins here
            for rep in self.replicas:
                rep.canary = False
            self.info(
                "hot reload (%s): %s -> %s in %.2fs, %d new compiles",
                receipt["mode"], receipt["previous_digest"],
                receipt["digest"], receipt["seconds"],
                receipt["new_compiles"])
            return receipt

    def reload_workflow(self, sw):
        """Reload from a (re)trained workflow or a restored snapshot."""
        try:
            plans, params, shape = self._workflow_spec(sw)
        except ValueError:
            plans, params, shape = self._workflow_spec(
                sw, self.engine.sample_shape)
        return self.reload(params, plans=plans, sample_shape=shape)

    # -- observability ------------------------------------------------------

    def snapshot(self):
        """Plain-data pool state for /healthz."""
        out = {
            "replicas": len(self.replicas),
            "digest": self.digest,
            "queue_depths": [rep.batcher._q.qsize()
                             for rep in self.replicas],
            "devices": ["%s:%d" % (rep.device.backend_name,
                                   rep.device.device_index)
                        for rep in self.replicas],
        }
        if self.cutover.state != "idle":
            out["canary"] = self.cutover.snapshot()
        # the process-global alert manager: what burns, beside the
        # queue depths it burns about
        from veles_tpu_torch.observe.alerts import alerts
        active = alerts.active()
        if alerts.rules or active:
            out["alerts_active"] = sorted(r["alert"] for r in active)
        return out
