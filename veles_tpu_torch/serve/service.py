"""HTTP front of the serve tier.

Counterpart of ``veles_tpu/serve/service.py``: the same routes and
bodies over the standard library's threaded HTTP server
(:mod:`veles_tpu_torch.http_util`), one thread a connection, so
concurrent clients co-batch in the batcher.

- ``POST <path> {"input": sample-or-batch}`` answers ``{"result":
  label(s), "probabilities": [...]}`` (:func:`format_result`); overload
  answers ``503 {"error", "retry_after"}`` with a ``Retry-After``
  header; ``tenant`` and ``slo_class`` (body fields, or the
  ``X-Tenant`` / ``X-SLO-Class`` headers) label the request for the QoS
  layer;
- ``GET /healthz``: the serve health block, the compile receipt, the
  model digest, the replica pool's (or the fleet front's) state, the
  freshness loop's and the alert history;
- ``GET /metrics.json``: the metrics registry's snapshot;
- ``POST /reload {"snapshot": path}``: hot-swap the served model;
- ``POST /publish``: wake the freshness loop's watcher now.

The engine may also be a :class:`~veles_tpu_torch.serve.fleet.
FleetRouter`: the service is then the front over remote serve hosts,
and ``/healthz`` carries the ``fleet`` block and the router's own alert
manager.  Request trace ids (the ``trace`` body field, else the
``X-Trace-Id`` header) are validated or minted per payload, stamped on
every row's request with the front's ``admit`` segment, and echoed as
the answer's ``trace``.
"""

import json
import threading
import time

import numpy

from veles_tpu_torch.http_util import BackgroundHTTPServer
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.observe import requests as reqtrace
from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.serve import qos
from veles_tpu_torch.serve.batcher import (ContinuousBatcher,
                                           ServeOverload, serve_snapshot)

__all__ = ["ServeService", "format_result"]


def format_result(probs, labels_mapping=None):
    """Shape a probability block into the REST answer: argmax label(s)
    through the loader's reverse mapping, plus the raw probabilities,
    boxed in one ``tolist`` over the whole block."""
    if not isinstance(probs, numpy.ndarray):
        probs = numpy.asarray(probs)
    single = probs.ndim == 1
    block = probs[None] if single else probs
    labels = block.argmax(axis=1)
    if labels_mapping:
        named = [labels_mapping.get(int(label), int(label))
                 for label in labels]
    else:
        named = labels.tolist()
    return {"result": named[0] if single or len(named) == 1 else named,
            "probabilities": block.tolist()}


class ServeService(Logger):
    """The HTTP service over an :class:`AOTEngine` and a batcher, a
    whole :class:`ReplicaPool`, or a ``FleetRouter`` front.

    ``engine`` is an engine (``batcher`` optionally shared; else one is
    built from ``batcher_kwargs`` and owned), a ``ReplicaPool``, whose
    least-loaded router then takes every request, or a ``FleetRouter``
    over serve hosts: both speak the batcher's submit contract.
    ``transport_port`` also opens the binary frame listener
    (:mod:`veles_tpu_torch.serve.transport`) over the same batcher or
    pool, so JSON and binary clients co-batch."""

    def __init__(self, engine, batcher=None, port=0, path="/infer",
                 labels_mapping=None, transport_port=None,
                 transport_secret=None, freshness=None, quota=None,
                 retry_jitter=None, **batcher_kwargs):
        super(ServeService, self).__init__()
        #: per-tenant admission quota (qos.TenantQuota), shared with the
        #: binary transport; None: no quota
        self.quota = quota
        self.retry_jitter = retry_jitter if retry_jitter is not None \
            else qos.RetryJitter()
        from veles_tpu_torch.serve.fleet import FleetRouter
        from veles_tpu_torch.serve.router import ReplicaPool
        self._is_fleet = isinstance(engine, FleetRouter)
        if isinstance(engine, (ReplicaPool, FleetRouter)):
            self.router = engine
            self._engine = None
            self._owns_batcher = True
            self.batcher = engine  # the same submit contract
        else:
            self.router = None
            self._engine = engine
            self._owns_batcher = batcher is None
            self.batcher = batcher if batcher is not None else \
                ContinuousBatcher(engine, **batcher_kwargs)
        self.path = path
        self.labels_mapping = labels_mapping or {}
        self.samples_served = 0
        self.last_reload = None
        self._served_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._server = None
        self._port = port
        self._transport = None
        self._transport_port = transport_port
        self._transport_secret = transport_secret
        #: an optional FreshnessController, referenced, not owned: the
        #: service adds ``POST /publish`` and the /healthz block
        self.freshness = freshness

    @property
    def engine(self):
        """The (anchor) engine, live across hot reloads."""
        return self.router.engine if self.router is not None \
            else self._engine

    @property
    def compile_receipt(self):
        source = self.router if self.router is not None else self.engine
        return source.compile_receipt

    @property
    def port(self):
        return self._server.port if self._server is not None \
            else self._port

    @property
    def transport_port(self):
        return self._transport.port if self._transport is not None \
            else self._transport_port

    # -- request handling ---------------------------------------------------

    def infer_payload(self, sample, tenant=None, slo_class=None,
                      trace=None):
        """Blocking inference for one payload, a sample or a batch.  A
        batch is submitted row by row, so its rows co-batch with every
        other request in flight; a payload that sheds partway cancels
        the rows already queued.  The tenant's quota is charged per
        sample, once for the payload.  ``trace`` is the request trace
        id: a client's is validated (``normalize_trace_id``), an absent
        or invalid one minted, every row shares it and the answer
        echoes it."""
        slo_class = qos.normalize_class(slo_class)
        if reqtrace.enabled:
            trace = reqtrace.normalize_trace_id(trace) or \
                reqtrace.mint_trace_id()
            t_admit = time.perf_counter()
        else:
            trace = None
            t_admit = None
        x = numpy.asarray(sample, self.engine.dtype)
        if x.shape == self.engine.sample_shape:
            x = x[None]
        if self.quota is not None:
            wait = self.quota.admit(tenant, cost=float(x.shape[0]))
            if wait is not None:
                qos.note_shed(slo_class)
                raise ServeOverload(
                    "tenant %r over quota" % (tenant,),
                    retry_after=self.retry_jitter.apply(
                        max(wait, 0.05), slo_class))
        requests = []
        try:
            for row in x:
                req = self.batcher.submit(row, slo_class=slo_class,
                                          trace=trace)
                if t_admit is not None and \
                        getattr(req, "marks", 0) is None:
                    # the front door's admission segment (decode and
                    # quota); the worker appends its marks behind it
                    req.marks = [("admit", t_admit,
                                  req.enqueued - t_admit)]
                requests.append(req)
        except Exception:
            for req in requests:
                req.cancelled = True
            raise
        probs = []
        for req in requests:
            if not req.done.wait(30.0):
                raise TimeoutError("inference timed out")
            if req.error is not None:
                raise req.error
            probs.append(req.result)
        with self._served_lock:
            self.samples_served += len(probs)
        block = probs[0][None] if len(probs) == 1 \
            else numpy.stack(probs)
        answer = format_result(block, self.labels_mapping)
        if trace is not None:
            answer["trace"] = trace
        return answer

    # -- snapshot hot-reload ------------------------------------------------

    def reload_snapshot(self, path):
        """Swap the served model for a trained-workflow snapshot without
        dropping the queue; returns the reload receipt (``POST
        /reload`` and SIGHUP in the serve command)."""
        from veles_tpu_torch.workflow import restore_workflow
        return self.reload_workflow(restore_workflow(path))

    def reload_workflow(self, sw):
        if self.router is not None:
            receipt = self.router.reload_workflow(sw)
        else:
            from veles_tpu_torch.serve.router import ReplicaPool
            try:
                plans, params, shape = ReplicaPool._workflow_spec(sw)
            except ValueError:
                plans, params, shape = ReplicaPool._workflow_spec(
                    sw, self.engine.sample_shape)
            receipt = self.reload(params, plans=plans,
                                  sample_shape=shape)
        self.last_reload = receipt
        return receipt

    def reload(self, params, plans=None, sample_shape=None):
        """Hot reload through the one shared state machine
        (:func:`~veles_tpu_torch.serve.router.reload_replicas`); the
        single-engine service is a pool of one entry."""
        if self.router is not None:
            receipt = self.router.reload(
                params, plans=plans, sample_shape=sample_shape)
            self.last_reload = receipt
            return receipt
        from veles_tpu_torch.serve.router import Replica, reload_replicas
        with self._reload_lock:
            current = self.engine
            entry = Replica(0, current.device, current, self.batcher)
            receipt = reload_replicas(
                [entry], params, plans=plans,
                sample_shape=sample_shape,
                engine_kwargs=dict(ladder=current.ladder,
                                   dtype=current.dtype))
            self._engine = entry.engine
        self.last_reload = receipt
        return receipt

    # -- HTTP ---------------------------------------------------------------

    def _app(self, method, path, headers, body):
        if method == "POST" and path == self.path:
            return self._http_infer(headers, body)
        if method == "GET" and path == "/healthz":
            return 200, None, self.health()
        if method == "GET" and path == "/metrics.json":
            return 200, {"Content-Type": "application/json"}, json.dumps(
                _registry.snapshot(), default=repr).encode("utf-8")
        if method == "POST" and path == "/reload":
            return self._http_reload(body)
        if method == "POST" and path == "/publish":
            return self._http_publish(body)
        return 404, None, {"error": "no route %s %s" % (method, path)}

    def _http_infer(self, headers, body):
        try:
            parsed = json.loads(body)
            payload = parsed["input"]
        except Exception as exc:
            return 400, None, {"error": "bad request: %s" % exc}
        # body fields win over headers; both optional
        tenant = parsed.get("tenant") or headers.get("X-Tenant")
        slo_class = parsed.get("slo_class") or headers.get("X-SLO-Class")
        # invalid or absent ids are minted anew in infer_payload
        trace = parsed.get("trace") or headers.get("X-Trace-Id")
        try:
            answer = self.infer_payload(payload, tenant=tenant,
                                        slo_class=slo_class, trace=trace)
        except ServeOverload as exc:
            return 503, {"Retry-After": "%.3f" % exc.retry_after}, {
                "error": str(exc), "retry_after": exc.retry_after}
        except (ValueError, TypeError) as exc:
            return 400, None, {"error": str(exc)}
        except Exception as exc:
            return 500, None, {"error": str(exc)}
        return 200, None, answer

    def health(self):
        """The ``/healthz`` body."""
        health = {
            "status": "ok",
            "model_digest": self.engine.digest,
            "ladder": list(self.engine.ladder),
            "compile": self.compile_receipt,
            "serve": serve_snapshot(),
        }
        if self.router is not None:
            health["fleet" if self._is_fleet else
                   "replicas"] = self.router.snapshot()
        if self.transport_port is not None:
            health["transport_port"] = self.transport_port
        if self.last_reload is not None:
            health["last_reload"] = self.last_reload
        if self.freshness is not None:
            health["freshness"] = self.freshness.snapshot()
        # the alert history: a fleet front reports its router's own
        # manager (the one sweeping fleet rollups), the rest the
        # process-global one
        manager = getattr(self.router, "alerts", None) \
            if self.router is not None else None
        if manager is None:
            from veles_tpu_torch.observe.alerts import alerts as manager
        health["alerts"] = manager.snapshot()
        return health

    def _http_reload(self, body):
        try:
            snapshot = json.loads(body or b"{}")["snapshot"]
        except Exception as exc:
            return 400, None, {"error": "bad request (need "
                               "{\"snapshot\": path}): %s" % exc}
        try:
            # on this request's thread: the others keep serving while
            # the new weights warm up
            receipt = self.reload_snapshot(snapshot)
        except FileNotFoundError as exc:
            return 404, None, {"error": str(exc)}
        except Exception as exc:
            return 500, None, {"error": str(exc)}
        return 200, None, receipt

    def _http_publish(self, body):
        """Freshness push: the body's ``snapshot`` path is advisory; the
        watcher still reads LATEST and verifies the manifest before
        unpickling."""
        if self.freshness is None:
            return 409, None, {"error": "no freshness loop attached "
                               "(start the service with a "
                               "FreshnessController / --watch-dir)"}
        try:
            parsed = json.loads(body or b"{}")
        except Exception as exc:
            return 400, None, {"error": "bad request: %s" % exc}
        self.freshness.notify(parsed.get("snapshot"))
        return 200, None, {"status": "notified",
                           "freshness": self.freshness.snapshot()}

    def start_background(self):
        if self._owns_batcher:
            self.batcher.start()
        if self._transport_port is not None:
            from veles_tpu_torch.serve.transport import \
                BinaryTransportServer
            self._transport = BinaryTransportServer(
                self.batcher, port=self._transport_port,
                secret=self._transport_secret, quota=self.quota,
                retry_jitter=self.retry_jitter)
            self._transport.start_background()
        self._server = BackgroundHTTPServer(self._app, port=self._port)
        thread = self._server.start()
        self.info("serve endpoint on http://127.0.0.1:%d%s "
                  "(healthz, metrics.json%s)", self.port, self.path,
                  "; binary transport :%d" % self.transport_port
                  if self._transport is not None else "")
        return thread

    def stop(self):
        # close the listeners (no new work), then fail the batcher's
        # pending requests (unblocks the handler threads)
        if self._transport is not None:
            self._transport.stop()
            self._transport = None
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._owns_batcher:
            self.batcher.stop()
