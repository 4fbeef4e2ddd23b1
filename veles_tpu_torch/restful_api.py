"""RESTful serving of a trained workflow.

Counterpart of ``veles_tpu/restful_api.py``: ``POST /api`` with
``{"input": ...}`` answers ``{"result", "probabilities"}``.  The unit is
a front over the port's serving subsystem (:mod:`veles_tpu_torch.serve`):
``initialize`` builds an :class:`~veles_tpu_torch.serve.AOTEngine` from
the workflow (its plans, a host copy of its weights taken then, the
loader's sample shape, its device: the card unless the workflow was
initialized on the CPU) and captures the ladder; the HTTP endpoint is
:class:`~veles_tpu_torch.serve.ServeService`'s, whose continuous batcher
co-batches concurrent requests into one dispatch and answers ``503``
with ``retry_after`` on overload.  ``infer()`` works with or without the
background server, ``requests_served`` counts the samples answered and
``stop()`` shuts the server down.  A workflow on no device (not
initialized) takes ``Device()``, which raises ``no CUDA device`` where
there is no card, before any socket opens.
"""

import numpy

from veles_tpu_torch.units import Unit

__all__ = ["RESTfulAPI"]


class RESTfulAPI(Unit):
    def __init__(self, workflow, **kwargs):
        super(RESTfulAPI, self).__init__(workflow, **kwargs)
        self.port = kwargs.get("port", 0)
        self.path = kwargs.get("path", "/api")
        #: serving knobs (the JAX package's defaults)
        self.ladder = tuple(kwargs.get("ladder", (1, 8, 32, 128)))
        self.max_delay_s = kwargs.get("max_delay_s", 0.002)
        self.max_queue = kwargs.get("max_queue", 256)
        self.slo_p50_ms = kwargs.get("slo_p50_ms")
        self.slo_p99_ms = kwargs.get("slo_p99_ms")
        self.engine = None
        self._service_ = None
        self.restartable = False  # stop() shuts the HTTP server down

    @property
    def requests_served(self):
        return (self._service_.samples_served
                if self._service_ is not None else 0)

    def initialize(self, **kwargs):
        super(RESTfulAPI, self).initialize(**kwargs)
        from veles_tpu_torch.serve import AOTEngine, ServeService
        loader = getattr(self.workflow, "loader", None)
        self.engine = AOTEngine.from_workflow(
            self.workflow, ladder=self.ladder,
            device=kwargs.get("device"))
        self.engine.compile()
        self._service_ = ServeService(
            self.engine, port=self.port, path=self.path,
            labels_mapping=getattr(loader, "reversed_labels_mapping",
                                   None),
            max_delay_s=self.max_delay_s, max_queue=self.max_queue,
            slo_p50_ms=self.slo_p50_ms, slo_p99_ms=self.slo_p99_ms)
        return True

    def infer(self, sample):
        """``sample``: a nested list or array, with or without the batch
        dimension.  With the background server running, its rows
        co-batch with the HTTP traffic; without it they go through the
        engine in sequence."""
        if self._service_ is None:
            raise RuntimeError("initialize() the unit before infer()")
        if not self._service_.batcher.running:
            probs = self.engine.infer(
                numpy.asarray(sample, self.engine.dtype))
            with self._service_._served_lock:
                self._service_.samples_served += len(probs)
            from veles_tpu_torch.serve import format_result
            return format_result(probs, self._service_.labels_mapping)
        return self._service_.infer_payload(sample)

    # -- HTTP ---------------------------------------------------------------

    def start_background(self):
        thread = self._service_.start_background()
        self.port = self._service_.port
        self.info("REST API on http://127.0.0.1:%d%s (serve engine: "
                  "ladder %s)", self.port, self.path,
                  list(self.engine.ladder))
        return thread

    def stop(self):
        super(RESTfulAPI, self).stop()
        if self._service_ is not None:
            self._service_.stop()
