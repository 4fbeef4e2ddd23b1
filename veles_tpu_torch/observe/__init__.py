"""Observability, as in ``veles_tpu/observe``.  Ported so far: the
metrics registry (:mod:`~veles_tpu_torch.observe.metrics`), which the
serve tier's receipts read.  The tracer, request tracing, the flight
recorder, alerts and the rest wait for ROADMAP.md Queue 1 item 11."""
