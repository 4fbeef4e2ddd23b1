"""Inference serving, as in ``veles_tpu/serve``:

- :mod:`~veles_tpu_torch.serve.engine`: :class:`AOTEngine`, a captured
  CUDA graph per rung of a ladder of padded batch shapes;
- :mod:`~veles_tpu_torch.serve.batcher`: :class:`ContinuousBatcher`,
  the worker draining the queue into the largest fitting rung, with
  SLO classes, class-ordered shedding (``ServeOverload`` -> 503 +
  ``retry_after``), shadow traffic, the out-of-memory degrade path,
  engine hot swap and the SLO watch;
- :mod:`~veles_tpu_torch.serve.router`: :class:`ReplicaPool`, replicas
  behind a least-loaded router with overload cascade, hot reload and
  the canary state machine;
- :mod:`~veles_tpu_torch.serve.transport`: the binary frame listener
  and client (``!IIB`` frames, a raw tensor codec, a same-host shared
  memory bypass);
- :mod:`~veles_tpu_torch.serve.service`: :class:`ServeService`, the
  HTTP front (``/infer``, ``/healthz``, ``/metrics.json``, ``/reload``,
  ``/publish``);
- :mod:`~veles_tpu_torch.serve.freshness`: the train-to-serve
  freshness loop (watcher, comparator, controller);
- :mod:`~veles_tpu_torch.serve.qos`: SLO classes, tenant quotas, hedge
  budgets and the seeded ``retry_after`` jitter;
- :mod:`~veles_tpu_torch.serve.fleet`: the multi-host tier,
  :class:`FleetRouter` over pipelined :class:`HostLink` connections
  (membership epochs, hedged tails, exactly-once requeue, the fleet
  canary slice, telemetry polls and the router's alerts).

``python -m veles_tpu_torch.serve --snapshot model.pickle`` serves a
trained snapshot; ``--fleet-host`` and ``--fleet`` run a fleet's hosts
and its front.
"""

from veles_tpu_torch.serve.qos import (  # noqa: F401
    DEFAULT_CLASS, HedgeBudget, RetryJitter, SHED_ORDER, SLO_CLASSES,
    TenantQuota, TokenBucket, normalize_class, parse_quota_spec)
from veles_tpu_torch.serve.batcher import (  # noqa: F401
    ContinuousBatcher, ServeOverload, serve_snapshot)
from veles_tpu_torch.serve.engine import (  # noqa: F401
    AOTEngine, DEFAULT_LADDER, engine_digest_extra, model_digest,
    value_digest)
from veles_tpu_torch.serve.freshness import (  # noqa: F401
    CanaryComparator, FleetCanaryController, FreshnessController,
    LocalHostControl, SnapshotWatcher, export_model_spec)
from veles_tpu_torch.serve.fleet import (  # noqa: F401
    FleetRequest, FleetRouter, HostLink)
from veles_tpu_torch.serve.router import (  # noqa: F401
    CanaryCutover, Replica, ReplicaPool, local_devices)
from veles_tpu_torch.serve.service import (  # noqa: F401
    ServeService, format_result)
from veles_tpu_torch.serve.transport import (  # noqa: F401
    BinaryTransportClient, BinaryTransportServer, decode_tensor,
    encode_tensor)

__all__ = ["AOTEngine", "BinaryTransportClient",
           "BinaryTransportServer", "CanaryComparator",
           "CanaryCutover", "ContinuousBatcher", "FleetCanaryController",
           "FleetRequest", "FleetRouter", "FreshnessController",
           "HedgeBudget", "HostLink", "LocalHostControl", "Replica",
           "ReplicaPool", "RetryJitter",
           "ServeOverload", "ServeService", "SnapshotWatcher",
           "TenantQuota", "TokenBucket", "DEFAULT_CLASS",
           "DEFAULT_LADDER", "SHED_ORDER", "SLO_CLASSES",
           "decode_tensor", "encode_tensor", "engine_digest_extra",
           "export_model_spec", "format_result", "local_devices",
           "model_digest", "normalize_class", "parse_quota_spec",
           "serve_snapshot", "value_digest"]
