"""Inference serving, as in ``veles_tpu/serve``: the ladder engine
(:mod:`~veles_tpu_torch.serve.engine`) and the continuous batcher
(:mod:`~veles_tpu_torch.serve.batcher`).  The router, the service
fronts and the fleet tiers are not ported yet."""

from veles_tpu_torch.serve.batcher import (  # noqa: F401
    ContinuousBatcher, ServeOverload)
from veles_tpu_torch.serve.engine import (  # noqa: F401
    AOTEngine, DEFAULT_LADDER, engine_digest_extra, model_digest,
    value_digest)

__all__ = ["AOTEngine", "ContinuousBatcher", "DEFAULT_LADDER",
           "ServeOverload", "engine_digest_extra", "model_digest",
           "value_digest"]
