"""veles_tpu_torch.tune: the genetics-driven kernel schedule autotuner.

Counterpart of ``veles_tpu/tune/``.  The pieces:

- ``tune.cache``: the digest-keyed on-disk :class:`ScheduleCache` the
  kernels consult (``consult``, memoized and host-only), the
  ``record_specs`` walk hook and the ``tune.*`` counters, the fleet
  bank's export and merge, the ``measurements.jsonl`` sidecar;
- ``tune.spec``: the five families' search spaces over the port's
  launch parameters, their validation against a call and the card's
  limits, and the shared cache-key spec builders;
- ``tune.measure``: the one timing discipline (pass filtering,
  positive-majority ranking, interleaved round-robin sampling) on the
  card's clock;
- ``tune.costmodel``: the deterministic learned cost model (boosted
  stumps, pure numpy) with its leave-one-spec-out trust gate;
- ``tune.autotune``: the GA driver (:class:`ScheduleTuner`) and the
  plain candidate sweep (:func:`sweep_candidates`);
- ``tune.walk``: spec harvesting from one raw train step;
- ``python -m veles_tpu_torch.tune``: tune the shapes a zoo model uses
  and write a ``TUNE.json`` receipt.

A tuned schedule reaches the card through the normal entry points: the
wrappers consult the cache on every call, so a trainer's captured step
or a serving rung takes the schedules in the cache at its capture.
"""

from veles_tpu_torch.tune.cache import (  # noqa: F401
    MeasurementLog, ScheduleCache, cache_for, consult, default_cache_dir,
    device_kind, load_bank, measurement_log, provenance, record_specs,
    schedule_for, schedule_key, tune_counters)
from veles_tpu_torch.tune.measure import filter_passes  # noqa: F401
from veles_tpu_torch.tune.spec import (  # noqa: F401
    FAMILIES, attention_spec, conv_vjp_spec, family_for, matmul_int8_spec,
    matmul_spec, pool_bwd_spec, valid_schedule)

__all__ = ["ScheduleCache", "MeasurementLog", "cache_for", "consult",
           "measurement_log", "load_bank", "default_cache_dir",
           "device_kind", "provenance", "record_specs", "schedule_for",
           "schedule_key", "tune_counters", "filter_passes",
           "FAMILIES", "family_for", "matmul_spec", "matmul_int8_spec",
           "conv_vjp_spec", "pool_bwd_spec", "attention_spec",
           "valid_schedule"]
