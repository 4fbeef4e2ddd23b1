"""Hyper-parameter optimization by genetic algorithm.

Counterpart of ``veles_tpu/genetics/``: the GA core that the schedule
autotuner (:mod:`veles_tpu_torch.tune`) drives.  Not ported: the
workflow's ``--optimize`` path and the job farm behind the optimizer's
``farm_slaves`` / ``farm_address`` (ROADMAP.md Queue 1 item 12).
"""

from veles_tpu_torch.genetics.core import (  # noqa: F401
    Chromosome, Population, gray_encode, gray_decode)
from veles_tpu_torch.genetics.config import (  # noqa: F401
    Tune, extract_tunes, apply_values)
from veles_tpu_torch.genetics.optimizer import GeneticsOptimizer  # noqa
