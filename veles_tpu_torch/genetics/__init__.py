"""Hyper-parameter optimization by genetic algorithm.

Counterpart of ``veles_tpu/genetics/``: the GA core, the optimizer that
the command line's ``--optimize`` and the schedule autotuner
(:mod:`veles_tpu_torch.tune`) drive, and its farmed evaluations
(``farm_slaves`` / ``farm_address``, :mod:`veles_tpu_torch.jobfarm`).
"""

from veles_tpu_torch.genetics.core import (  # noqa: F401
    Chromosome, Population, gray_encode, gray_decode)
from veles_tpu_torch.genetics.config import (  # noqa: F401
    Tune, extract_tunes, apply_values)
from veles_tpu_torch.genetics.optimizer import GeneticsOptimizer  # noqa
