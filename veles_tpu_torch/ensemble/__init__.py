"""Ensembles: train N models, test by averaging their outputs.

Counterpart of ``veles_tpu/ensemble/``: ``--ensemble-train`` and
``--ensemble-test`` on the port, in process or farmed over the job farm
(:mod:`veles_tpu_torch.jobfarm`).
"""

from veles_tpu_torch.ensemble.workflows import (  # noqa: F401
    EnsembleTrainer, EnsembleTester)
