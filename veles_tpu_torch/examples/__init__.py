"""Workflow files for ``python -m veles_tpu_torch <file> -``."""
