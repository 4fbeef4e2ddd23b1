"""Layer units (all2all, conv, pooling, dropout, transformer), the GD
units of the all2all family, the evaluators and decisions, the standard
and fused workflows, and the model zoo; counterpart of
``veles_tpu/models``."""
