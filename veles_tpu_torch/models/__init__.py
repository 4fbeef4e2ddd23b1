"""Layer units (all2all, conv, pooling, dropout, activations,
deconv/depooling, transformer) and their GD units, the learning-rate
policies, the evaluators and decisions, the standard and fused
workflows, and the model zoo; counterpart of ``veles_tpu/models``."""
