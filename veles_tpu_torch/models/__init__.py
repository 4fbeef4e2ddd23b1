"""Layer units (all2all, conv, pooling, dropout, activations,
deconv/depooling, transformer) and their GD units, the learning-rate
policies, the evaluators and decisions, the standard and fused
workflows, the model zoo, and the self-organising map and RBM units;
counterpart of ``veles_tpu/models``."""

from veles_tpu_torch.models.kohonen import KohonenForward, KohonenTrainer
from veles_tpu_torch.models.rbm import RBM

__all__ = ["KohonenForward", "KohonenTrainer", "RBM"]
