"""Distributed training over device meshes, one process a rank.

Counterpart of ``veles_tpu/parallel/``: the JAX package shards one
program over a ``jax.sharding.Mesh`` and lets XLA insert the
collectives; the port runs one process a rank on ``torch.distributed``
(NCCL on the card, gloo on the CPU) and issues each collective itself.

- mesh.py        — DeviceMesh construction with named axes, the ZeRO-1
                   state layout and the elastic ``MeshManager``
- api.py         — placement helpers (each rank's part) and the DP/TP
                   sharding rules of the annotation path
- collectives.py — every collective, on an axis's process group,
                   counted; the differentiable ones as autograd
                   functions
- bucketed.py    — size-targeted gradient buckets all-reduced from the
                   backward's gradient hooks, and the ZeRO-1 helpers
- ring.py        — ring and Ulysses sequence-parallel attention, and
                   the explicit ring all-reduce
- pipeline.py    — the GPipe wavefront and the stage-split transformer
                   train step
- tensor.py      — the Megatron tensor-parallel transformer train step
- moe.py         — sharded mixture-of-experts
- analysis.py    — the collectives a step issues, by kind
"""

from veles_tpu_torch.parallel.mesh import make_mesh, auto_mesh  # noqa: F401
from veles_tpu_torch.parallel.api import (  # noqa: F401
    replicate, shard_batch, mlp_state_shardings, batch_sharding,
    shard_host_batch)
from veles_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention, ulysses_attention, ring_all_reduce)
from veles_tpu_torch.parallel.bucketed import (  # noqa: F401
    DEFAULT_BUCKET_MB, BucketPlan, plan_buckets, bucketed_all_reduce,
    flat_all_reduce, comm_receipt, publish_comm_receipt)
from veles_tpu_torch.parallel.tensor import build_tp_train_step  # noqa: F401
from veles_tpu_torch.parallel.pipeline import (  # noqa: F401
    build_pipeline_train_step)
from veles_tpu_torch.parallel.moe import moe_apply  # noqa: F401
