"""Harvest the kernel specs a model's train step really uses.

Counterpart of ``veles_tpu/tune/walk.py``.  Where the JAX walk lowers
the fused step once, the port runs ONE raw step
(``build_train_step(..., donate=False)``, never captured) on the device
being tuned, with seeded inputs, and takes two records of it:

1. **Consult recording.**  Every tunable kernel's wrapper consults the
   schedule cache with the step's real shapes (``conv_wgrad``,
   ``max_pool_bwd``, ``attention_fwd``; ``matmul`` and ``matmul_int8``
   where a path calls them); a :func:`~veles_tpu_torch.tune.cache.
   record_specs` context keeps those specs verbatim: the coordinates the
   kernels will look up.
2. **The dense products.**  The model layers' dense products run as
   library calls (``mm`` / ``addmm`` / ``matmul``), but the BLAS and
   serving paths route the same shapes through the port's matmul; a
   ``TorchDispatchMode`` records every 2-D ``aten.mm`` / ``aten.addmm``
   of the step, forward and backward, and each (M, K, N), normalized by
   the JAX walk's ``_mkn`` rule, becomes a matmul spec.  Products that a
   kernel's plain version runs inside ``veles_tpu_torch.ops`` (the CPU's
   wgrad per tap) are the kernel's own, not the model's, and are left
   out, as the JAX walk keeps the kernels' interpret-mode dots out.
"""

import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["collect_specs", "dot_specs"]


def _mkn(a0, a1, b0, b1, o0, o1):
    """(M, K, N) for a 2-D product with operand/result dims, tolerant of
    transposed contractions; None when the dims don't tell a
    consistent GEMM story (the JAX walk's rule)."""
    if a0 == o0 and b1 == o1 and a1 == b0:
        return o0, a1, o1          # (M,K) @ (K,N)
    if a1 == o0 and b1 == o1 and a0 == b0:
        return o0, a0, o1          # (K,M)^T @ (K,N)
    if a0 == o0 and b0 == o1 and a1 == b1:
        return o0, a1, o1          # (M,K) @ (N,K)^T
    if a1 == o0 and b0 == o1 and a0 == b1:
        return o0, a0, o1          # (K,M)^T @ (N,K)^T
    return None


def _inside_ops():
    """True when a frame of ``veles_tpu_torch.ops`` is on the stack: the
    product belongs to a kernel's plain version."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_globals.get("__name__", "").startswith(
                "veles_tpu_torch.ops."):
            return True
        frame = frame.f_back
    return False


class _DotRecorder(TorchDispatchMode):
    """Records (a shape, b shape, out shape, dtype) of every 2-D
    ``mm`` / ``addmm`` the dispatcher runs."""

    def __init__(self):
        super(_DotRecorder, self).__init__()
        self.dots = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = getattr(func, "overloadpacket", None)
        if packet is torch.ops.aten.mm:
            a, b = args[0], args[1]
        elif packet is torch.ops.aten.addmm:
            a, b = args[1], args[2]
        else:
            return out
        if a.ndim == 2 and b.ndim == 2 and out.ndim == 2 and \
                not _inside_ops():
            self.dots.append((tuple(a.shape), tuple(b.shape),
                              tuple(out.shape), a.dtype, b.dtype))
        return out


def dot_specs(dots, precision_level=0):
    """matmul tune specs for every distinct recorded 2-D product."""
    from veles_tpu_torch.tune.spec import matmul_spec
    specs, seen = [], set()
    for a_shape, b_shape, o_shape, dt_a, dt_b in dots:
        if dt_a != dt_b or dt_a not in (torch.float32, torch.bfloat16):
            continue
        dims = _mkn(*(a_shape + b_shape + o_shape))
        if dims is None:
            continue
        key = dims + (dt_a,)
        if key in seen:
            continue
        seen.add(key)
        specs.append(matmul_spec(*dims, str(dt_a)[6:], precision_level))
    return specs


def collect_specs(plans, state, batch, sample_shape, loss="softmax",
                  dtype="float32", precision_level=0, ops=None,
                  device=None, seed=0):
    """Run one raw train step and return the deduplicated tune-spec
    list it consulted (+ the dense-product matmul specs).

    ``plans`` / ``state`` as from ``models.zoo.build_plans_and_state``
    (host numpy state, the JAX layouts); ``device`` where the step runs
    (the card unless named); ``ops`` optionally restricts to a family
    subset (the CLI's ``--ops``).  The step's inputs are seeded."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.tune.cache import (device_kind, record_specs,
                                            schedule_key)

    if device is None:
        device = torch.device("cuda")
    device = torch.device(device)
    step_state = state_from_jax(state, Device(
        device.type, device.index if device.index is not None else 0))
    gen = torch.Generator().manual_seed(seed)
    tdtype = getattr(torch, dtype)
    x = (torch.rand((batch,) + tuple(sample_shape), generator=gen) * 2
         - 1).to(tdtype).to(device)
    width = int(state[-1]["weights"].shape[-1])
    if loss == "mse":
        y = torch.rand((batch, width), generator=gen).to(tdtype).to(device)
    else:
        y = torch.randint(0, width, (batch,), generator=gen,
                          dtype=torch.int32).to(device)
    step = build_train_step(plans, loss=loss, donate=False)
    recorder = _DotRecorder()
    with record_specs() as recorded:
        with recorder:
            step(step_state, x, y, float(batch))
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    specs = list(recorded)
    seen = {spec["digest"] for spec in specs}
    kind = device_kind(device)
    for spec in dot_specs(recorder.dots, precision_level):
        digest, _ = schedule_key(spec["op"], spec["shape"],
                                 spec["dtype"], spec["precision_level"],
                                 kind, spec.get("extra"))
        if digest in seen:
            continue
        seen.add(digest)
        specs.append(dict(spec, digest=digest, device_kind=kind))
    if ops:
        allowed = set(ops)
        specs = [s for s in specs if s["op"] in allowed]
    return specs
