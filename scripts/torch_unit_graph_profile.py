#!/usr/bin/env python3
"""Where a minibatch of the PyTorch/CUDA port's unit graph spends its
time on the card.

    python3 scripts/torch_unit_graph_profile.py [--mode raw|graph]
        [--out PATH]

Builds chip_smoke.py's MNIST workflow (784 -> all2all_tanh 100 ->
softmax 10 at minibatch 100, 60,000 + 10,000 seeded uint8 images) twice
and runs one epoch of each (800 minibatches) under ``torch.profiler``:
(i) per unit, with a ``MeanDispNormalizer`` unit in front of the first
layer (``root.common.engine.auto_fuse = False``), and (ii) fused, the
loader normalizing on the host.  A first epoch of each runs untraced as
a warm-up.  Reports, per minibatch: the traced wall time, the device
busy time (summed kernel time) and the idle share (1 - busy / wall),
the kernels launched, the port's own kernels' device time
(``gather_minibatch``, ``mean_disp_normalize``), and the top kernels
by device time; with the card's name and power limit, as JSON, also
written to ``--out`` when given.  ``--mode graph`` runs the fused
trainer as the port does, on its captured steps; ``--mode raw`` forces
its eager route (the raw step, as under ``VELES_DEBUG_NONFINITE``,
without the guard); without ``--mode`` both run, each in its own
process (``scripts/torch_modes.py``), side by side.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: kernel-name fragments of the port's own kernels on this path
OURS = {"gather_minibatch": ("gather_vec4", "gather_scalar"),
        "mean_disp_normalize": ("normalize_vec4", "normalize_scalar")}


def device_time_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def profile_epoch(build):
    """Warm one epoch, then trace one; per-minibatch numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    build().run()
    sw = build()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sw.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    minibatches = sw.loader.run_calls
    kernels, counts = {}, {}
    for evt in prof.key_averages():
        us = device_time_us(evt)
        if us > 0 and evt.device_type is not None and \
                "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return {
        "minibatches": minibatches,
        "traced_wall_ms_per_minibatch": wall_ms / minibatches,
        "device_busy_ms_per_minibatch": busy_ms / minibatches,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernels_per_minibatch": sum(counts.values()) / minibatches,
        "port_kernels_ms_per_minibatch": {
            name: sum(us for key, us in kernels.items()
                      if any(frag in key for frag in frags)) / 1e3 /
            minibatches for name, frags in OURS.items()},
        "validation_error_pct": sw.decision.epoch_metrics[1],
        "top_kernels_ms_per_minibatch": [
            [key, us / 1e3 / minibatches, counts[key]] for key, us in top],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the summary here")
    parser.add_argument("--mode", choices=("raw", "graph"),
                        help="one run (default: both, side by side)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_modes import report, side_by_side
    if args.mode is None:
        report(side_by_side(__file__, []), None, args.out)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_unit_graph_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.normalization import MeanDispersionNormalizer

    if args.mode == "raw":
        from veles_tpu_torch.models.fused import FusedTrainer
        FusedTrainer._eager = lambda self, what: True
    device = Device()
    arrays = chip_smoke.mnist_arrays(chip_smoke.MNIST_SEED)
    stats = MeanDispersionNormalizer()
    stats.analyze(arrays[2])

    def per_unit():
        root.common.engine.auto_fuse = False
        try:
            return chip_smoke.mnist_workflow(arrays, stats, device, True)[0]
        finally:
            root.common.engine.auto_fuse = True

    def fused():
        return chip_smoke.mnist_workflow(arrays, stats, device, False)[0]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "model": "mnist 784-100-10",
              "mode": args.mode,
              "minibatch": chip_smoke.MNIST_BATCH,
              "per_unit": profile_epoch(per_unit),
              "fused": profile_epoch(fused)}
    report(result, args.mode, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
