#!/usr/bin/env python3
"""Where a minibatch of the PyTorch/CUDA port's unit graph spends its
time on the card, per unit and fused.

    python3 scripts/torch_unit_graph_profile.py
        [--model mnist|cifar10|vgg16|transformer] [--mode raw|graph]
        [--out PATH]

Builds one of chip_smoke.py's unit-graph workflows twice and runs one
epoch of each under ``torch.profiler``: (i) per unit
(``root.common.engine.auto_fuse = False``), and (ii) fused.  The models:

- ``mnist`` (default): 784 -> all2all_tanh 100 -> softmax 10 at
  minibatch 100 over 60,000 + 10,000 seeded uint8 images (700
  minibatches an epoch); (i) with a ``MeanDispNormalizer`` unit in
  front of the first layer, (ii) the loader normalizing on the host;
- ``cifar10``: examples/cifar10.py's conv net at full width, minibatch
  100, 50,000 + 10,000 seeded uint8 32x32x3 images (600 minibatches),
  the normalizer as for mnist;
- ``vgg16``: VGG16 at batch 32 over 96 + 32 random images (4
  minibatches);
- ``transformer``: the repo's transformer workload (2 blocks, D 512, 8
  heads, MLP 2048, T 128) at batch 64 over 192 + 64 random sequences.

A first epoch of each runs untraced as a warm-up, and the same
workflow's second epoch is traced.  Reports, per
minibatch: the traced wall time, the device busy time (summed kernel
time) and the idle share (1 - busy / wall), the kernels launched, the
port's own kernels' device time, the top kernels by device time, and
the host ms a run of each unit (``Workflow.unit_stats``); with the
card's name and power limit, as JSON, also written to ``--out`` when
given.  ``--mode graph`` runs the fused trainer as the port does, on
its captured steps; ``--mode raw`` forces its eager route (the raw
step, as under ``VELES_DEBUG_NONFINITE``, without the guard); without
``--mode`` both run, each in its own process
(``scripts/torch_modes.py``), side by side.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: kernel-name fragments of the port's own kernels on this path
OURS = {"gather_minibatch": ("gather_vec4", "gather_scalar"),
        "mean_disp_normalize": ("normalize_vec4", "normalize_scalar"),
        "conv_wgrad": ("wgrad_kernel", "wgrad_tc_kernel", "reduce_splits"),
        "max_pool_bwd": ("pool_bwd_cells", "pool_bwd_overlap"),
        "attention_fwd": ("fwd_kernel", "fwd_tc_kernel"),
        "attention_dq": ("dq_kernel", "dq_tc_kernel"),
        "attention_dkv": ("dkv_kernel", "dkv_tc_kernel")}
MODELS = ("mnist", "cifar10", "vgg16", "transformer")


def device_time_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def profile_epoch(build):
    """Warm one epoch, then trace the next one of the same workflow (its
    first calls and graph captures are behind it); per-minibatch
    numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sw = build()
    sw.run()
    sw.decision.max_epochs += 1
    sw.decision.complete <<= False
    warm_minibatches = sw.loader.run_calls
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sw.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    minibatches = sw.loader.run_calls - warm_minibatches
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
        "host_ms_per_unit_run": [
            [unit.name, seconds * 1e3 / max(runs, 1), runs]
            for seconds, unit, runs in sw.unit_stats()[:15]],
    }


def workflow_factories(model, device):
    """(per-unit build, fused build) of ``model``: each returns a fresh
    workflow initialized on ``device``."""
    import chip_smoke as cs
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.zoo import vgg_layers
    from veles_tpu_torch.normalization import MeanDispersionNormalizer
    if model in ("mnist", "cifar10"):
        if model == "mnist":
            arrays = cs.mnist_arrays(cs.MNIST_SEED)
            spec = (cs.mnist_layers(), cs.MNIST_BATCH, cs.MNIST_SEED,
                    "mnist", 1)
        else:
            arrays = cs.cifar_arrays(cs.CIFAR_SEED)
            spec = (cs.cifar_layers(), cs.CIFAR_BATCH, cs.CIFAR_SEED,
                    "cifar", 3)
        stats = MeanDispersionNormalizer()
        stats.analyze(arrays[2])

        def build(normalizer):
            return cs.standard_workflow(arrays, stats, device, normalizer,
                                        *spec)[0]
    else:
        if model == "vgg16":
            arrays = cs.vgg_unit_arrays()
            spec = (vgg_layers(config="D"), cs.TRAIN_BATCH, 0, "vgg", 5)
        else:
            arrays = cs.tf_unit_arrays()
            spec = (cs.transformer_spec(), cs.TF_BATCH, 0, "tf", 5)

        def build(normalizer):
            return cs.standard_workflow(arrays, None, device, False, *spec,
                                        loader_kwargs={})[0]

    def per_unit():
        root.common.engine.auto_fuse = False
        try:
            return build(model in ("mnist", "cifar10"))
        finally:
            root.common.engine.auto_fuse = True

    return per_unit, lambda: build(False)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the summary here")
    parser.add_argument("--mode", choices=("raw", "graph"),
                        help="one run (default: both, side by side)")
    parser.add_argument("--model", choices=MODELS, default="mnist")
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_modes import report, side_by_side
    if args.mode is None:
        report(side_by_side(__file__, ["--model", args.model]), None,
               args.out)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_unit_graph_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from veles_tpu_torch.backends import Device

    if args.mode == "raw":
        from veles_tpu_torch.models.fused import FusedTrainer
        FusedTrainer._eager = lambda self, what: True
    per_unit, fused = workflow_factories(args.model, Device())

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "model": args.model,
              "mode": args.mode,
              "per_unit": profile_epoch(per_unit),
              "fused": profile_epoch(fused)}
    report(result, args.mode, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
