#!/usr/bin/env python3
"""Where a VGG16 training step of the PyTorch/CUDA port spends its time
on the card.

    python3 scripts/torch_train_profile.py [--tree DIR]
        [--dropout-seed N] [--mode raw|graph] [--out PATH]

Builds VGG16 (config "D", random weights from seed 0, momentum) as
chip_smoke.py does, with a 64-sample dataset made on the card from a
seed, warms ``build_train_epoch`` at batch 32 (2 steps), then times 3
epochs with CUDA events and traces one more with ``torch.profiler``:
device time by kernel name per step, the shares of the port's kernels
(``conv_wgrad``, ``max_pool_bwd``, ``gather_minibatch``), and the
device's idle share over the traced window (1 - summed kernel time /
wall time).  With ``--dropout-seed`` the epochs are keyed, so each
step draws VGG16's two dropout masks: from the threefry key of that
seed (``veles_tpu_torch.threefry``), or, in a tree from before it, from
a ``torch.Generator`` of that seed, the key type such trees took.
``--tree`` names a checkout whose ``veles_tpu_torch`` is profiled
(default: this one), so that two commits can be compared in one call.
``--mode raw`` runs the uncaptured epoch (``donate=False``; a tree from
before the captured steps has only that), ``--mode graph`` the captured
one; without ``--mode`` both run, each in its own process
(``scripts/torch_modes.py``), side by side. Prints a summary with the
card's name and power limit as JSON, and also writes it to ``--out``
when given. Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 32
SAMPLES = 64
REPS = 3

#: kernel-name fragments of the port's own kernels
OURS = {"conv_wgrad": ("wgrad_kernel", "wgrad_tc_kernel", "reduce_splits"),
        "max_pool_bwd": ("pool_bwd_cells", "pool_bwd_overlap"),
        "gather_minibatch": ("gather_vec4", "gather_scalar")}


def device_time_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose veles_tpu_torch is profiled")
    parser.add_argument("--dropout-seed", type=int,
                        help="key the epochs' dropout masks")
    parser.add_argument("--out", help="also write the summary here")
    parser.add_argument("--mode", choices=("raw", "graph"),
                        help="one run (default: both, side by side)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_modes import report, side_by_side
    if args.mode is None:
        argv = ["--tree", args.tree]
        if args.dropout_seed is not None:
            argv += ["--dropout-seed", str(args.dropout_seed)]
        report(side_by_side(__file__, argv), None, args.out)
        return 0

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import veles_tpu_torch
    if not os.path.abspath(veles_tpu_torch.__file__).startswith(tree):
        raise RuntimeError("veles_tpu_torch came from %s, not %s" % (
            veles_tpu_torch.__file__, tree))
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_train_epoch
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers

    shape = (224, 224, 3)
    device = Device()
    plans, host_state, _ = build_plans_and_state(vgg_layers(config="D"),
                                                 shape, seed=0)
    state = state_from_jax(host_state, device)
    del host_state
    gen = torch.Generator(device="cuda").manual_seed(7)
    dataset = torch.rand((SAMPLES,) + shape, generator=gen,
                         device="cuda") * 2 - 1
    labels = torch.randint(0, 1000, (SAMPLES,), generator=gen,
                           device="cuda", dtype=torch.int32)
    order = torch.arange(SAMPLES, device="cuda", dtype=torch.int32)
    key = None
    if args.dropout_seed is not None:
        try:
            from veles_tpu_torch import threefry
            key = threefry.key(args.dropout_seed)
        except ImportError:
            key = torch.Generator(device="cuda").manual_seed(
                args.dropout_seed)
    try:
        train_epoch = build_train_epoch(plans, BATCH,
                                        donate=args.mode == "graph")
    except TypeError:   # a tree from before the captured steps
        if args.mode == "graph":
            raise
        train_epoch = build_train_epoch(plans, BATCH)

    def epoch(state, dataset, labels, order):
        return train_epoch(state, dataset, labels, order, key)
    steps = SAMPLES // BATCH

    state, _ = epoch(state, dataset, labels, order)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        state, totals = epoch(state, dataset, labels, order)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (REPS * steps)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, totals = epoch(state, dataset, labels, order)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        us = device_time_us(evt)
        if us > 0 and evt.device_type is not None and \
                "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    busy_ms = sum(kernels.values()) / 1e3
    ours = {name: sum(us for key, us in kernels.items()
                      if any(frag in key for frag in frags)) / 1e3 / steps
            for name, frags in OURS.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:25]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {
        "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "tree": tree, "mode": args.mode,
        "dropout_seed": args.dropout_seed,
        "dropout_key": type(key).__name__ if key is not None else None,
        "model": "vgg16", "batch": BATCH,
        "steps_per_epoch": steps,
        "step_ms_events": step_ms,
        "traced_wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "port_kernels_ms_per_step": ours,
        "loss_mean": float(totals["loss_mean"]),
        "top_kernels_ms_per_step": [[key, us / 1e3 / steps]
                                    for key, us in top],
    }
    report(result, args.mode, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
