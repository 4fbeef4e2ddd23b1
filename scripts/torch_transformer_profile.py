#!/usr/bin/env python3
"""Where a training step of the zoo transformer spends its time on the
card, in the PyTorch/CUDA port.

    python3 scripts/torch_transformer_profile.py [--mode raw|graph]
        [--out PATH]

Builds the transformer as chip_smoke.py does (2 pre-LN blocks, D 512,
8 heads, MLP 2048, over (128, 512) input, 10 classes, random weights
from seed 0, momentum) with a 128-sample dataset made on the card from a
seed, warms ``build_train_epoch`` at batch 64 (2 steps), then times 3
epochs with CUDA events, 3 lone ``build_train_step`` steps with CUDA
events, and the host's time to enqueue those steps (host clock, no
synchronize inside), and traces one more epoch with ``torch.profiler``:
device time by kernel name per step, the shares of the port's kernels
(the three attention kernels and ``gather_minibatch``), and the device's
idle share over the traced window (1 - summed kernel time / wall time).
Then the same for one rung-32 ``AOTEngine`` dispatch.  At the spec's lr
0.05 the loss leaves the finite range within a few epochs on this noise
dataset; such steps are skipped (counted in ``skipped``) and run the
same kernels.  ``--mode raw`` runs the uncaptured epoch, step and
forward (``donate=False``, the engine's forward called directly),
``--mode graph`` the captured ones; without ``--mode`` both run, each
in its own process (``scripts/torch_modes.py``), side by side.  Prints a
summary with the card's name and power limit as JSON, and also writes
it to ``--out`` when given.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (128, 512)
BATCH = 64
SAMPLES = 128
REPS = 3
RUNG = 32

#: kernel-name fragments of the port's own kernels: each attention wrapper
#: has a SIMT kernel (levels 1 and 2) and a tensor-core one (level 0)
OURS = {"attention_fwd": ("fwd_kernel", "fwd_tc_kernel"),
        "attention_dq": ("dq_kernel", "dq_tc_kernel"),
        "attention_dkv": ("dkv_kernel", "dkv_tc_kernel"),
        "gather_minibatch": ("gather_vec4", "gather_scalar")}


def device_time_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def traced(fn, count):
    """Profile one call of ``fn``; (device ms by kernel per unit, busy
    ms per unit, wall ms per unit) over ``count`` units."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        us = device_time_us(evt)
        if us > 0 and evt.device_type is not None and \
                "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / count
    return kernels, sum(kernels.values()), wall_ms / count


def summarize(kernels, busy_ms, wall_ms):
    ours = {name: sum(ms for key, ms in kernels.items()
                      if any(frag in key for frag in frags))
            for name, frags in OURS.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:25]
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "port_kernels_ms": ours,
            "top_kernels_ms": [[key, ms] for key, ms in top]}


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
    graphed = args.mode == "graph"

    import numpy
    import torch
    if not torch.cuda.is_available():
        print("torch_transformer_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_train_epoch, build_train_step
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.models.zoo import (build_plans_and_state,
                                            transformer_layers)
    from veles_tpu_torch.serve import AOTEngine

    device = Device()
    plans, host_state, _ = build_plans_and_state(
        transformer_layers(blocks=2, heads=8, hidden=2048), SHAPE, seed=0)
    state = state_from_jax(host_state, device)
    gen = torch.Generator(device="cuda").manual_seed(7)
    dataset = torch.randn((SAMPLES,) + SHAPE, generator=gen, device="cuda")
    labels = torch.randint(0, 10, (SAMPLES,), generator=gen, device="cuda",
                           dtype=torch.int32)
    order = torch.arange(SAMPLES, device="cuda", dtype=torch.int32)
    epoch = build_train_epoch(plans, BATCH, donate=graphed)
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

    step = build_train_step(plans, donate=graphed)
    batches = [(dataset[i * BATCH:(i + 1) * BATCH],
                labels[i * BATCH:(i + 1) * BATCH]) for i in range(steps)]
    lone = state
    for x, t in batches:   # warm
        lone, _ = step(lone, x, t, float(BATCH))
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(REPS):
        for x, t in batches:
            lone, _ = step(lone, x, t, float(BATCH))
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / (REPS * steps)
    end.record()
    torch.cuda.synchronize()
    lone_ms = start.elapsed_time(end) / (REPS * steps)
    del lone
    out = {}

    def run_epoch():
        out["totals"] = epoch(state, dataset, labels, order)[1]

    train = summarize(*traced(run_epoch, steps))

    params = [{"weights": e["weights"], "bias": e["bias"]}
              for e in host_state]
    engine = AOTEngine(plans, params, SHAPE, ladder=(RUNG,), device=device)
    engine.compile()
    x = device.put(numpy.random.RandomState(1).randn(
        RUNG, *SHAPE).astype(numpy.float32))

    def dispatch():
        if graphed:
            return engine.run(x, RUNG)
        with torch.inference_mode():
            return engine._forward(engine._params_dev, x)

    serve = summarize(*traced(dispatch, 1))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {
        "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "model": "transformer",
        "mode": args.mode,
        "batch": BATCH, "steps_per_epoch": steps,
        "epoch_step_ms_events": step_ms,
        "lone_step_ms_events": lone_ms,
        "lone_step_host_enqueue_ms": enqueue_ms,
        "tokens_per_s_epoch": BATCH * SHAPE[0] / (step_ms / 1e3),
        "tokens_per_s_lone_steps": BATCH * SHAPE[0] / (lone_ms / 1e3),
        "loss_mean": float(out["totals"]["loss_mean"]),
        "skipped": int(out["totals"]["skipped"]),
        "train_step": train, "serve_dispatch_rung_%d" % RUNG: serve,
    }
    report(result, args.mode, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
