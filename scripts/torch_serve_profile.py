#!/usr/bin/env python3
"""Where a VGG16 serving dispatch of the PyTorch/CUDA port spends its
time on the card.

    python3 scripts/torch_serve_profile.py [--mode raw|graph] [--out PATH]

Builds VGG16 (config "D", random weights from seed 0) as chip_smoke.py
does, warms an f32 and an int8 ``AOTEngine`` with a one-rung ladder,
then for each engine times 5 dispatches at rung 32 with CUDA events
and traces 5 more with ``torch.profiler``: device time by kernel
name, the share taken by ``matmul_int8``, and the device's idle share
over the traced window (1 - summed kernel time / wall time). ``--mode
raw`` dispatches the engine's forward directly, ``--mode graph`` replays
the rung's captured graph (``AOTEngine.run``); without ``--mode`` both
run, each in its own process (``scripts/torch_modes.py``), side by side.
Prints a summary with the card's name and power limit as JSON, and also
writes it to ``--out`` when given. Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNG = 32
REPS = 5


def device_time_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def profile_engine(engine, x_dev, rung, reps, graphed):
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(x_dev, rung):
        if graphed:
            return engine.run(x_dev, rung)
        with torch.inference_mode():
            return engine._forward(engine._params_dev, x_dev)

    for _ in range(2):
        run(x_dev, rung)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run(x_dev, rung)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run(x_dev, rung)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        us = device_time_us(evt)
        if us > 0 and evt.device_type is not None and \
                "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    int8_ms = sum(us for key, us in kernels.items()
                  if "matmul_int8" in key) / 1e3
    return {
        "ms_per_dispatch_events": event_ms,
        "traced_wall_ms_per_dispatch": wall_ms / reps,
        "device_busy_ms_per_dispatch": busy_ms / reps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)
        if wall_ms else None,
        "matmul_int8_ms_per_dispatch": int8_ms / reps,
        "top_kernels_ms_per_dispatch": [
            [key, us / 1e3 / reps] for key, us in top],
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
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers
    from veles_tpu_torch.quant import quantize_model_spec
    from veles_tpu_torch.serve import AOTEngine

    shape = (224, 224, 3)
    device = Device()
    plans, state, _ = build_plans_and_state(vgg_layers(config="D"),
                                            shape, seed=0)
    params = [{"weights": s["weights"], "bias": s["bias"]}
              for s in state]
    del state
    calib = numpy.random.RandomState(1).uniform(
        -1, 1, (64,) + shape).astype(numpy.float32)
    qparams, _ = quantize_model_spec(plans, params, calib, device=device,
                                     save_report=False)
    x = numpy.random.RandomState(2).uniform(
        -1, 1, (RUNG,) + shape).astype(numpy.float32)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "model": "vgg16",
              "rung": RUNG, "reps": REPS, "mode": args.mode}
    for label, spec in (("f32", params), ("int8", qparams)):
        engine = AOTEngine(plans, spec, shape, ladder=(RUNG,),
                           device=device)
        engine.compile()
        result[label] = profile_engine(engine, device.put(x), RUNG,
                                       REPS, args.mode == "graph")
        del engine
        torch.cuda.empty_cache()
    report(result, args.mode, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
