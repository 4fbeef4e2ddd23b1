#!/usr/bin/env python3
"""The recurrent layers and the serve tier on the card, alone.

    python3 scripts/torch_serve_tier.py [--out PATH]

Runs ``chip_smoke.py``'s ``sequence:`` and ``serve tier:`` phases
(sections 16 and 17 of its docstring) without the rest of the smoke:
builds the kernels, makes VGG16 (config "D", seed 0) and its int8
weights calibrated on 64 seeded samples as the smoke's serve phase
does, trains ``veles_tpu_torch/examples/sequence.py`` on the card and
serves both through the 2-replica pool, the HTTP front, the binary
transport, the reloads (the last to the f32 weights), the freshness
loop and ``python -m veles_tpu_torch.serve``.  Prints the two summaries, the card's name and
power limit as JSON, also written to ``--out``.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the result here")
    args = parser.parse_args()
    import numpy
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers
    from veles_tpu_torch.ops import common
    from veles_tpu_torch.quant import quantize_model_spec

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    start = time.perf_counter()
    common.load_kernels()
    build_s = time.perf_counter() - start
    device = Device()
    shape = (224, 224, 3)
    plans, state, _ = build_plans_and_state(vgg_layers(config="D"), shape,
                                            seed=0)
    params = [{"weights": s["weights"], "bias": s["bias"]} for s in state]
    del state
    calib = numpy.random.RandomState(1).uniform(
        -1, 1, (64,) + shape).astype(numpy.float32)
    qparams, _ = quantize_model_spec(plans, params, calib, device=device)
    result = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "build_s": build_s}
    with tempfile.TemporaryDirectory() as directory:
        t0 = time.perf_counter()
        launches, result["sequence"], snapshot, spec = \
            chip_smoke.sequence_phase(device, directory)
        result["sequence_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tier_launches, result["serve_tier"] = chip_smoke.serve_tier_phase(
            device, (plans, qparams, params), snapshot, spec, directory)
        result["serve_tier_s"] = time.perf_counter() - t0
    launches.update(tier_launches)
    result["launches"] = launches
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            fout.write(text)
    print(smi)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
