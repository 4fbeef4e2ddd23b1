#!/usr/bin/env python3
"""Where the two GEMM kernels of the PyTorch/CUDA port spend their time
on the card, launch by launch.

    python3 scripts/torch_gemm_profile.py [--out PATH]

For ``matmul`` at VGG16 fc1 through ``gemm`` ((32, 25088) @ (25088,
4096), level 0), at 3001^3 (f32 at levels 0, 1 and 2, bf16) and at
2048^3 (level 0), and for ``matmul_int8`` at fc1 and conv1_1 (rung 32)
and conv1_2 (rung 8) with the weight K-major as the serving engine keeps
it, traces 5 calls with ``torch.profiler`` and reports the device time
a call of each kernel (the packs, the main kernel, the split-K fold),
the design the planner chose and its K split.  Operands are seeded
uniforms.  Prints the summary with the card's name and power limit as
JSON, and also writes it to ``--out`` when given.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5


def kernel_us(fn, reps=REPS):
    """{kernel name: device microseconds a call} over ``reps`` traced
    calls, after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            name = evt.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + us / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the summary here")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_gemm_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops.blas import gemm
    from veles_tpu_torch.ops.common import sm_count
    from veles_tpu_torch.ops.matmul import matmul, plan_matmul
    from veles_tpu_torch.ops.matmul_int8 import (kmajor_weight,
                                                 matmul_int8_kmajor,
                                                 plan_int8)

    Device()   # TF32 off
    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "reps": REPS, "matmul": [],
              "matmul_int8": []}
    sms = sm_count(torch.device("cuda", 0))

    def rand(*shape, dtype=torch.float32):
        return torch.rand(*shape, generator=gen, device="cuda").to(dtype)

    cases = [("fc1 through gemm", (32, 25088, 4096), 0, torch.float32),
             ("3001^3", (3001, 3001, 3001), 0, torch.float32),
             ("3001^3", (3001, 3001, 3001), 1, torch.float32),
             ("3001^3", (3001, 3001, 3001), 2, torch.float32),
             ("3001^3", (3001, 3001, 3001), 0, torch.bfloat16),
             ("2048^3", (2048, 2048, 2048), 0, torch.float32)]
    for what, (m, k, n), level, dtype in cases:
        a, b = rand(m, k, dtype=dtype), rand(k, n, dtype=dtype)
        plan = plan_matmul(m, k, n, 512, level, dtype, a.stride(),
                           b.stride(), a.data_ptr(), b.data_ptr(), sms)
        if what.startswith("fc1"):
            fn = lambda: gemm(a, b)   # noqa: E731
        else:
            fn = lambda: matmul(a, b, level)   # noqa: E731
        result["matmul"].append({
            "what": what, "shape": [m, k, n], "level": level,
            "dtype": str(dtype).split(".")[-1], "path": plan["path"],
            "splits": plan["splits"], "kernels_us": kernel_us(fn)})
        del a, b

    for what, (m, k, n) in (("fc1, rung 32", (32, 25088, 4096)),
                            ("conv1_1, rung 32", (32 * 224 * 224, 27, 64)),
                            ("conv1_2, rung 8", (8 * 224 * 224, 576, 64))):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        wt = kmajor_weight(torch.randint(-127, 128, (k, n), generator=gen,
                                         device="cuda", dtype=torch.int8))
        a = F.pad(a, (0, wt.shape[1] - k)).contiguous()
        scale, bias = rand(n), rand(n)
        plan = plan_int8(m, k, n, sms)
        result["matmul_int8"].append({
            "what": what, "shape": [m, k, n], "tile": list(plan["tile"]),
            "splits": plan["splits"],
            "kernels_us": kernel_us(
                lambda: matmul_int8_kmajor(a, wt, scale, bias))})
        del a, wt

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            json.dump(result, fout, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
