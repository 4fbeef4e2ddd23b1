#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (veles_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds the kernels from ``veles_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds ``matmul_int8``'s CUDA kernel against its plain PyTorch version
   on the card at the serving shapes: bit for bit with scale 1 and bias
   0 (where |acc| < 2**24 the f32 output is the exact int32 sum), and
   to 1 ulp with random per-column scale and bias.  Times the kernel,
   the plain version and ``torch._int_mm`` + the epilogue (the library
   yardstick; the port never calls it) with CUDA events, and computes
   the least time the card could take (bytes over 3.35 TB/s or int8
   operations over 1,979 TOP/s, whichever is larger).
3. Serves VGG16 (config "D", 224x224x3, 1000 classes, random weights
   from seed 0) through the f32 ``AOTEngine`` and, after calibrating on
   64 seeded samples and quantizing, through the int8 ``AOTEngine`` and
   a ``ContinuousBatcher`` answering 48 requests from 4 threads.  The
   kernel's launch count is zeroed just before the int8 serve path and
   read just after.  Checks: every batched answer equals the same row
   through ``engine.infer`` at rung 32 bit for bit, outputs are finite,
   each int8 dispatch launches the kernel 16 times (13 conv + 3 fc), and
   two samples agree with the port's CPU forward (f32: rtol 1e-3 for
   the summation order of 16 layers; int8: atol 1e-3 on the
   probabilities, since a 1-ulp f32 difference can flip one
   quantization level).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
and, as its last line, ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when there is no CUDA device or the port is missing.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy

PEAK_INT8_OPS = 1.979e15     # H100 SXM dense int8, operations/s
PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
LADDER = (1, 8, 32)
N_REQUESTS = 48
N_THREADS = 4


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn()`` on the card, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(m, k, n):
    """(bound_ms, bound_by) for one (M,K)@(K,N) int8 product with f32
    scale, bias and output: each input read once, the output written
    once."""
    nbytes = m * k + k * n + 4 * n + 4 * n + 4 * m * n
    ops = 2.0 * m * k * n
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(name, m, k, n, amax, gen):
    """Kernel vs plain version on the card at one shape; returns the
    record.  ``amax`` bounds the operands so that |acc| < 2**24."""
    import torch
    from veles_tpu_torch.ops.matmul_int8 import (matmul_int8,
                                                 matmul_int8_reference)
    if k * amax * amax >= 2 ** 24:
        raise ValueError("%s: |acc| may reach 2**24" % name)
    a = torch.randint(-amax, amax + 1, (m, k), generator=gen,
                      device="cuda", dtype=torch.int8)
    b = torch.randint(-amax, amax + 1, (k, n), generator=gen,
                      device="cuda", dtype=torch.int8)
    exact = matmul_int8(a, b, 1.0)
    if not torch.equal(exact, matmul_int8_reference(a, b, 1.0)):
        raise AssertionError("%s: int32 sums differ from the plain "
                             "version" % name)
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01
    bias = torch.randn(n, generator=gen, device="cuda")
    got = matmul_int8(a, b, scale, bias)
    want = matmul_int8_reference(a, b, scale, bias)
    torch.cuda.synchronize()
    ulp = (got.view(torch.int32).long() -
           want.view(torch.int32).long()).abs().max().item()
    if ulp > 1:
        raise AssertionError("%s: %d ulp from the plain version"
                             % (name, ulp))
    max_abs = (got - want).abs().max().item()
    big = m * k * n > 1e9
    ms = cuda_ms(lambda: matmul_int8(a, b, scale, bias),
                 10 if big else 50)
    plain_ms = cuda_ms(lambda: matmul_int8_reference(a, b, scale, bias),
                       3 if big else 20)
    library_ms = None
    if m > 16 and k % 8 == 0 and n % 8 == 0:   # torch._int_mm's domain
        library_ms = cuda_ms(
            lambda: torch._int_mm(a, b).float() * scale + bias,
            10 if big else 50)
    bound_ms, bound_by = bound(m, k, n)
    return {"shape": "%dx%dx%d" % (m, k, n), "what": name,
            "max_abs_err": max_abs, "max_ulp": ulp, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def serve_phase(device):
    """VGG16 through the f32 and int8 engines and the batcher."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_forward
    from veles_tpu_torch.convert import params_from_jax
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers
    from veles_tpu_torch.ops.matmul_int8 import matmul_int8
    from veles_tpu_torch.quant import (build_quantized_forward,
                                       quantize_model_spec)
    from veles_tpu_torch.serve import AOTEngine, ContinuousBatcher

    shape = (224, 224, 3)
    t0 = time.perf_counter()
    plans, state, out_shape = build_plans_and_state(
        vgg_layers(config="D"), shape, seed=0)
    params = [{"weights": s["weights"], "bias": s["bias"]}
              for s in state]
    del state
    log("vgg16: %d layers, %d parameters, output %s, init %.1fs" % (
        len(plans), sum(p["weights"].size + p["bias"].size
                        for p in params if p["weights"] is not None),
        out_shape, time.perf_counter() - t0))

    def latencies(engine, rng):
        out = {}
        for rung in engine.ladder:
            x = rng.uniform(-1, 1, (rung,) + shape).astype(numpy.float32)
            times = []
            for _ in range(5):
                start = time.perf_counter()
                engine.infer(x)
                times.append((time.perf_counter() - start) * 1e3)
            out[str(rung)] = float(numpy.median(times))
        return out

    f32 = AOTEngine(plans, params, shape, ladder=LADDER, device=device)
    receipt_f32 = f32.compile()
    lat_f32 = latencies(f32, numpy.random.RandomState(3))
    log("f32 engine: %s, latency ms per rung %s" % (receipt_f32,
                                                    lat_f32))

    t0 = time.perf_counter()
    calib = numpy.random.RandomState(1).uniform(
        -1, 1, (64,) + shape).astype(numpy.float32)
    qparams, calibration = quantize_model_spec(plans, params, calib,
                                               device=device)
    log("calibrated %d layers on 64 samples in %.1fs, clip fraction %g"
        % (len(calibration.layers), time.perf_counter() - t0,
           calibration.clip_fraction))
    requests = numpy.random.RandomState(2).uniform(
        -1, 1, (N_REQUESTS,) + shape).astype(numpy.float32)

    # -- the main path: int8 engine + batcher, launches counted --------
    matmul_int8.launches = 0
    int8 = AOTEngine(plans, qparams, shape, ladder=LADDER, device=device)
    receipt_int8 = int8.compile()
    warm_launches = matmul_int8.launches
    before = matmul_int8.launches
    int8.infer(requests[:1])
    per_dispatch = matmul_int8.launches - before
    batcher = ContinuousBatcher(int8, max_delay_s=0.05).start()
    answers = [None] * N_REQUESTS
    errors = []

    def client(ids):
        try:
            pending = [(i, batcher.submit(requests[i])) for i in ids]
            for i, req in pending:
                if not req.done.wait(120):
                    raise TimeoutError("request %d timed out" % i)
                if req.error is not None:
                    raise req.error
                answers[i] = req.result
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=client,
                                args=(range(t, N_REQUESTS, N_THREADS),))
               for t in range(N_THREADS)]
    t0 = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(300)
    served_s = time.perf_counter() - t0
    batcher.stop()
    if any(thread.is_alive() for thread in threads):
        raise RuntimeError("a client thread did not finish")
    if errors:
        raise errors[0]
    want = int8.infer(requests)   # rung 32 chunks
    launches = matmul_int8.launches
    # -- end of the counted run ------------------------------------------

    got = numpy.stack(answers)
    if per_dispatch != 16:
        raise AssertionError("an int8 VGG16 dispatch launched the kernel "
                             "%d times, expected 16" % per_dispatch)
    if warm_launches != 16 * len(LADDER):
        raise AssertionError("warm-up launched %d, expected %d"
                             % (warm_launches, 16 * len(LADDER)))
    if not numpy.isfinite(got).all() or got.shape != (N_REQUESTS, 1000):
        raise AssertionError("int8 answers: shape %s, finite %s" % (
            got.shape, numpy.isfinite(got).all()))
    if not (got == want).all():
        raise AssertionError("batched answers differ from engine.infer "
                             "in %d rows" % (got != want).any(1).sum())
    lat_int8 = latencies(int8, numpy.random.RandomState(3))
    f32_out = f32.infer(requests)
    if not numpy.isfinite(f32_out).all():
        raise AssertionError("f32 outputs are not finite")
    agree = float((f32_out.argmax(1) == got.argmax(1)).mean())

    # -- the port's CPU forward on two samples as the reference --------
    cpu = Device(backend="cpu")
    x2 = torch.from_numpy(requests[:2])
    with torch.inference_mode():
        ref_f32 = build_forward(plans)(params_from_jax(params, cpu),
                                       x2).numpy()
        ref_int8 = build_quantized_forward(plans)(
            params_from_jax(qparams, cpu), x2).numpy()
    err_f32 = float(numpy.abs(f32_out[:2] - ref_f32).max())
    err_int8 = float(numpy.abs(got[:2] - ref_int8).max())
    if not numpy.allclose(f32_out[:2], ref_f32, rtol=1e-3, atol=1e-7):
        raise AssertionError("f32 engine vs CPU forward: max abs %g"
                             % err_f32)
    if err_int8 > 1e-3:
        raise AssertionError("int8 engine vs CPU forward: max abs %g"
                             % err_int8)
    summary = {
        "model": "vgg16", "ladder": list(LADDER),
        "f32_receipt": receipt_f32, "int8_receipt": receipt_int8,
        "f32_latency_ms": lat_f32, "int8_latency_ms": lat_int8,
        "requests": N_REQUESTS, "threads": N_THREADS,
        "batcher_rungs": batcher.rungs, "served_s": served_s,
        "launches_per_dispatch": per_dispatch,
        "top1_agreement_f32_int8": agree,
        "cpu_ref_max_abs_f32": err_f32, "cpu_ref_max_abs_int8": err_int8,
    }
    log("serve: " + json.dumps(summary))
    return launches, per_dispatch


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    log("python %s, torch %s, cuda %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))

    start = time.perf_counter()
    common.load_kernels()
    log("build: %.2fs (%s)" % (time.perf_counter() - start,
                               common.build_info["path"]))
    for line in common.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    device = Device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [check_kernel("conv1_2, rung 8", 8 * 224 * 224, 576, 64,
                           127, gen),
              check_kernel("fc1, rung 32", 32, 25088, 4096, 16, gen),
              check_kernel("ragged", 37, 91, 53, 127, gen)]
    for rec in shapes:
        log("matmul_int8 %s: %s" % (rec["what"], json.dumps(rec)))

    launches, per_dispatch = serve_phase(device)

    top = shapes[0]
    print(json.dumps({"kernels": [{
        "name": "matmul_int8", "route": "cuda",
        "source": "veles_tpu_torch/csrc/matmul_int8.cu",
        "replaces": "veles_tpu/ops/matmul_int8.py:183",
        "launches": launches, "launches_per_dispatch": per_dispatch,
        "shape": "%s (%s)" % (top["shape"], top["what"]),
        "max_abs_err": top["max_abs_err"], "ms": top["ms"],
        "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        "shapes": shapes}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
