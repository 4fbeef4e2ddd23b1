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

4. Holds the training kernels against their plain PyTorch versions on
   the card, each run twice and required to give the same bits:
   ``gather_minibatch`` (256 VGG16 images, f32 and uint8 -> f32, 32
   rows: bit-equal), ``conv_wgrad`` at VGG16 conv1_1 and conv1_2 (batch
   8), conv5_1 (batch 32) and a ragged, strided, asymmetric tanh case
   (grad_w and grad_b within max-rel 1e-5 of a float64 plain version,
   err within 1 ulp of the f32 one), and ``max_pool_bwd`` at VGG16 pool1
   (batch 8, 2x2/2) and an overlapping ceil-mode 3x3/2 case (bit-equal).
   Each gets its time, the plain version's, a library call's (timed
   only, never called by the port: ``index_select().to()``,
   ``torch.nn.grad.conv2d_weight`` + the epilogue, the autograd of
   ``F.max_pool2d``) and its bound: max(bytes / 3.35 TB/s, f32 FLOPs /
   67 TFLOP/s, TF32 being off).
5. Trains VGG16 (random weights from seed 0, momentum) at batch 32 on a
   128-sample dataset made on the card from a seed: one
   ``build_train_epoch`` (4 steps), one ``build_eval_epoch``, 3 keyless
   ``build_train_step`` steps on one minibatch and one keyed step, with
   the three kernels' launch counts zeroed just before and read just
   after.  Checks: each step launches ``conv_wgrad`` 13 times and
   ``max_pool_bwd`` 5 times, each epoch ``gather_minibatch`` 4 times;
   every metric and state leaf is finite; each of 3 steps, run from the
   same state through the kernels and through the plain versions on the
   card (kernels swapped out, cuDNN deterministic), agrees (loss within
   1e-5 rel, every leaf within max-rel 1e-4); and 2 steps of a small
   convnet on the card agree with the port's CPU run to the same
   tolerances.  Chained over 3 steps, runs drift apart at random init
   (updates near one f32 ulp of the weights flip ReLU masks and pool
   routes), so the chained drift of a second kernel run and of the plain
   run is reported, not held to a limit.  Reports step ms (CUDA events)
   and peak memory.

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
from contextlib import nullcontext

import numpy

PEAK_INT8_OPS = 1.979e15     # H100 SXM dense int8, operations/s
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
TRAIN_BATCH = 32
TRAIN_SAMPLES = 128
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


def f32_bound(nbytes, flops):
    """(bound_ms, bound_by) from bytes moved and f32 operations."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def max_rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() /
            want.abs().max().clamp_min(1e-30)).item()


def max_ulp(got, want):
    import torch
    return (got.view(torch.int32).long() -
            want.view(torch.int32).long()).abs().max().item()


def record(what, shape, max_abs, ms, plain_ms, library_ms, bound_ms,
           bound_by, **extra):
    rec = {"what": what, "shape": shape, "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    rec.update(extra)
    return rec


def check_gather(what, n, sample, batch, dtype, gen):
    """gather_minibatch vs its plain version: bit-equal, twice."""
    import torch
    from veles_tpu_torch.ops.gather import (gather_minibatch,
                                            gather_minibatch_reference)
    shape = (n,) + sample
    if dtype == torch.float32:
        data = torch.randn(shape, generator=gen, device="cuda")
    else:
        data = torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=dtype)
    idx = torch.randint(0, n, (batch,), generator=gen, device="cuda",
                        dtype=torch.int32)
    got = gather_minibatch(data, idx, torch.float32)
    again = gather_minibatch(data, idx, torch.float32)
    want = gather_minibatch_reference(data, idx, torch.float32)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, again)):
        raise AssertionError("gather %s: differs from the plain version "
                             "or between runs" % what)
    row = data[0].numel()
    nbytes = batch * row * (data.element_size() + 4) + 4 * batch
    bound_ms, bound_by = f32_bound(nbytes, 0)
    return record(
        what, "%s %s -> %d rows f32" % ("x".join(map(str, shape)),
                                        str(dtype).split(".")[-1], batch),
        (got - want).abs().max().item(),
        cuda_ms(lambda: gather_minibatch(data, idx, torch.float32), 50),
        cuda_ms(lambda: gather_minibatch_reference(data, idx,
                                                   torch.float32), 50),
        cuda_ms(lambda: data.index_select(0, idx).to(torch.float32), 50),
        bound_ms, bound_by)


def conv_operands(shape, co, ksize, padding, sliding, activation, gen):
    """Seeded x and (y, dy) of the layer's output shape on the card; y
    in the activation's range (ReLU zeros included)."""
    import torch
    from veles_tpu_torch.models.all2all import All2AllTanh
    n, h, w, _ = shape
    left, top, right, bottom = padding
    sx, sy = sliding
    oh = (h + top + bottom - ksize[0]) // sy + 1
    ow = (w + left + right - ksize[1]) // sx + 1
    x = torch.randn(shape, generator=gen, device="cuda")
    z = torch.randn((n, oh, ow, co), generator=gen, device="cuda")
    y = z.clamp_min(0) if activation == "strict_relu" else \
        All2AllTanh.A * torch.tanh(All2AllTanh.B * z)
    dy = torch.randn((n, oh, ow, co), generator=gen, device="cuda")
    return x, y, dy


def check_wgrad(what, shape, co, ksize, padding, sliding, activation, gen):
    """conv_wgrad vs its plain version: grad_w and grad_b within
    max-rel 1e-5 of float64, err within 1 ulp, the same bits twice."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops.conv_vjp import (activation_grad, conv_wgrad,
                                              conv_wgrad_reference)
    x, y, dy = conv_operands(shape, co, ksize, padding, sliding,
                             activation, gen)
    kw = dict(activation=activation, ksize=ksize, padding=padding,
              sliding=sliding)
    gw, gb, err = conv_wgrad(x, y, dy, **kw)
    gw2, gb2, err2 = conv_wgrad(x, y, dy, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(gw, gw2) and torch.equal(gb, gb2) and
            torch.equal(err, err2)):
        raise AssertionError("conv_wgrad %s: two runs differ" % what)
    rgw, rgb, _ = conv_wgrad_reference(x.double(), y.double(), dy.double(),
                                       **kw)
    _, _, ferr = conv_wgrad_reference(x, y, dy, **kw)
    rel_w, rel_b = max_rel(gw, rgw), max_rel(gb, rgb)
    ulp = max_ulp(err, ferr)
    if rel_w > 1e-5 or rel_b > 1e-5 or ulp > 1:
        raise AssertionError("conv_wgrad %s: grad_w max-rel %g, grad_b "
                             "max-rel %g, err %d ulp" % (what, rel_w, rel_b,
                                                         ulp))
    n, h, w, ci = shape
    left, top, right, bottom = padding
    sx, sy = sliding
    p, r = y.shape[0] * y.shape[1] * y.shape[2], ksize[0] * ksize[1] * ci
    nbytes = 4 * (x.numel() + 3 * y.numel() + r * co + co)
    bound_ms, bound_by = f32_bound(nbytes, 2.0 * p * r * co)
    wshape = (co, ci) + tuple(ksize)
    xc = F.pad(x, (0, 0, left, right, top, bottom)).permute(0, 3, 1, 2)

    def library():
        e = activation_grad(activation, y, dy)
        torch.nn.grad.conv2d_weight(xc, wshape, e.permute(0, 3, 1, 2),
                                    stride=(sy, sx))
        e.sum(dim=(0, 1, 2))

    big = p * r * co > 1e10
    return record(
        what, "x %s, k %dx%d, Co %d, pad %s, stride %s, %s" % (
            "x".join(map(str, shape)), ksize[0], ksize[1], co, padding,
            sliding, activation),
        (gw.double() - rgw).abs().max().item(),
        cuda_ms(lambda: conv_wgrad(x, y, dy, **kw), 5 if big else 20),
        cuda_ms(lambda: conv_wgrad_reference(x, y, dy, **kw),
                3 if big else 10),
        cuda_ms(library, 5 if big else 20), bound_ms, bound_by,
        grad_w_max_rel=rel_w, grad_b_max_rel=rel_b, err_max_ulp=ulp)


def check_pool(what, shape, window, sliding, gen):
    """max_pool_bwd vs its plain version: bit-equal, twice."""
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.models.pooling import _pool
    from veles_tpu_torch.ops.pool_bwd import (max_pool_bwd,
                                              max_pool_bwd_reference)
    x = torch.randn(shape, generator=gen, device="cuda").clamp_min(0)
    y = _pool(x, window, sliding, float("-inf"), F.max_pool2d).contiguous()
    dy = torch.randn(y.shape, generator=gen, device="cuda")
    got = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    again = max_pool_bwd(x, y, dy, window=window, sliding=sliding)
    want = max_pool_bwd_reference(x, y, dy, window=window, sliding=sliding)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, again)):
        raise AssertionError("max_pool_bwd %s: differs from the plain "
                             "version or between runs" % what)
    nbytes = 4 * (2 * x.numel() + 2 * y.numel())
    bound_ms, bound_by = f32_bound(nbytes, 0)
    ky, kx = window
    sx, sy = sliding
    xc = x.permute(0, 3, 1, 2)
    _, indices = F.max_pool2d(xc, (ky, kx), (sy, sx), ceil_mode=True,
                              return_indices=True)
    dyc = dy.permute(0, 3, 1, 2)
    return record(
        what, "x %s, window %dx%d, stride %s" % (
            "x".join(map(str, shape)), ky, kx, sliding),
        (got - want).abs().max().item(),
        cuda_ms(lambda: max_pool_bwd(x, y, dy, window=window,
                                     sliding=sliding), 20),
        cuda_ms(lambda: max_pool_bwd_reference(x, y, dy, window=window,
                                               sliding=sliding), 5),
        cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            dyc, xc, [ky, kx], [sy, sx], [0, 0], [1, 1], True, indices),
            20),
        bound_ms, bound_by)


class PlainKernels(object):
    """Swaps the train path's kernels for their plain versions (for the
    comparison run only), and back."""

    def __enter__(self):
        from veles_tpu_torch.ops import conv_vjp, pool_bwd
        self.saved = (conv_vjp.conv_wgrad, pool_bwd.max_pool_bwd)

        def wgrad(x, y, dy, *, activation, ksize, padding, sliding,
                  precision_level=0):
            return conv_vjp.conv_wgrad_reference(
                x, y, dy, activation=activation, ksize=ksize,
                padding=padding, sliding=sliding)
        conv_vjp.conv_wgrad = wgrad
        pool_bwd.max_pool_bwd = pool_bwd.max_pool_bwd_reference
        return self

    def __exit__(self, *exc):
        from veles_tpu_torch.ops import conv_vjp, pool_bwd
        conv_vjp.conv_wgrad, pool_bwd.max_pool_bwd = self.saved


def state_max_rel(got, want):
    worst = 0.0
    for g, w in zip(got, want):
        for key, leaf in w.items():
            if leaf is not None:
                worst = max(worst, max_rel(g[key], leaf))
    return worst


def all_finite(state):
    import torch
    return all(bool(torch.isfinite(leaf).all())
               for entry in state for leaf in entry.values()
               if leaf is not None)


def vgg16_step_bounds(batch):
    """Summed bounds of one VGG16 step's 13 wgrads and 5 pool backwards,
    and of one minibatch gather, from the layer shapes."""
    from veles_tpu_torch.models.zoo import vgg_layers
    h = w = 224
    ci = 3
    wgrad_bytes = wgrad_flops = pool_bytes = 0
    for spec in vgg_layers(config="D"):
        if spec["type"] == "conv_str":
            co = spec["n_kernels"]
            p = batch * h * w
            wgrad_flops += 2.0 * p * 9 * ci * co
            wgrad_bytes += 4 * (p * ci + 3 * p * co + 9 * ci * co + co)
            ci = co
        elif spec["type"] == "max_pooling":
            pool_bytes += 4 * (2 * batch * h * w * ci +
                               2 * batch * (h // 2) * (w // 2) * ci)
            h, w = h // 2, w // 2
    gather_bytes = batch * 224 * 224 * 3 * 8 + 4 * batch
    return {"wgrad_gflop": wgrad_flops / 1e9,
            "wgrad_bound_ms": f32_bound(wgrad_bytes, wgrad_flops)[0],
            "pool_gb": pool_bytes / 1e9,
            "pool_bound_ms": f32_bound(pool_bytes, 0)[0],
            "gather_mb": gather_bytes / 1e6,
            "gather_bound_ms": f32_bound(gather_bytes, 0)[0]}


def train_small_vs_cpu(device):
    """2 steps of a small convnet on the card (kernels) and on the CPU
    (plain versions): loss within 1e-5 rel, leaves within 1e-4."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.convert import state_from_jax, state_to_numpy
    from veles_tpu_torch.models.zoo import build_plans_and_state
    specs = [
        {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
         "padding": 1, "learning_rate": 0.05, "gradient_moment": 0.9},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3,
         "padding": (1, 0, 2, 1), "sliding": (1, 2),
         "learning_rate": 0.05, "gradient_moment": 0.9},
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.05, "gradient_moment": 0.9}]
    plans, state, _ = build_plans_and_state(specs, (20, 18, 3), seed=4)
    rng = numpy.random.RandomState(5)
    data = [(rng.randn(16, 20, 18, 3).astype(numpy.float32),
             rng.randint(0, 10, 16).astype(numpy.int32)) for _ in range(2)]
    cpu = Device(backend="cpu")
    step = build_train_step(plans)
    results = []
    for dev in (device, cpu):
        s = state_from_jax(state, dev)
        losses = []
        for x, t in data:
            s, m = step(s, dev.put(x), dev.put(t), 16.0)
            losses.append(float(m["loss"]))
        results.append((losses, state_to_numpy(s)))
    (card_loss, card_state), (cpu_loss, cpu_state) = results
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
    leaf_rel = state_max_rel(
        [{k: torch.from_numpy(v) for k, v in e.items() if v is not None}
         for e in card_state],
        [{k: torch.from_numpy(v) for k, v in e.items() if v is not None}
         for e in cpu_state])
    if loss_rel > 1e-5 or leaf_rel > 1e-4:
        raise AssertionError("small convnet: card vs CPU loss rel %g, leaf "
                             "max-rel %g" % (loss_rel, leaf_rel))
    return {"loss_rel": loss_rel, "leaf_max_rel": leaf_rel}


def train_phase(device):
    """VGG16 at batch 32 through the epoch, eval and step entry points;
    returns (launch counts, summary)."""
    import torch
    from veles_tpu_torch.compiler import (build_eval_epoch,
                                          build_train_epoch,
                                          build_train_step)
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.models.zoo import build_plans_and_state, \
        vgg_layers
    from veles_tpu_torch.ops.conv_vjp import conv_wgrad
    from veles_tpu_torch.ops.gather import gather_minibatch
    from veles_tpu_torch.ops.pool_bwd import max_pool_bwd

    shape = (224, 224, 3)
    t0 = time.perf_counter()
    plans, host_state, _ = build_plans_and_state(vgg_layers(config="D"),
                                                 shape, seed=0)
    state0 = state_from_jax(host_state, device)
    del host_state
    gen = torch.Generator(device="cuda").manual_seed(7)
    dataset = torch.rand((TRAIN_SAMPLES,) + shape, generator=gen,
                         device="cuda") * 2 - 1
    labels = torch.randint(0, 1000, (TRAIN_SAMPLES,), generator=gen,
                           device="cuda", dtype=torch.int32)
    order = torch.randperm(TRAIN_SAMPLES, generator=gen,
                           device="cuda").to(torch.int32)
    x, t = dataset[:TRAIN_BATCH], labels[:TRAIN_BATCH]
    torch.cuda.synchronize()
    log("train set-up: %.1fs" % (time.perf_counter() - t0))
    kernels = (gather_minibatch, conv_wgrad, max_pool_bwd)

    def counts():
        return [k.launches for k in kernels]

    # -- the main path: launches counted ----------------------------------
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    state1, totals = build_train_epoch(plans, TRAIN_BATCH)(
        state0, dataset, labels, order)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_counts = counts()
    params1 = [{"weights": e["weights"], "bias": e["bias"]} for e in state1]
    t0 = time.perf_counter()
    evaluated = build_eval_epoch(plans, TRAIN_BATCH)(params1, dataset,
                                                     labels, order)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = counts()
    del state1, params1
    step = build_train_step(plans)
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_ms, per_step = state0, [], [], []
    for _ in range(3):
        before = counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, x, t, float(TRAIN_BATCH))
        end.record()
        losses.append(m["loss"])
        per_step.append([a - b for a, b in zip(counts(), before)])
        step_ms.append((start, end))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s.elapsed_time(e) for s, e in step_ms]
    kernel_state = state
    keyed, keyed_m = step(state0, x, t, float(TRAIN_BATCH),
                          torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    launches = dict(zip(("gather_minibatch", "conv_wgrad",
                         "max_pool_bwd"), counts()))
    # -- end of the counted run -------------------------------------------

    if epoch_counts != [4, 52, 20] or \
            [a - b for a, b in zip(eval_counts, epoch_counts)] != [4, 0, 0]:
        raise AssertionError("launches: epoch %s, after eval %s; expected "
                             "[4, 52, 20] and 4 more gathers" % (
                                 epoch_counts, eval_counts))
    if any(c != [0, 13, 5] for c in per_step):
        raise AssertionError("launches per step %s, expected [0, 13, 5]"
                             % per_step)
    if int(totals["skipped"]) != 0 or not numpy.isfinite(
            float(totals["loss_mean"])):
        raise AssertionError("train epoch: %s" % totals)
    if int(evaluated["samples"]) != TRAIN_SAMPLES:
        raise AssertionError("eval epoch: %s" % evaluated)
    if not (all_finite(kernel_state) and all_finite(keyed) and
            bool(keyed_m["finite"])):
        raise AssertionError("a state leaf is not finite")

    # chained runs drift apart at random init: the weight updates sit
    # near one f32 ulp of the weights, so one rounding moves ReLU masks
    # and pool routes in later steps.  Measured, not held to a limit:
    # the kernels run twice, and the plain versions, over the same 3
    # steps as above.
    chained = {}
    for label in ("kernels_again", "plain"):
        state = state0
        with PlainKernels() if label == "plain" else nullcontext():
            for _ in range(3):
                state, _ = step(state, x, t, float(TRAIN_BATCH))
        chained[label] = state_max_rel(state, kernel_state)
    del state
    # held to the limits: each of the 3 steps from the same state through
    # the kernels and through the plain versions, cuDNN deterministic so
    # that the kernels are the only difference
    torch.backends.cudnn.deterministic = True
    try:
        state, loss_rel, leaf_rel = state0, 0.0, 0.0
        for _ in range(3):
            kernel_out, km = step(state, x, t, float(TRAIN_BATCH))
            with PlainKernels():
                plain_out, pm = step(state, x, t, float(TRAIN_BATCH))
            loss_rel = max(loss_rel, abs(float(km["loss"]) -
                                         float(pm["loss"])) /
                           abs(float(pm["loss"])))
            leaf_rel = max(leaf_rel, state_max_rel(kernel_out, plain_out))
            if not all_finite(kernel_out):
                raise AssertionError("a state leaf is not finite")
            state = kernel_out
    finally:
        torch.backends.cudnn.deterministic = False
    del state, kernel_out, plain_out
    if loss_rel > 1e-5 or leaf_rel > 1e-4:
        raise AssertionError("kernels vs plain versions, step by step: "
                             "loss rel %g, leaf max-rel %g" % (loss_rel,
                                                              leaf_rel))
    summary = {
        "model": "vgg16", "batch": TRAIN_BATCH, "samples": TRAIN_SAMPLES,
        "epoch_s": epoch_s, "eval_s": eval_s,
        "epoch_loss_mean": float(totals["loss_mean"]),
        "epoch_n_err": int(totals["n_err"]),
        "eval_n_err": int(evaluated["n_err"]),
        "step_losses": [float(v) for v in losses],
        "step_ms": step_ms, "peak_memory_gb": peak_gb,
        "launches_per_step": dict(zip(("gather_minibatch", "conv_wgrad",
                                       "max_pool_bwd"), per_step[0])),
        "kernels_vs_plain_loss_rel": loss_rel,
        "kernels_vs_plain_leaf_max_rel": leaf_rel,
        "chained_3_steps_leaf_max_rel": chained,
        "keyed_step_loss": float(keyed_m["loss"]),
        "step_bounds": vgg16_step_bounds(TRAIN_BATCH),
    }
    log("train: " + json.dumps(summary))
    return launches, summary


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
    gathers = [
        check_gather("256 VGG16 images f32", 256, (224, 224, 3),
                     TRAIN_BATCH, torch.float32, gen),
        check_gather("256 VGG16 images uint8", 256, (224, 224, 3),
                     TRAIN_BATCH, torch.uint8, gen)]
    wgrads = [
        check_wgrad("conv1_2, batch 8", (8, 224, 224, 64), 64, (3, 3),
                    (1, 1, 1, 1), (1, 1), "strict_relu", gen),
        check_wgrad("conv1_1, batch 8", (8, 224, 224, 3), 64, (3, 3),
                    (1, 1, 1, 1), (1, 1), "strict_relu", gen),
        check_wgrad("conv5_1, batch 32", (32, 14, 14, 512), 512, (3, 3),
                    (1, 1, 1, 1), (1, 1), "strict_relu", gen),
        check_wgrad("ragged", (3, 37, 29, 5), 7, (3, 2), (2, 1, 0, 1),
                    (2, 3), "tanh", gen)]
    pools = [
        check_pool("pool1, batch 8", (8, 224, 224, 64), (2, 2), (2, 2),
                   gen),
        check_pool("overlapping ceil-mode", (3, 13, 13, 96), (3, 3),
                   (2, 2), gen)]
    for name, recs in (("gather_minibatch", gathers),
                       ("conv_wgrad", wgrads), ("max_pool_bwd", pools)):
        for rec in recs:
            log("%s %s: %s" % (name, rec["what"], json.dumps(rec)))

    launches, per_dispatch = serve_phase(device)
    train_launches, train = train_phase(device)
    small = train_small_vs_cpu(device)
    log("small convnet, card vs CPU: %s" % json.dumps(small))

    def entry(name, source, replaces, count, recs, **extra):
        top = recs[0]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": count,
               "shape": "%s (%s)" % (top["shape"], top["what"])}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms"):
            row[key] = top[key]
        row.update(extra)
        row["shapes"] = recs
        return row

    print(json.dumps({"kernels": [
        entry("matmul_int8", "veles_tpu_torch/csrc/matmul_int8.cu",
              "veles_tpu/ops/matmul_int8.py:183", launches, shapes,
              launches_per_dispatch=per_dispatch),
        entry("gather_minibatch", "veles_tpu_torch/csrc/gather.cu",
              "veles_tpu/ops/gather.py:59",
              train_launches["gather_minibatch"], gathers,
              launches_per_epoch=TRAIN_SAMPLES // TRAIN_BATCH),
        entry("conv_wgrad", "veles_tpu_torch/csrc/conv_wgrad.cu",
              "veles_tpu/ops/conv_vjp.py:258",
              train_launches["conv_wgrad"], wgrads,
              launches_per_step=train["launches_per_step"]["conv_wgrad"]),
        entry("max_pool_bwd", "veles_tpu_torch/csrc/pool_bwd.cu",
              "veles_tpu/ops/pool_bwd.py:192",
              train_launches["max_pool_bwd"], pools,
              launches_per_step=train["launches_per_step"][
                  "max_pool_bwd"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
