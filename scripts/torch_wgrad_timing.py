#!/usr/bin/env python3
"""Time the port's conv wgrad kernel over a VGG16 training step, the
three attention kernels and the join, on the card's clock, for one tree
of the repository.

    python3 scripts/torch_wgrad_timing.py [--tree DIR] [--label NAME]
        [--parts wgrad,attention,join] [--out PATH]

``--tree`` names a checkout whose ``veles_tpu_torch`` is timed (default:
this one), so that two commits can be compared in one run on one card:
run it for the parent, the change, the change and the parent.  The
timing functions are this checkout's ``chip_smoke.py`` (``time_wgrad``,
``wgrad_bound``, ``device_ms``, ``check_join``); they call only the
wrappers' public functions, which every tree has.  ``--parts`` picks the
records (default: all three).

Records:

- ``conv_wgrad`` at level 0 for each of VGG16's 13 conv layers at batch
  32 (3x3, pad 1, stride 1, ``strict_relu``) and at conv1_2, batch 8:
  the kernel's device time a call, read cold (the calls cycle through
  copies of x, y and dy over 128 MB, as a step reads each layer's
  operands once); the library's (``activation_grad`` +
  ``torch.nn.grad.conv2d_weight`` + the bias sum, TF32 off), timed the
  same way; the level-0 bound (bytes over 3.35 TB/s against three bf16
  products at 989 TFLOP/s); and the sums over the 13 layers: a step's
  wgrad time.
- ``attention_fwd``, ``attention_dq`` and ``attention_dkv`` at the zoo
  transformer's (B*H, T, dh) = (512, 128, 64), f32, at precision level 0
  (the backward's ``tc_bf16x3`` design, what the transformer's train step
  runs) and level 1 (``simt``): device time a call, read cold (the calls
  cycle through copies of q, k, v and do over 128 MB), beside SDPA's
  forward and its backward (dq, dk and dv together) timed the same way,
  the level's bound (``chip_smoke.attention_bound``) and the sum of the
  dq and dk/dv kernels.
- ``join`` at the unit graph's (100, 100) + (100, 100) f32 and at
  (4096, 784) uint8 + (4096, 100) f32 + (4096, 10) f32 -> f32, twice
  each: ``chip_smoke.check_join`` (bit-equal to the plain version), the
  kernel's and ``torch.cat``'s device time a call over 100 calls on the
  same operands, and the byte bound.

Prints the summary with the card's name and power limit as JSON, and
also writes it to ``--out``.  Needs a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: VGG16's conv layers (config "D") at 224 x 224: (side, Ci, Co)
VGG16_CONVS = ((224, 3, 64), (224, 64, 64), (112, 64, 128),
               (112, 128, 128), (56, 128, 256), (56, 256, 256),
               (56, 256, 256), (28, 256, 512), (28, 512, 512),
               (28, 512, 512), (14, 512, 512), (14, 512, 512),
               (14, 512, 512))


def smoke_module():
    """This checkout's chip_smoke.py, loaded by path (the timed tree's
    own may be older)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_layer(smoke, batch, side, ci, co, gen):
    """One layer's record: level-0 kernel and library, cold."""
    kw = dict(activation="strict_relu", ksize=(3, 3), padding=(1, 1, 1, 1),
              sliding=(1, 1), precision_level=0)
    operands = smoke.conv_operands((batch, side, side, ci), co, (3, 3),
                                   (1, 1, 1, 1), (1, 1), "strict_relu",
                                   gen)
    p = batch * side * side
    big = p * 9 * ci * co > 1e10
    ms, library_ms, rotation = smoke.time_wgrad(operands, kw,
                                                rounds=3 if big else 10)
    bound_ms, bound_by = smoke.wgrad_bound(p * ci, p, 9 * ci, co, 0)
    return {"shape": [batch, side, side, ci, co], "ms": ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "rotation": rotation}


def time_attention(smoke, gen):
    """The three attention kernels at levels 0 and 1 and SDPA at (512,
    128, 64) f32, on the card's clock, cold: each call reads a copy of
    the operands that the calls just before it did not."""
    import numpy
    import torch
    import torch.nn.functional as F
    from veles_tpu_torch.ops.attention import (attention_dkv, attention_dq,
                                               attention_fwd)
    shape = (512, 128, 64)
    scale = 1.0 / float(numpy.sqrt(shape[-1]))
    nbytes = 4 * 4 * shape[0] * shape[1] * shape[2]
    sets = []
    for _ in range(smoke.cold_sets(nbytes)):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4))
        out, lse = attention_fwd(q, k, v, scale)
        delta = torch.sum(do * out, dim=-1)
        lib = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        lout = F.scaled_dot_product_attention(*lib, scale=scale)
        sets.append(((q, k, v, do, lse, delta), lib, lout))
    rounds = 20
    rec = {"shape": list(shape), "rotation": len(sets)}
    for level in (0, 1):
        lv = dict(precision_level=level)
        rec["level_%d" % level] = {
            "fwd_ms": smoke.cold_ms(
                lambda b, *_: attention_fwd(*b[:3], scale, **lv), sets,
                rounds),
            "dq_ms": smoke.cold_ms(
                lambda b, *_: attention_dq(*b, scale, **lv), sets, rounds),
            "dkv_ms": smoke.cold_ms(
                lambda b, *_: attention_dkv(*b, scale, **lv), sets,
                rounds)}
        row = rec["level_%d" % level]
        row["dq_plus_dkv_ms"] = row["dq_ms"] + row["dkv_ms"]
        for name in ("fwd", "dq", "dkv"):
            row[name + "_bound_ms"] = smoke.attention_bound(
                shape[0], shape[1], shape[2], torch.float32, name,
                level)[0]
    with torch.no_grad():
        rec["sdpa_fwd_ms"] = smoke.cold_ms(
            lambda _, lib, __: F.scaled_dot_product_attention(
                *lib, scale=scale), sets, rounds)
    rec["sdpa_bwd_ms"] = smoke.cold_ms(
        lambda b, lib, lout: torch.autograd.grad(
            lout, lib, b[3], retain_graph=True), sets, rounds)
    return rec


def time_join(smoke, gen):
    """The join at the DAG's and at the mixed shape, twice each."""
    import torch
    cases = (("DAG branches", 100, [(100, torch.float32)] * 2),
             ("mixed", 4096, [(784, torch.uint8), (100, torch.float32),
                              (10, torch.float32)]))
    return [smoke.check_join(what, batch, spec, gen)
            for what, batch, spec in cases for _ in range(2)]


PARTS = ("wgrad", "attention", "join")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose veles_tpu_torch is timed")
    parser.add_argument("--label", default="tree")
    parser.add_argument("--parts", default=",".join(PARTS),
                        help="comma-separated records to take, of %s"
                        % ", ".join(PARTS))
    parser.add_argument("--out", help="also write the summary here")
    args = parser.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        parser.error("--parts takes %s" % ", ".join(PARTS))

    import torch
    if not torch.cuda.is_available():
        print("torch_wgrad_timing: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import veles_tpu_torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common
    if not os.path.abspath(veles_tpu_torch.__file__).startswith(tree):
        raise RuntimeError("veles_tpu_torch came from %s, not %s" % (
            veles_tpu_torch.__file__, tree))
    smoke = smoke_module()
    Device()   # TF32 off for cuBLAS and cuDNN
    common.load_kernels()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {"label": args.label, "tree": tree,
              "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "build_s": common.build_info["seconds"],
              "tf32": [torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "wgrad" in parts:
        result["conv1_2_batch_8"] = time_layer(smoke, 8, 224, 64, 64, gen)
        layers = [time_layer(smoke, 32, side, ci, co, gen)
                  for side, ci, co in VGG16_CONVS]
        result["vgg16_step_batch_32"] = {
            "layers": layers,
            "ms": sum(r["ms"] for r in layers),
            "library_ms": sum(r["library_ms"] for r in layers),
            "bound_ms": sum(r["bound_ms"] for r in layers)}
    if "attention" in parts:
        result["attention"] = time_attention(smoke, gen)
    if "join" in parts:
        result["join"] = time_join(smoke, gen)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            json.dump(result, fout, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
