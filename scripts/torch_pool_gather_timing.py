#!/usr/bin/env python3
"""Time the port's gather, max-pool backward and reduction kernels on
the card's clock with a cold L2, for one tree of the repository.

    python3 scripts/torch_pool_gather_timing.py [--tree DIR]
        [--label NAME] [--parts gather,pool,reduce,normalize,floor]
        [--out PATH]

``--tree`` names a checkout whose ``veles_tpu_torch`` is timed (default:
this one), so that two commits can be compared in one run on one card:
run it for the parent, the change, the change and the parent.  The
timing functions are this checkout's ``chip_smoke.py`` (``time_gather``,
``time_pool``, ``pool_step``, ``time_reduce``, ``time_normalize``,
``launch_floor``): device time a call with
the host's cost hidden behind a spin kernel, each call reading operands
the calls just before it did not (index vectors over a dataset larger
than the 50 MB L2, or copies of the operands), beside one PyTorch call
for the same function and the bound (bytes over 3.35 TB/s).  They use
only the wrappers' public functions, which every tree has.

Records: ``gather_minibatch`` of 32 of 256 VGG16 images (f32, int32 and
int64 indices) and of 1,024 (uint8 -> f32), and an MNIST minibatch (100
of 60,000 uint8 rows -> f32); ``max_pool_bwd`` at VGG16 pool1 (batch 8),
AlexNet's 3x3/2 pool1 (batch 32) and VGG16's five pools at batch 32
(summed: a training step); ``reduce_cols`` / ``reduce_rows`` at 3001^2,
(60000, 784) and (32, 25088) f32 and 4096^2 bf16, the column sums also
at (100, 784), (33, 129) and (7, 3) f32 (warm: under 1 MB);
``mean_disp_normalize`` of (100, 784) and (4096, 3072) uint8 -> f32,
the latter also as a view one byte into its storage;
the launch floor (the empty kernel's device time, where the tree has
one).  ``--parts`` picks the groups (default: all).  Prints the summary
with the card's name and power limit as JSON, and also writes it to
``--out``.  Needs a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """This checkout's chip_smoke.py, loaded by path (the timed tree's
    own may be older)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose veles_tpu_torch is timed")
    parser.add_argument("--label", default="tree")
    parser.add_argument("--parts", default="gather,pool,reduce,normalize,"
                        "floor", help="comma-separated groups to time")
    parser.add_argument("--out", help="also write the summary here")
    args = parser.parse_args()
    parts = set(args.parts.split(","))

    import torch
    if not torch.cuda.is_available():
        print("torch_pool_gather_timing: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import veles_tpu_torch
    from veles_tpu_torch.ops import common
    if not os.path.abspath(veles_tpu_torch.__file__).startswith(tree):
        raise RuntimeError("veles_tpu_torch came from %s, not %s" % (
            veles_tpu_torch.__file__, tree))
    smoke = smoke_module()
    common.load_kernels()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {"label": args.label, "tree": tree,
              "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "build_s": common.build_info["seconds"], "parts": args.parts,
              "gather": [], "max_pool_bwd": [], "reduce": [],
              "normalize": []}
    gen = torch.Generator(device="cuda").manual_seed(0)

    if "floor" in parts and hasattr(common, "empty_kernel"):
        result["launch_floor"] = smoke.launch_floor()

    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    i32, i64 = torch.int32, torch.int64
    gathers = (
        ("32 of 256 VGG16 images f32", 256, (224, 224, 3), 32, f32, i32),
        ("32 of 256 VGG16 images f32, int64 indices", 256, (224, 224, 3),
         32, f32, i64),
        ("32 of 1,024 VGG16 images uint8", 1024, (224, 224, 3), 32, u8,
         i32),
        ("MNIST minibatch, 100 of 60,000 uint8", 60000, (784,), 100, u8,
         i32))
    for what, n, sample, batch, dtype, index_dtype in (
            gathers if "gather" in parts else ()):
        data = smoke.gather_dataset(n, sample, dtype, gen)
        ms, library_ms, sets = smoke.time_gather(data, batch, index_dtype,
                                                 gen)
        result["gather"].append({
            "what": what, "ms": ms, "library_ms": library_ms,
            "bound_ms": smoke.gather_bound(
                batch, data[0].numel(), data.element_size(),
                sets[0][0].element_size())[0],
            "rotation": len(sets), "cold_l2": smoke.cold_dataset(data),
            "dataset_mb": data.numel() * data.element_size() / 1e6})
        del data, sets

    pools = (("VGG16 pool1, batch 8", (8, 224, 224, 64), (2, 2)),
             ("AlexNet pool1, batch 32", (32, 55, 55, 96), (3, 3)),
             ("overlapping ceil-mode", (3, 13, 13, 96), (3, 3)))
    for what, shape, window in pools if "pool" in parts else ():
        sliding = (2, 2)
        ms, library_ms, (x, y, _) = smoke.time_pool(shape, window, sliding,
                                                    gen)
        result["max_pool_bwd"].append({
            "what": what, "ms": ms, "library_ms": library_ms,
            "bound_ms": smoke.pool_bound(x, y)[0]})
        del x, y
    if "pool" in parts:
        result["vgg16_step_pools"] = smoke.pool_step(gen)

    reduces = (("reduce_cols", (3001, 3001), f32),
               ("reduce_rows", (3001, 3001), f32),
               ("reduce_cols", (60000, 784), f32),
               ("reduce_rows", (32, 25088), f32),
               ("reduce_rows", (60000, 784), f32),
               ("reduce_cols", (4096, 4096), bf16),
               ("reduce_rows", (4096, 4096), bf16),
               ("reduce_cols", (32, 25088), f32),
               ("reduce_cols", (100, 784), f32),
               ("reduce_cols", (33, 129), f32),
               ("reduce_cols", (7, 3), f32))
    for kind, shape, dtype in reduces if "reduce" in parts else ():
        x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
        ms, library_ms, sets = smoke.time_reduce(kind, x)
        out = shape[1] if kind == "reduce_cols" else shape[0]
        result["reduce"].append({
            "what": "%s %dx%d %s" % ((kind,) + shape +
                                     (str(dtype).split(".")[-1],)),
            "ms": ms, "library_ms": library_ms, "rotation": sets,
            "bound_ms": smoke.f32_bound(
                x.element_size() * (x.numel() + out), 0)[0]})
        del x

    # (shape, bytes x starts into its storage): 1 times an unaligned view
    normalizes = (((100, 784), 0), ((4096, 3072), 0), ((4096, 3072), 1))
    for shape, skip in normalizes if "normalize" in parts else ():
        flat = torch.randint(0, 256, (shape[0] * shape[1] + skip,),
                             generator=gen, device="cuda", dtype=u8)
        x = flat[skip:].view(shape)
        mean = torch.rand(shape[1], generator=gen, device="cuda") * 255
        rdisp = torch.rand(shape[1], generator=gen, device="cuda") + 0.5
        ms, sets = smoke.time_normalize(x, mean, rdisp)
        result["normalize"].append({
            "what": "mean_disp_normalize %dx%d uint8 -> f32%s" % (
                shape + (", unaligned view" if skip else "",)),
            "ms": ms, "rotation": sets, "x_offset_bytes": skip,
            "bound_ms": smoke.f32_bound(5 * x.numel() + 8 * shape[1],
                                        0)[0]})
        del x, flat

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            json.dump(result, fout, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
