#!/usr/bin/env python3
"""Time the port's gather, max-pool backward and reduction kernels on
the card's clock with a cold L2, for one tree of the repository.

    python3 scripts/torch_pool_gather_timing.py [--tree DIR]
        [--label NAME] [--out PATH]

``--tree`` names a checkout whose ``veles_tpu_torch`` is timed (default:
this one), so that two commits can be compared in one run on one card:
run it for the parent, the change, the change and the parent.  The
timing functions are this checkout's ``chip_smoke.py`` (``time_gather``,
``time_pool``, ``pool_step``, ``time_reduce``): device time a call with
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
(60000, 784) and (32, 25088).  Prints the summary with the card's name
and power limit as JSON, and also writes it to ``--out``.  Needs a CUDA
card.
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
    parser.add_argument("--out", help="also write the summary here")
    args = parser.parse_args()

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
              "build_s": common.build_info["seconds"], "gather": [],
              "max_pool_bwd": [], "reduce": []}
    gen = torch.Generator(device="cuda").manual_seed(0)

    for what, n, sample, batch, dtype, index_dtype in (
            ("32 of 256 VGG16 images f32", 256, (224, 224, 3), 32,
             torch.float32, torch.int32),
            ("32 of 256 VGG16 images f32, int64 indices", 256,
             (224, 224, 3), 32, torch.float32, torch.int64),
            ("32 of 1,024 VGG16 images uint8", 1024, (224, 224, 3), 32,
             torch.uint8, torch.int32),
            ("MNIST minibatch, 100 of 60,000 uint8", 60000, (784,), 100,
             torch.uint8, torch.int32)):
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

    for what, shape, window in (
            ("VGG16 pool1, batch 8", (8, 224, 224, 64), (2, 2)),
            ("AlexNet pool1, batch 32", (32, 55, 55, 96), (3, 3)),
            ("overlapping ceil-mode", (3, 13, 13, 96), (3, 3))):
        sliding = (2, 2)
        ms, library_ms, (x, y, _) = smoke.time_pool(shape, window, sliding,
                                                    gen)
        result["max_pool_bwd"].append({
            "what": what, "ms": ms, "library_ms": library_ms,
            "bound_ms": smoke.pool_bound(x, y)[0]})
        del x, y
    result["vgg16_step_pools"] = smoke.pool_step(gen)

    for kind, shape in (("reduce_cols", (3001, 3001)),
                        ("reduce_rows", (3001, 3001)),
                        ("reduce_cols", (60000, 784)),
                        ("reduce_rows", (32, 25088))):
        x = torch.rand(shape, generator=gen, device="cuda")
        ms, library_ms, sets = smoke.time_reduce(kind, x)
        out = shape[1] if kind == "reduce_cols" else shape[0]
        result["reduce"].append({
            "what": "%s %dx%d f32" % ((kind,) + shape), "ms": ms,
            "library_ms": library_ms, "rotation": sets,
            "bound_ms": smoke.f32_bound(4 * (x.numel() + out), 0)[0]})
        del x

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            json.dump(result, fout, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
