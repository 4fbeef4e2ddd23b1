#!/usr/bin/env python3
"""The controls of ``correct``: the plain reference put in the
program's place, computed one precision below the configuration's or
with a fault planted, and read by the same numbers and limits.

    python3 portbench/control.py --workload NAME --seeds 1,2,3 \\
        [--mode tf32|int4|half_batch]

- ``tf32``: the float32 reference with TF32 on (training, and f32
  serving);
- ``int4``: the int8 serving reference at 4 bits (``qmax`` 7): its
  4-bit quantization of the seeded weights on the seeded calibration
  images as the program's state and its answers as the served ones,
  against the reference's own 8-bit quantization and answers;
- ``half_batch``: a training step that leaves out half of each
  minibatch and takes the mean over the rest.

Each mode reads the cell's numbers at the cell's own sizes (three
steps of the traffic's batch; the serving check's sample of the pool)
from each seed and prints them beside the limits as one JSON line a
seed.  The benchmark's own runs do not run this.  Needs a CUDA card
unless ``--device cpu``.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT

import numpy  # noqa: E402
import torch  # noqa: E402

from portbench import check, inputs, reference  # noqa: E402
from portbench.bench import Bench  # noqa: E402

__all__ = ["train_readings", "serve_readings", "control"]

MODES = {"train": ("tf32", "half_batch"), "serve": ("tf32", "int4")}


def _batches(model, traffic, seed, dev, half=False):
    """The first three minibatches of a seeded order over the traffic's
    images (``half``: the first half of each)."""
    samples, batch = int(traffic["samples"]), int(traffic["batch"])
    images = inputs.make_images(model, seed, "train_images", samples, dev)
    labels = inputs.make_labels(model, seed, "train_labels", samples, dev)
    order = torch.randperm(samples, generator=inputs.generator(
        seed, "control_order", "cpu"))
    take = batch // 2 if half else batch
    out = []
    for i in range(3):
        rows = order[i * batch:i * batch + take].to(dev)
        out.append((images[rows], labels[rows]))
    return out


def train_readings(model, traffic, seed, dev, mode):
    """The training numbers of the control ``mode`` against the
    reference, on three minibatches of the cell's batch."""
    from portbench.train import dropout_seed
    lr = model.solver["learning_rate"]
    dseed = dropout_seed(seed)
    params = inputs.make_params(model, seed, dev)
    with reference.tf32(False):
        want = reference.train_steps(model, params,
                                     _batches(model, traffic, seed, dev),
                                     dseed)
    with reference.tf32(mode == "tf32"):
        got = reference.train_steps(
            model, params, _batches(model, traffic, seed, dev,
                                    half=mode == "half_batch"), dseed)
    got["grad_norms"] = [g * lr for g in got["grad_norms"]]
    return check.train_numbers(got, want, lr)


def serve_readings(model, traffic, seed, dev, mode):
    """The serving numbers of the control ``mode`` against the
    reference, on the check's sample size of the seeded pool: in f32
    the log-probabilities with TF32 on; in int8 the 4-bit quantization
    and its answers (module docstring)."""
    from portbench.serve import (SAMPLE, reference_logp,
                                 reference_quantized)
    pool = inputs.make_images(model, seed, "pool", int(traffic["pool"]),
                              dev)
    picks = torch.randint(0, pool.shape[0], (SAMPLE,),
                          generator=inputs.generator(seed, "control_picks",
                                                     "cpu")).to(dev)
    x = pool[picks]
    del pool
    if mode == "int4":
        int8 = reference_quantized(model, traffic, seed, dev)
        int4 = reference_quantized(model, traffic, seed, dev, qmax=7)
        numbers = check.quant_numbers(int4, int8)
        numbers.update(check.serve_numbers(
            reference_logp(model, traffic, seed, dev, x, int4),
            reference_logp(model, traffic, seed, dev, x, int8)))
        return numbers
    want = reference_logp(model, traffic, seed, dev, x)
    got = reference_logp(model, traffic, seed, dev, x, tf32=True)
    return check.serve_numbers(got, want)


def control(bench, workload, seed, mode, device="cuda"):
    entry = bench.workload(workload)
    model = bench.config(entry["config"])
    traffic = bench.traffic(entry["traffic"])
    if mode not in MODES[traffic["kind"]]:
        raise ValueError("mode %s does not apply to %s" % (mode, workload))
    if traffic["kind"] == "serve" and (mode == "int4") != (
            traffic["precision"] == "int8"):
        raise ValueError("mode %s does not apply to %s serving" % (
            mode, traffic["precision"]))
    dev = torch.device(device)
    fn = train_readings if traffic["kind"] == "train" else serve_readings
    numbers = fn(model, traffic, seed, dev, mode)
    correct, rows = check.judge(numbers, bench.limits(workload))
    return {"workload": workload, "mode": mode, "seed": seed,
            "numbers": numbers, "correct": correct, "checks": rows}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--mode", required=True,
                        choices=("tf32", "int4", "half_batch"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    for seed in args.seeds.split(","):
        out = control(bench, args.workload, int(seed), args.mode,
                      args.device)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    numpy.seterr(divide="ignore")
    sys.exit(main())
