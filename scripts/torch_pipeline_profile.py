#!/usr/bin/env python3
"""The input pipeline on the card: the fused trainer's minibatch with
the pipeline off and on, traced.

    python3 scripts/torch_pipeline_profile.py [--out PATH]

Runs ``scripts/torch_unit_graph_profile.py --mode graph --fused-only``
as child processes (one ``torch.profiler`` session each) for three
configurations: VGG16 at batch 32 with its loader on the host path
(``on_device=False``: a 19.3 MB float32 minibatch filled on the host
and uploaded each step) and on the device path (the gather), 4 traced
epochs of 4 minibatches each, and the MNIST unit graph (784 -> 100 ->
10, minibatch 100, 700 minibatches an epoch) on the device path.  Each
configuration runs with the pipeline off, on, on, off, so the two are
compared in turns on one card.  Reports, per run and minibatch: the
traced wall ms, the device busy ms and idle share, the pipeline's
``pipeline_fill`` / ``pipeline_h2d`` / ``pipeline_wait`` ms and the
``gather_minibatch`` launches; with the card's name and power limit, as
JSON, also written to ``--out``.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = (("vgg16_host", ["--model", "vgg16", "--loader-path", "host",
                           "--epochs", "4"]),
           ("vgg16_device", ["--model", "vgg16", "--loader-path", "device",
                             "--epochs", "4"]),
           ("mnist_device", ["--model", "mnist", "--loader-path", "device"]))
TURNS = ("off", "on", "on", "off")
KEEP = ("pipelined", "pipeline_stages", "gather_launches_per_minibatch",
        "traced_wall_ms_per_minibatch", "device_busy_ms_per_minibatch",
        "device_idle_share", "kernels_per_minibatch",
        "validation_error_pct")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the result here")
    args = parser.parse_args()
    script = os.path.join(HERE, "torch_unit_graph_profile.py")
    result = {}
    for name, argv in CONFIGS:
        runs = []
        for pipeline in TURNS:
            proc = subprocess.run(
                [sys.executable, script, "--mode", "graph", "--fused-only",
                 "--pipeline", pipeline] + argv, stdout=subprocess.PIPE,
                text=True)
            if proc.returncode != 0:
                raise RuntimeError("%s --pipeline %s exited with %d" % (
                    name, pipeline, proc.returncode))
            child = json.loads(proc.stdout.strip().splitlines()[-1])
            result.setdefault("card", child["card"])
            result.setdefault("nvidia_smi", child["nvidia_smi"])
            run = {key: child["fused"][key] for key in KEEP}
            run["pipeline"] = pipeline
            runs.append(run)
            print(json.dumps({name: run}), flush=True)
        result[name] = runs
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            json.dump(result, fout, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
