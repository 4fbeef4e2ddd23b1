"""Run ``chip_smoke.py``'s parallel phase alone on the card.

    python3 scripts/torch_parallel_phase.py [--out chiprun_out/x.json]

Builds the kernels, then runs ``chip_smoke.parallel_phase``: VGG16's
meshed steps and the transformer's TP and pipeline steps in a world of
one on NCCL, two gloo ranks sharing the card, and the digits CLI under
``VELES_COORDINATOR`` (``chip_smoke.py``'s docstring, section 18).
Prints the phase's summary as one JSON line (``parallel: {...}``) and
writes it to ``--out``.  Needs a CUDA card; it raises without one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "parallel_phase.json"))
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common
    print("python %s, torch %s, cuda %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda),
        flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    start = time.perf_counter()
    common.load_kernels()
    print("build %.1f s" % (time.perf_counter() - start), flush=True)
    start = time.perf_counter()
    _, summary = chip_smoke.parallel_phase(Device(), smi)
    summary["phase_s"] = time.perf_counter() - start
    text = json.dumps(summary)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fout:
        fout.write(text)
    print("parallel: " + text, flush=True)


if __name__ == "__main__":
    main()
