"""Run ``chip_smoke.py``'s tune phase alone on the card.

    python3 scripts/torch_tune_phase.py [--out chiprun_out/x.json]

Builds the kernels and VGG16's int8 model spec, then runs
``chip_smoke.tune_phase`` on a private schedule cache: a tiny GA per
kernel family, each kernel under its winner and a planted schedule
against its plain version and its static run, the walk of VGG16's step
with planted wgrad schedules, the schedule bank from a publish to a
reload, and ``python -m veles_tpu_torch.tune`` twice
(``chip_smoke.py``'s docstring, section 19).  Prints the phase's
summary as one JSON line (``tune: {...}``) and writes it to ``--out``.
Needs a CUDA card; it raises without one.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "tune_phase.json"))
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    print("%s; python %s, torch %s, cuda %s" % (
        smi, sys.version.split()[0], torch.__version__, torch.version.cuda),
        flush=True)
    directory = tempfile.mkdtemp(prefix="tune_phase_")
    os.environ["VELES_SCHEDULE_CACHE"] = os.path.join(directory, "run")
    try:
        start = time.perf_counter()
        common.load_kernels()
        print("build %.1f s" % (time.perf_counter() - start), flush=True)
        device = Device()
        vgg16 = chip_smoke.vgg16_int8_spec(device)
        start = time.perf_counter()
        launches, summary = chip_smoke.tune_phase(device, vgg16, directory)
        summary["phase_s"] = time.perf_counter() - start
        summary["launches"] = launches
        summary["card"] = smi
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    text = json.dumps(summary)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fout:
        fout.write(text)
    print("tune: " + text, flush=True)


if __name__ == "__main__":
    main()
