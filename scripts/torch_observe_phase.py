"""Run ``chip_smoke.py``'s observe phase alone on the card.

    python3 scripts/torch_observe_phase.py [--out chiprun_out/x.json]

Builds the kernels and VGG16's int8 model spec, then runs
``chip_smoke.observe_phase``: the int8 engine's compile receipt and step
dtype, ``python -m veles_tpu_torch`` on digits_conv with ``--trace``,
``--metrics-interval``, ``--alerts`` and ``--profile`` in a child
process, VGG16's live MFU against a CUDA-event cross-check with the
tracer off and on, the transformer's backward attribution and a
per-unit MNIST epoch's unit spans (``chip_smoke.py``'s docstring,
section 21).  Prints the phase's summary as one JSON line
(``observe: {...}``) and writes it to ``--out``.  Needs a CUDA card; it
raises without one.
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
        ROOT, "chiprun_out", "observe_phase.json"))
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
    directory = tempfile.mkdtemp(prefix="observe_phase_")
    os.environ["VELES_SCHEDULE_CACHE"] = os.path.join(directory, "cache")
    try:
        start = time.perf_counter()
        common.load_kernels()
        print("build %.1f s" % (time.perf_counter() - start), flush=True)
        device = Device()
        vgg16 = chip_smoke.vgg16_int8_spec(device)
        start = time.perf_counter()
        launches, summary = chip_smoke.observe_phase(device, vgg16,
                                                     directory)
        summary["phase_s"] = time.perf_counter() - start
        summary["launches_total"] = launches
        summary["card"] = smi
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    text = json.dumps(summary)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fout:
        fout.write(text)
    print("observe: " + text, flush=True)


if __name__ == "__main__":
    main()
