"""Run ``chip_smoke.py``'s distributed phase alone on the card.

    python3 scripts/torch_distributed_phase.py [--out chiprun_out/x.json]

Builds the kernels, holds kernel 12 at
``veles_tpu_torch/examples/digits_conv.py``'s two convs and kernel 13
at its two pools against their plain versions
(``chip_smoke.distributed_kernel_checks``), then runs
``chip_smoke.distributed_phase``: digits_conv through a ``Server`` and
one ``Client`` on the card for 40 epochs (best validation error at most
2.5 %, the slave's launches counted), a pair of 4-epoch runs held bit
for bit through three seeded slave deaths, one train job's update in
three processes, and ``scripts/torch_elastic_soak.py``'s SIGKILL soak
of slave subprocesses (``chip_smoke.py``'s docstring, section 23).
Prints the phase's summary as one JSON line (``distributed: {...}``)
and writes it to ``--out``.  Needs a CUDA card; it raises without one.
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
        ROOT, "chiprun_out", "distributed_phase.json"))
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
    directory = tempfile.mkdtemp(prefix="distributed_phase_")
    os.environ["VELES_SCHEDULE_CACHE"] = os.path.join(directory, "cache")
    try:
        start = time.perf_counter()
        common.load_kernels()
        print("build %.1f s" % (time.perf_counter() - start), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        start = time.perf_counter()
        wgrads, pools = chip_smoke.distributed_kernel_checks(gen)
        checks_s = time.perf_counter() - start
        device = Device()
        start = time.perf_counter()
        launches, summary = chip_smoke.distributed_phase(device, directory)
        summary["phase_s"] = time.perf_counter() - start
        summary["kernel_checks_s"] = checks_s
        summary["conv_wgrad"] = wgrads
        summary["max_pool_bwd"] = pools
        summary["card"] = smi
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    text = json.dumps(summary)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fout:
        fout.write(text)
    print("distributed: " + text, flush=True)


if __name__ == "__main__":
    main()
