"""Run ``chip_smoke.py``'s examples phase alone on the card.

    python3 scripts/torch_examples_phase.py [--out chiprun_out/x.json]

Builds the kernels, holds kernels 6-8 at examples/transformer.py's
attention shapes, kernel 12 at examples/conv_autoencoder.py's conv and
examples/stl10.py's four convs, and kernel 13 at examples/stl10.py's
four pools against their plain versions
(``chip_smoke.examples_kernel_checks``), then runs
``chip_smoke.examples_phase``: the six digits examples to their JAX
quality limits, the four dataset-gated ones one evaluation and one
train step each on seeded drops, and the autoencoder through ``python
-m veles_tpu_torch`` with no ``-d`` (``chip_smoke.py``'s docstring,
section 22).  Prints the phase's summary as one JSON line
(``examples: {...}``) and writes it to ``--out``.  Needs a CUDA card; it
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
        ROOT, "chiprun_out", "examples_phase.json"))
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
    directory = tempfile.mkdtemp(prefix="examples_phase_")
    os.environ["VELES_SCHEDULE_CACHE"] = os.path.join(directory, "cache")
    try:
        start = time.perf_counter()
        common.load_kernels()
        print("build %.1f s" % (time.perf_counter() - start), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        start = time.perf_counter()
        attn, wgrads, pools = chip_smoke.examples_kernel_checks(gen)
        checks_s = time.perf_counter() - start
        device = Device()
        start = time.perf_counter()
        launches, summary = chip_smoke.examples_phase(device, directory)
        summary["phase_s"] = time.perf_counter() - start
        summary["kernel_checks_s"] = checks_s
        summary["attention"] = attn
        summary["conv_wgrad"] = wgrads
        summary["max_pool_bwd"] = pools
        summary["launches_total"] = launches
        summary["card"] = smi
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    text = json.dumps(summary)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fout:
        fout.write(text)
    print("examples: " + text, flush=True)


if __name__ == "__main__":
    main()
