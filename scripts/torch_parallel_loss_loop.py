"""Repeat the parallel phase's plain transformer chain after VGG16's
meshed steps on the card, and hold every donated loss to the raw step's.

    python3 scripts/torch_parallel_loss_loop.py [--rounds 3] [--chains 4]
        [--out chiprun_out/loss_loop.json]

Joins a world of one on NCCL, as ``chip_smoke.parallel_phase`` does.
Each round runs ``chip_smoke.parallel_vgg16`` (the NCCL-captured VGG16
variants, their graphs deleted and the cache emptied after), then
``--chains`` times builds the plain donated transformer step (a new
graph owner and memory pool each time) and chains ``PAR_STEPS`` keyless
steps on the phase's one minibatch from the same state.  The witness is
the raw chain (``donate=False``: no graph, no static buffers) on the
same inputs, run once before the rounds and once after each.  Prints
every chain's losses and their packed words (``finite``, ``skipped``,
``grad_norm``); exits 1 if a donated chain's first loss is not positive
or any loss differs from the raw chain's (rel 1e-5, a zero only against
a zero).  Every round must also find room for VGG16's captures: a
dropped meshed step that a reference cycle kept alive held its graphs'
memory, and the third round ran out of it.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--chains", type=int, default=4)
    parser.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "loss_loop.json"))
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    import torch.distributed as dist
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.compiler import build_train_step
    from veles_tpu_torch.convert import state_from_jax
    from veles_tpu_torch.ops import common
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    common.load_kernels()
    torch.backends.cudnn.deterministic = True
    device = Device()
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d"
                            % chip_smoke.free_port(), rank=0, world_size=1)
    plans, host, x, t = chip_smoke.tf_chain_inputs()
    raw = [chip_smoke.raw_chain_losses(plans, host, x, t, device)]
    print("raw chain: %s" % raw[0], flush=True)
    chains, faults = [], []
    start = time.perf_counter()
    try:
        for r in range(args.rounds):
            with tempfile.TemporaryDirectory() as workdir:
                chip_smoke.parallel_vgg16(device, workdir)
            for c in range(args.chains):
                step = build_train_step(plans)
                state, row = state_from_jax(host, device), []
                for _ in range(chip_smoke.PAR_STEPS):
                    state, m = step(state, x, t, float(x.shape[0]))
                    row.append({k: float(v) for k, v in m.items()})
                losses = [w["loss"] for w in row]
                chains.append({"round": r, "chain": c, "steps": row})
                print("round %d chain %d: %s" % (r, c, json.dumps(row)),
                      flush=True)
                try:
                    chip_smoke.check_chain_losses(
                        "round %d chain %d" % (r, c), losses, raw[0])
                except AssertionError as exc:
                    faults.append(str(exc))
                    print("FAULT " + str(exc), flush=True)
                del step, state
            raw.append(chip_smoke.raw_chain_losses(plans, host, x, t,
                                                   device))
            print("raw chain after round %d: %s" % (r, raw[-1]), flush=True)
            if raw[-1] != raw[0]:
                faults.append("the raw chain moved: %s vs %s"
                              % (raw[-1], raw[0]))
    finally:
        dist.destroy_process_group()
    summary = {"card": smi, "raw": raw, "chains": chains, "faults": faults,
               "seconds": time.perf_counter() - start}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fout:
        json.dump(summary, fout)
    print("loss loop: %d chains, %d faults" % (len(chains), len(faults)),
          flush=True)
    sys.exit(1 if faults else 0)


if __name__ == "__main__":
    main()
