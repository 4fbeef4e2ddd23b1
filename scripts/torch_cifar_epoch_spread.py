#!/usr/bin/env python3
"""The spread of chip_smoke.py's fused CIFAR-10 epoch between identical
runs on one card.

    python3 scripts/torch_cifar_epoch_spread.py [--tree DIR] [--runs N]
        [--pipeline on|off] [--deterministic] [--check-inputs]
        [--gain G|default] [--out PATH]

Builds chip_smoke.py's fused CIFAR-10 workflow (examples/cifar10.py's
widths, its strict-ReLU variant, minibatch 100, 50,000 + 10,000 seeded
images, weights from one seed) from the checkout ``--tree`` (default:
this one) ``--runs`` times and runs one epoch of each (validation,
train, validation) under ``Workflow.run``, as the smoke's epoch check
does; ``--pipeline`` sets ``root.common.engine.pipeline_input`` where
the tree has it, ``--deterministic`` turns cuDNN's deterministic
algorithms on, ``--gain`` draws the strict-ReLU layers' weights uniform
in +-G/sqrt(fan_in) (``default``: the units' own 1/sqrt(fan_in); by
default the tree's ``CIFAR_GAIN`` where it has one).  ``--check-inputs`` holds what each step's captured graph
read (its static inputs, cloned on the graph's stream after the step)
against the loader's rows indexed by ``index_select`` at the serve (on
the serving thread's stream), minibatch by minibatch.  Reports each
run's final validation error, its epoch metrics, its skipped steps, the
train loss at every 50th train step, SHA-1 digests of every step's loss
and of the final weights, and the inputs that differed, with the card's
name and power limit, as JSON (also written to ``--out``).  Needs a CUDA
card.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--pipeline", choices=("on", "off"), default="on")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--check-inputs", action="store_true")
    parser.add_argument("--gain")
    parser.add_argument("--out")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_cifar_epoch_spread: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.normalization import MeanDispersionNormalizer
    torch.backends.cudnn.deterministic = args.deterministic
    root.common.engine.pipeline_input = args.pipeline == "on"
    device = Device()
    gain = args.gain or getattr(cs, "CIFAR_GAIN", "default")
    gain_kwargs = {} if gain == "default" else {"gain": float(gain)}
    arrays = cs.cifar_arrays(cs.CIFAR_SEED)
    stats = MeanDispersionNormalizer()
    stats.analyze(arrays[2])
    runs = []
    for _ in range(args.runs):
        sw = cs.standard_workflow(arrays, stats, device, False,
                                  cs.cifar_layers("str", **gain_kwargs),
                                  cs.CIFAR_BATCH,
                                  cs.CIFAR_SEED, "cifar", 3)[0]
        trainer = sw.fused_trainer
        losses, every_loss = [], []
        probe = InputProbe(trainer) if args.check_inputs else None
        step = type(trainer).run

        def run(self, step=step):
            step(self)
            if probe is not None:
                probe.after_step()
            if self.sw.loader.minibatch_class == TRAIN:
                losses.append(self.last_loss)
        type(trainer).run = run
        try:
            if probe is not None:
                probe.__enter__()
            sw.run()
            error = None
        except Exception as exc:     # a divergence ends the run: report it
            error = repr(exc)
        finally:
            type(trainer).run = step
            if probe is not None:
                probe.__exit__()
            torch.cuda.synchronize()
        every_loss = [float(loss) for loss in losses]
        weights = hashlib.sha1()
        for leaf in cs.to_host(cs.unit_state(sw)):
            for key in sorted(leaf):
                if leaf[key] is not None:
                    weights.update(leaf[key].tobytes())
        runs.append({
            "validation_error_pct": sw.decision.epoch_metrics[1],
            "epoch_metrics": sw.decision.epoch_metrics,
            "skipped_steps": int(trainer.skip_count), "error": error,
            "pipelined": getattr(trainer, "prefetcher", None) is not None,
            "train_loss_every_50": every_loss[::50],
            "losses_sha1": hashlib.sha1(json.dumps(
                every_loss).encode()).hexdigest(),
            "weights_sha1": weights.hexdigest(),
            "inputs": None if probe is None else probe.report()})
        print(json.dumps(runs[-1]), flush=True)
        sw.stop()
        del sw, trainer, probe
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    result = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "tree": tree, "pipeline": args.pipeline, "gain": gain,
              "deterministic": args.deterministic, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            json.dump(result, fout, indent=1)
    print(json.dumps(result))
    return 0


class InputProbe(object):
    """Each serve's rows by ``index_select`` (on the serving thread's
    stream, after the loader's gather) and each step's static graph
    inputs (cloned on the graph's stream after the step), compared in
    order at the end."""

    def __init__(self, trainer):
        import veles_tpu_torch.loader.fullbatch as fullbatch
        self.fullbatch = fullbatch
        self.trainer = trainer
        self.served, self.read = [], []
        self.real = (fullbatch.gather_minibatch, fullbatch.gather_labels)

    def __enter__(self):
        import torch
        real_data, real_labels = self.real
        served = self.served

        def gather_minibatch(original, idx, dtype, out=None):
            got = real_data(original, idx, dtype, out=out)
            rows = idx.clamp(0, original.shape[0] - 1).to(torch.int64)
            served.append([original.index_select(0, rows).to(dtype)])
            return got

        def gather_labels(labels, idx, out=None):
            got = real_labels(labels, idx, out=out)
            rows = idx.clamp(0, labels.shape[0] - 1).to(torch.int64)
            served[-1].append(labels.index_select(0, rows))
            return got
        self.fullbatch.gather_minibatch = gather_minibatch
        self.fullbatch.gather_labels = gather_labels
        return self

    def __exit__(self, *exc):
        self.fullbatch.gather_minibatch, self.fullbatch.gather_labels = \
            self.real

    def after_step(self):
        inputs = self.trainer._step_fn_._inputs
        by_role = {role: tensor for (role, _, _), tensor in inputs.items()}
        self.read.append([by_role["x"].clone(), by_role["target"].clone()])

    def report(self):
        import torch
        torch.cuda.synchronize()
        differ = [k for k, (read, served) in
                  enumerate(zip(self.read, self.served))
                  if not all(torch.equal(r, s) for r, s in zip(read, served))]
        return {"steps": len(self.read), "serves": len(self.served),
                "differ": len(differ), "first_differ": differ[:10]}


if __name__ == "__main__":
    sys.exit(main())
