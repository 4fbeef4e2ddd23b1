#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload NAME --seed N --seconds S \\
        --trace 0|1

from the root of a checkout.  The cell (a configuration and a traffic
mix, ``BENCHMARK.json``'s ``workloads``) runs on the CUDA card: set-up
(weights and inputs from ``--seed``, the program's build, warm-up and
captures), a window of ``--seconds``, then the comparison with the
plain reference.  With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` trace of the window.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error list the same checks.  Exits
with 2, and prints no result, when there is no CUDA card or fewer than
the cell asks for, and with 3 when the process holds JAX or the JAX
package after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root in place of this file's directory, whose module
# names (trace, serve, ...) would shadow others
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT
#: whole top-level module names the benchmark's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "veles_tpu")


def cache_dirs(root):
    """Every build and kernel cache inside the checkout, at fixed
    paths (the program's kernel library builds into its own
    ``veles_tpu_torch/build/``)."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    # a library that would load JAX by itself keeps from it
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from portbench.bench import Bench
    bench = Bench(ROOT)
    chips = int(bench.workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: %s needs %d CUDA card(s); this machine has %d" % (
            args.workload, chips, torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    from portbench.harness import run_cell
    result, _ = run_cell(bench, args.workload, args.seed, args.seconds,
                         args.trace, "cuda", T_START)
    found = forbidden_modules()
    if found:
        print("portbench: the process holds %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    for name, value, limit in result["checks"]:
        print("check %s %r limit %r" % (name, value, limit),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
