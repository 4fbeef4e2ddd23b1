"""Run ``chip_smoke.py``'s numpy phase alone on the card.

    python3 scripts/torch_numpy_phase.py [--out PATH] [--device cpu]

Builds the kernels, then runs :func:`numpy_phase`: digits_conv
(``veles_tpu_torch/examples/digits_conv.py``, at its full width: conv
16, pool, conv 32, pool, 64, 10; minibatch 48) per unit for
``EPOCHS`` epochs through the ``Launcher``, three times from one seed:

(a) on the host pseudo-device (``Device("numpy")``, what ``-d numpy``
    gives): every unit takes its host run.  Every registered kernel
    wrapper's launch count (``graphs.counters()``), set to 0 before the
    run, is still 0 after it, and every Array of the workflow stays
    host-only;
(b) on ``Device("cpu")``: its weights and solver state are bit-equal to
    (a)'s (both legs at one intra-op thread, so the comparison holds
    the math alone, not the thread count's reduction order);
(c) on the card, per unit (``auto_fuse`` off): its final validation
    error within ``CARD_POINTS`` points of (a)'s, and the largest
    relative difference of its leaves from (a)'s recorded.  Its
    launches are counted from 0 around the run;
(d) ``python -m veles_tpu_torch <digits_conv> - -d numpy --result-file
    R`` in a child process, for ``CHILD_EPOCHS`` epoch: it exits 0,
    writes R, and ends with ``torch.cuda.is_initialized()`` false.

Prints the phase's summary as one JSON line (``numpy: {...}``) and,
with ``--out``, writes it there.  Needs a CUDA card; ``--device cpu``
rehearses the legs on the CPU ((c) then runs on the CPU device).
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
EXAMPLE = os.path.join(ROOT, "veles_tpu_torch", "examples",
                       "digits_conv.py")

EPOCHS, CHILD_EPOCHS = 2, 1
SEED = 1234
#: the host run's final validation error against the card's, in points
#: (tests/test_models.py's numpy backend parity limit)
CARD_POINTS = 3.0
#: the child run prints this, then True or False, as it exits
CHILD_MARK = "CUDA_INITIALIZED="
CHILD = (
    "import atexit, runpy, sys, torch\n"
    "atexit.register(lambda: print('%s%%s' %% torch.cuda.is_initialized(),"
    " flush=True))\n"
    "sys.argv[0] = 'veles_tpu_torch'\n"
    "runpy.run_module('veles_tpu_torch', run_name='__main__',"
    " alter_sys=True)\n" % CHILD_MARK)


def _counters():
    from veles_tpu_torch import graphs
    return graphs.counters()


def _sync():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _host_state(sw):
    """Every layer's parameter and solver-state leaves, read to the
    host, in order."""
    from veles_tpu_torch.compiler import state_arrays
    leaves = []
    for fwd, gd in zip(sw.forwards, sw.gds):
        for key, arr in state_arrays(fwd, gd):
            if arr:
                arr.map_read()
                leaves.append((key, arr.mem.copy()))
    return leaves


def _host_only(sw):
    """The number of the workflow's unit Arrays that hold a device
    tensor (0 on the host pseudo-device)."""
    from veles_tpu_torch.memory import Array
    attached = 0
    for unit in sw.units:
        for value in vars(unit).values():
            if isinstance(value, Array) and (
                    value.device is not None or
                    value._devmem_ is not None):
                attached += 1
    return attached


def train(device, epochs=EPOCHS, threads=None):
    """digits_conv per unit for ``epochs`` epochs on ``device`` through
    a standalone Launcher, from SEED.  Returns (workflow, seconds,
    {kernel: launches during the run})."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.examples import digits_conv
    from veles_tpu_torch.launcher import Launcher
    root.digits_conv.max_epochs = epochs
    auto_fuse = root.common.engine.get("auto_fuse", True)
    root.common.engine.auto_fuse = False  # per unit on the card too
    saved_threads = torch.get_num_threads()
    try:
        if threads:
            torch.set_num_threads(threads)
        launcher = Launcher(master_address="", listen_address="",
                            web_status="", trace="", metrics_interval=0,
                            metrics_path="", profile="", alerts=False)
        prng.get().seed(SEED)
        sw = digits_conv.build(launcher)
        _sync()
        counters = _counters()
        for wrapper in counters:
            wrapper.launches = 0
        start = time.perf_counter()
        launcher.initialize(device=device)
        launcher.run()
        _sync()
        seconds = time.perf_counter() - start
        launches = {w.__name__: w.launches for w in counters}
    finally:
        root.common.engine.auto_fuse = auto_fuse
        torch.set_num_threads(saved_threads)
    assert getattr(sw, "fused_trainer", None) is None, "fused"
    assert sw.decision.epoch_number == epochs, sw.decision.epoch_number
    return sw, seconds, launches


def host_legs(card):
    """(a), (b) and (c).  Returns (summary, {kernel: launches of the
    card's run})."""
    from veles_tpu_torch.backends import Device, NumpyDevice
    numpy_sw, numpy_s, numpy_launches = train(Device("numpy"), threads=1)
    assert isinstance(numpy_sw.forwards[0].device, NumpyDevice)
    attached = _host_only(numpy_sw)
    assert attached == 0, "%d Arrays on a device" % attached
    assert not any(numpy_launches.values()), numpy_launches
    cpu_sw, cpu_s, _ = train(Device("cpu"), threads=1)
    host, cpu = _host_state(numpy_sw), _host_state(cpu_sw)
    equal = [key for (key, a), (_, b) in zip(host, cpu)
             if a.dtype == b.dtype and a.tobytes() == b.tobytes()]
    assert len(host) == len(cpu) == len(equal), (len(host), equal)
    card_sw, card_s, card_launches = train(card)
    numpy_error = numpy_sw.decision.epoch_metrics[1]
    card_error = card_sw.decision.epoch_metrics[1]
    assert abs(numpy_error - card_error) <= CARD_POINTS, \
        (numpy_error, card_error)
    # how far the card's per-unit run drifted from the host's, leaf by
    # leaf (recorded, not held to a limit: the errors above are)
    drift = max(float(abs(b.astype("float64") - a).max() /
                      max(abs(a).max(), 1e-30))
                for (_, a), (_, b) in zip(host, _host_state(card_sw)))
    return {"epochs": EPOCHS, "numpy_s": numpy_s, "cpu_s": cpu_s,
            "card_s": card_s, "numpy_launches": numpy_launches,
            "leaves_bit_equal": len(equal),
            "numpy_validation_error": numpy_error,
            "card_validation_error": card_error,
            "cpu_validation_error": cpu_sw.decision.epoch_metrics[1],
            "card_leaf_max_rel": drift,
            "card_launches": card_launches}, card_launches


def child(directory):
    """(d): the command line with ``-d numpy`` in a child process."""
    result = os.path.join(directory, "numpy.json")
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONFAULTHANDLER="1")
    for name in ("VELES_BACKEND", "VELES_CHAOS"):
        env.pop(name, None)
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, EXAMPLE, "-", "-d", "numpy",
         "-r", str(SEED), "--result-file", result,
         "root.digits_conv.max_epochs=%d" % CHILD_EPOCHS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=directory, timeout=240)
    seconds = time.perf_counter() - start
    assert proc.returncode == 0, proc.stderr[-3000:]
    marks = [line for line in proc.stdout.splitlines()
             if line.startswith(CHILD_MARK)]
    assert marks == [CHILD_MARK + "False"], (marks, proc.stdout[-2000:])
    with open(result) as fin:
        results = json.load(fin)
    assert "NumpyDevice" in proc.stderr, proc.stderr[-2000:]
    return {"seconds": seconds, "cuda_initialized": False,
            "result_keys": sorted(results)}


def numpy_phase(device, directory):
    """The numpy phase.  Returns ({kernel: launches of the card's run},
    summary)."""
    start = time.perf_counter()
    summary, launches = host_legs(device)
    summary["child"] = child(directory)
    summary["seconds"] = time.perf_counter() - start
    return launches, summary


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None,
                        help="also write the summary to this file")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common
    device = Device(args.device)
    directory = tempfile.mkdtemp(prefix="numpy_phase_")
    os.environ["VELES_SCHEDULE_CACHE"] = os.path.join(directory, "cache")
    from veles_tpu_torch.observe.flight import flight
    flight.base_path = os.path.join(directory, "veles_flight")
    summary = {}
    try:
        if args.device == "cuda":
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                text=True, check=True).stdout.strip()
            print("%s; python %s, torch %s, cuda %s" % (
                smi, sys.version.split()[0], torch.__version__,
                torch.version.cuda), flush=True)
            start = time.perf_counter()
            common.load_kernels()
            summary.update(build_s=time.perf_counter() - start, card=smi)
        _, phase = numpy_phase(device, directory)
        summary.update(phase)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    text = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            fout.write(text)
    print("numpy: " + text, flush=True)


if __name__ == "__main__":
    main()
