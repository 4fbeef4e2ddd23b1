"""Run ``chip_smoke.py``'s services phase alone on the card.

    python3 scripts/torch_services_phase.py [--out PATH]

Builds the kernels, then runs :func:`services_phase`: the services a
trained model leaves by, around digits_conv at its full width (conv 16,
pool, conv 32, pool, 64, 10; minibatch 48;
``scripts/torch_services_workflow.py``):

(a) digits_conv trained here on the card, fused with its input
    pipeline, :meth:`StandardWorkflow.link_plotters` linked and a
    ``GraphicsServer`` on its launcher, a ZMQ subscriber here receiving
    every plot: each error curve holds one point a finished epoch,
    equal to the decision's epoch metrics; the confusion matrix sums to
    the validation count; the histograms count every weight; the
    received plots' data equal the live plotters'; PNGs rendered where
    matplotlib imports.  The launches of ``gather_minibatch``,
    ``conv_wgrad`` and ``max_pool_bwd`` are counted from 0 around the
    leg: one gather a served minibatch, two of each of the others a
    train step;
(b) the publisher's Markdown and HTML reports of (a)'s workflow (and
    the PDF where matplotlib imports): the reported metrics equal the
    decision's, every unit has a row of run times;
(c) ``RESTfulAPI`` serving (a)'s workflow on the card, every validation
    digit posted over HTTP from 4 client threads: each answer's
    probabilities bit-equal to the engine's forward of that sample at
    the rung that served it (1 alone, 8 co-batched), the labels the
    argmax, ``requests_served`` the posts, the error over them the
    workflow's own validation error to within one sample; p50 and p99
    a request;
(d) ``package_export`` of (a)'s workflow uploaded by ``python -m
    veles_tpu_torch.forge upload`` to a git-backed ``ForgeServer`` here
    (plain storage where the machine has no git), fetched by the same
    command line, and run by ``NativeWorkflow`` on the host on 64
    validation digits: within rtol 1e-3, atol 1e-4 of the card's
    forward, equal labels; the native build's seconds and the host ms
    for the batch;
(e) ``python -m veles_tpu_torch --frontend 0`` in a child process: the
    page lists the port's flags, a ``/run`` without the token and one
    of ``-m veles_tpu`` are refused, a composed run of the workflow
    (no ``-d``) trains on the card and ``/status`` reads return code 0,
    its result file naming the card;
(f) ``python -m veles_tpu_torch -b --log-file L --result-file R`` of
    the workflow: the parent exits 0 at once, the daemon trains on the
    card and writes R within 120 s, its log names the card.

Prints the phase's summary as one JSON line (``services: {...}``) and,
with ``--out``, writes it there.  Needs a CUDA card.  ``--device cpu
--epochs N`` runs the same legs on the CPU (a rehearsal: the children
get ``-d cpu``; no number of the card).
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
WORKFLOW = os.path.join(SCRIPTS, "torch_services_workflow.py")

#: epochs of (a)'s training and of the composer's and daemon's runs
EPOCHS, CHILD_EPOCHS = 20, 3
REST_CLIENTS = 4
NATIVE_BATCH = 64
#: the native runtime against the card's forward (tests/test_native.py's
#: conv tolerance)
NATIVE_RTOL, NATIVE_ATOL = 1e-3, 1e-4
DAEMON_LIMIT_S = 120
#: seconds the whole phase may take before it dumps its stacks and ends
PHASE_LIMIT_S = 600


def log(*args):
    print(*args, flush=True)


def workflow_module():
    """``scripts/torch_services_workflow.py`` by its bare name, as the
    command line imports it."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import torch_services_workflow
    return torch_services_workflow


def services_counters():
    from veles_tpu_torch.ops.conv_vjp import conv_wgrad
    from veles_tpu_torch.ops.gather import gather_minibatch
    from veles_tpu_torch.ops.pool_bwd import max_pool_bwd
    return (gather_minibatch, conv_wgrad, max_pool_bwd)


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONFAULTHANDLER="1")
    for name in ("VELES_BACKEND", "VELES_CHAOS"):  # the card unless -d cpu
        env.pop(name, None)
    return env


def _cpu_args(device):
    return ["-d", "cpu"] if device.backend == "cpu" else []


def _has(module):
    try:
        __import__(module)
    except ImportError:
        return False
    return True


def _card(device):
    if device.backend != "cuda":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(device.torch_device)


def _plot_data(plot):
    """A plotter's captured data as plain lists."""
    name = type(plot).__name__
    if name == "EpochCurve":
        return plot.values
    if name == "MatrixPlotter":
        return plot.matrix.tolist()
    return [(c.tolist(), e.tolist()) for c, e in plot.hists]


class Subscriber(object):
    """A ZMQ SUB socket on a thread, keeping every plot it receives."""

    def __init__(self, endpoint):
        import zmq
        self.socket = zmq.Context.instance().socket(zmq.SUB)
        self.socket.connect(endpoint)
        self.socket.setsockopt(zmq.SUBSCRIBE, b"")
        self.received = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="plot-subscriber")
        self._thread.start()

    def _loop(self):
        from veles_tpu_torch import plotter
        while not self._stop.is_set():
            if self.socket.poll(100):
                self.received.append(plotter.loads(self.socket.recv()))

    def drain(self, count, timeout=30):
        """Wait for ``count`` plots, then stop."""
        deadline = time.time() + timeout
        while len(self.received) < count and time.time() < deadline:
            time.sleep(0.05)
        self._stop.set()
        self._thread.join(timeout=10)
        self.socket.close(0)
        return self.received


# -- the legs -----------------------------------------------------------------


def train_with_plotters(device, directory, epochs, state):
    """(a): digits_conv trained here with the standard plotters linked
    and a graphics server on its launcher."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.graphics_server import GraphicsServer
    from veles_tpu_torch.launcher import Launcher
    module = workflow_module()  # its import sets digits_conv's defaults
    root.digits_conv.max_epochs = epochs
    # a standalone session whatever an earlier in-process run of the
    # command line left in the config (``-l``, ``--trace``, ...)
    launcher = Launcher(master_address="", listen_address="",
                        web_status="", trace="", metrics_interval=0,
                        metrics_path="", profile="", alerts=False)
    sw = module.build(launcher)
    if device.backend == "cpu":
        sw.fuse(pipeline=True)  # the card's default, asked for here
    plots = sw.link_plotters()
    server = GraphicsServer(launcher)
    sub = Subscriber(server.endpoints["tcp"])
    time.sleep(0.5)  # the subscriber joins before the first plot
    epoch_metrics = []
    on_epoch_ended = sw.decision._on_epoch_ended

    def record():
        epoch_metrics.append(list(sw.decision.epoch_metrics))
        on_epoch_ended()
    sw.decision._on_epoch_ended = record
    counters = services_counters()
    try:
        _sync()
        for wrapper in counters:
            wrapper.launches = 0
        start = time.perf_counter()
        launcher.initialize(device=device)
        launcher.run()
        _sync()
        train_s = time.perf_counter() - start
        launches = {w.__name__: w.launches for w in counters}
        received = sub.drain(server.published)
    finally:
        if not sub._stop.is_set():
            sub.drain(0, timeout=0)
        server.shutdown()
    del sw.decision._on_epoch_ended
    trainer = sw.fused_trainer
    loader = sw.loader
    n_valid = int(loader.class_lengths[1])
    weights = [fwd.weights.mem.size for fwd in sw.forwards
               if fwd.weights]
    valid_curve, train_curve, conf, hist = plots
    out = {"epochs": len(epoch_metrics) - 1, "train_s": train_s,
           "train_steps": trainer.iteration,
           "serves": trainer.prefetcher.stats["serves"],
           "published": server.published, "received": len(received),
           "validation_curve": valid_curve.values,
           "train_curve": train_curve.values,
           "confusion_sum": int(conf.matrix.sum()),
           "validation_count": n_valid,
           "histogram_counts": [int(c.sum()) for c, _ in hist.hists],
           "weights": weights, "launches": launches,
           "captures": (trainer.compile_receipt or {}).get("captures", 0)}
    last = {type(p).__name__ + str(i): _plot_data(p)
            for i, p in enumerate(received[-len(plots):])}
    live = {type(p).__name__ + str(i): _plot_data(p)
            for i, p in enumerate(plots)}
    out["received_equal_live"] = last == live
    png_dir = None
    if _has("matplotlib"):
        from veles_tpu_torch.graphics_client import render_plot
        png_dir = os.path.join(directory, "png")
        os.makedirs(png_dir)
        out["png_bytes"] = {type(p).__name__: os.path.getsize(
            render_plot(p, png_dir)) for p in plots}
    else:
        out["png"] = "not rendered: matplotlib is not installed"
    state.update(sw=sw, launcher=launcher, png_dir=png_dir)
    steps = trainer.iteration
    if (out["epochs"] != epochs or
            valid_curve.values != [float(m[1]) for m in epoch_metrics] or
            train_curve.values != [float(m[2]) for m in epoch_metrics
                                   if m[2] is not None] or
            out["confusion_sum"] != n_valid or
            out["histogram_counts"] != weights or
            len(received) != server.published or
            server.published != 4 * len(epoch_metrics) or
            not out["received_equal_live"] or
            (device.backend == "cuda" and
             (launches["conv_wgrad"] != 2 * steps or
              launches["max_pool_bwd"] != 2 * steps or
              launches["gather_minibatch"] != out["serves"] or
              launches["gather_minibatch"] < steps or
              out["captures"] < 1))):
        raise AssertionError("services (a): %s" % json.dumps(out))
    return out, launches


def publish(device, directory, state):
    """(b): the reports of (a)'s workflow."""
    from veles_tpu_torch.publishing import (HTMLBackend, MarkdownBackend,
                                            PDFBackend, Publisher)
    sw = state["sw"]
    backends = [MarkdownBackend(directory), HTMLBackend(directory)]
    if _has("matplotlib"):
        backends.append(PDFBackend(directory))
    pub = Publisher(sw, backends=backends, plots_dir=state["png_dir"])
    pub.run()
    info = pub.gather_info()
    with open(os.path.join(directory, "report.md")) as fin:
        md = fin.read()
    rows = [line for line in md.splitlines() if line.startswith("| ")
            and line.count("|") == 4 and line != "| unit | runs | seconds |"]
    out = {"reports": [os.path.basename(p) for p in pub.reports],
           "metrics": info["metrics"], "unit_rows": len(rows),
           "units": len(info["units"]), "bytes": {
               os.path.basename(p): os.path.getsize(p)
               for p in pub.reports}}
    if not _has("matplotlib"):
        out["pdf"] = "not written: matplotlib is not installed"
    decision = sw.decision
    names = {u["name"] for u in info["units"]}
    if (info["metrics"]["validation"] != decision.epoch_metrics[1] or
            info["metrics"]["train"] != decision.epoch_metrics[2] or
            info["metrics"]["best"] != decision.best_metric or
            len(rows) != len(info["units"]) or
            any("| %s |" % name not in md for name in names)):
        raise AssertionError("services (b): %s" % json.dumps(out))
    return out


def _percentiles(times_ms):
    import numpy
    return {"n": len(times_ms),
            "p50": float(numpy.percentile(times_ms, 50)),
            "p99": float(numpy.percentile(times_ms, 99)),
            "max": float(numpy.max(times_ms))}


def rest(device, directory, state):
    """(c): the trained workflow served over HTTP."""
    import numpy
    from veles_tpu_torch.restful_api import RESTfulAPI
    sw = state["sw"]
    loader = sw.loader
    first, end = (int(loader.class_end_offsets[0]),
                  int(loader.class_end_offsets[1]))
    loader.original_data.map_read()
    x = numpy.ascontiguousarray(loader.original_data.mem[first:end],
                                numpy.float32)
    labels = [loader.original_labels[i] for i in range(first, end)]
    api = RESTfulAPI(sw)
    api.initialize()
    api.start_background()
    answers, latencies, errors = [None] * len(x), [], []
    lock = threading.Lock()

    def client(k):
        for i in range(k, len(x), REST_CLIENTS):
            req = urllib.request.Request(
                "http://127.0.0.1:%d/api" % api.port,
                data=json.dumps({"input": x[i].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            start = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    answer = json.loads(resp.read())
            except Exception as exc:
                errors.append(repr(exc))
                continue
            with lock:
                latencies.append((time.perf_counter() - start) * 1e3)
            answers[i] = answer
    try:
        start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(REST_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - start
        served = api.requests_served
        engine = api.engine
        rungs = {1: 0, 8: 0}
        mismatched = []
        for i, answer in enumerate(answers):
            if answer is None:
                continue
            got = numpy.array(answer["probabilities"][0], numpy.float32)
            alone = engine.infer(x[i:i + 1])[0]
            block = numpy.zeros((8,) + engine.sample_shape, numpy.float32)
            block[0] = x[i]
            batched = engine.run_host(block, 8)[0].cpu().numpy()
            if got.tobytes() == alone.tobytes():
                rungs[1] += 1
            elif got.tobytes() == batched.tobytes():
                rungs[8] += 1
            else:
                mismatched.append(i)
        state["engine"] = engine
    finally:
        api.stop()
    results = [a["result"] if a else None for a in answers]
    argmax_ok = all(a is not None and a["result"] == int(numpy.argmax(
        a["probabilities"][0])) for a in answers)
    wrong = sum(r != label for r, label in zip(results, labels))
    own = int(round(sw.decision.epoch_metrics[1] * len(x) / 100.0))
    out = {"requests": len(x), "clients": REST_CLIENTS, "wall_s": wall,
           "served": served, "errors": errors[:5],
           "latency_ms": _percentiles(latencies),
           "bit_equal_at_rung": rungs, "mismatched": mismatched[:10],
           "label_errors": wrong, "workflow_errors": own}
    if (errors or served != len(x) or mismatched or not argmax_ok or
            abs(wrong - own) > 1):
        raise AssertionError("services (c): %s" % json.dumps(out))
    return out


def _forge_cli(args, timeout=120):
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.forge"] + list(args),
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError("forge %s: rc %d\n%s" % (
            args[0], proc.returncode, proc.stderr[-3000:]))
    return proc.stdout


def _cpu_name():
    try:
        with open("/proc/cpuinfo") as fin:
            for line in fin:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform
    return platform.processor() or "unknown"


def forge_native(device, directory, state):
    """(d): export, forge upload and fetch, the native runtime."""
    import numpy
    from veles_tpu_torch import native
    from veles_tpu_torch.forge import ForgeServer
    sw = state["sw"]
    pkg = os.path.join(directory, "digits_conv.veles.tar")
    sw.package_export(pkg)
    git = shutil.which("git") is not None
    server = ForgeServer(os.path.join(directory, "hub"), git_backed=git)
    server.start_background()
    url = "http://127.0.0.1:%d" % server.port
    fetched = os.path.join(directory, "fetched.tar")
    try:
        uploaded = _forge_cli(["upload", url, "digits_conv", "1.0.0", pkg,
                               "--metadata",
                               json.dumps({"workflow": "digits_conv"})])
        listed = _forge_cli(["list", url])
        got = _forge_cli(["fetch", url, "digits_conv", fetched])
    finally:
        server.stop()
    with open(pkg, "rb") as a, open(fetched, "rb") as b:
        same_bytes = a.read() == b.read()
    start = time.perf_counter()
    built = os.path.exists(native._lib_path()[1])
    native.build_native()
    build_s = time.perf_counter() - start
    nwf = native.NativeWorkflow(fetched)
    loader = sw.loader
    first = int(loader.class_end_offsets[0])
    x = numpy.ascontiguousarray(
        loader.original_data.mem[first:first + NATIVE_BATCH], numpy.float32)
    host = nwf.run(x)
    card = state["engine"].infer(x)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        nwf.run(x)
        times.append((time.perf_counter() - t0) * 1e3)
    diff = float(numpy.abs(host - card).max())
    close = bool(numpy.allclose(host, card, rtol=NATIVE_RTOL,
                                atol=NATIVE_ATOL))
    labels_equal = bool((host.argmax(1) == card.argmax(1)).all())
    out = {"storage": "git" if git else "plain",
           "package_bytes": os.path.getsize(pkg),
           "uploaded": uploaded.strip(), "listed": listed.strip(),
           "fetched": got.strip(), "same_bytes": same_bytes,
           "native_build_s": build_s, "native_build_cached": built,
           "units": nwf.unit_count, "arena_bytes": nwf.arena_size(
               NATIVE_BATCH), "max_abs_diff": diff,
           "rtol": NATIVE_RTOL, "atol": NATIVE_ATOL,
           "labels_equal": labels_equal,
           "host_ms_batch_64": sorted(times)[len(times) // 2],
           "host_cpu": _cpu_name(), "host_cores": os.cpu_count()}
    if not (same_bytes and close and labels_equal and
            "uploaded digits_conv==1.0.0" in uploaded and
            "fetched digits_conv==1.0.0" in got):
        raise AssertionError("services (d): %s" % json.dumps(out))
    return out


def _wait_json(path, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            try:
                with open(path) as fin:
                    return json.load(fin)
            except ValueError:
                pass  # still being written
        time.sleep(0.2)
    return None


def _run_args(device, result_file):
    return [WORKFLOW, "-", "--result-file", result_file,
            "root.digits_conv.max_epochs=%d" % CHILD_EPOCHS] + \
        _cpu_args(device)


def composer(device, directory, state):
    """(e): the web composer in a child process starts a training."""
    out_path = os.path.join(directory, "frontend.out")
    with open(out_path, "w") as stdout:
        proc = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "--frontend", "0"],
            stdout=stdout, stderr=subprocess.STDOUT, env=_env(), cwd=ROOT)
    try:
        deadline = time.time() + 120
        base = None
        while base is None and time.time() < deadline:
            with open(out_path) as fin:
                for line in fin:
                    if line.startswith("composer on "):
                        base = line.split()[2].rstrip("/")
            time.sleep(0.1)
        if base is None:
            raise AssertionError("services (e): no composer line")
        with urllib.request.urlopen(base + "/", timeout=30) as resp:
            page = resp.read().decode()
        token = page.split('TOKEN = "')[1].split('"')[0]
        flags = ["--web-status", "--snapshot-dir", "--background",
                 "--ensemble-train", "--result-file", "--device"]
        listed = {flag: flag in page for flag in flags}

        def post(argv, tok):
            req = urllib.request.Request(
                base + "/run", data=json.dumps(
                    {"argv": argv, "token": tok}).encode())
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        no_token = post(["-m", "veles_tpu_torch", "--help"], "x")
        jax = post(["-m", "veles_tpu", "--help"], token)
        result_file = os.path.join(directory, "composed.json")
        start = time.perf_counter()
        started = post(["-m", "veles_tpu_torch"] +
                       _run_args(device, result_file), token)
        status = None
        while time.perf_counter() - start < 300:
            with urllib.request.urlopen(base + "/status",
                                        timeout=30) as resp:
                status = json.loads(resp.read())
            if not status["running"]:
                break
            time.sleep(0.2)
        seconds = time.perf_counter() - start
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    result = _wait_json(result_file, 10)
    out = {"flags_listed": listed, "refused_without_token":
           "error" in no_token, "refused_jax": "error" in jax,
           "started": "pid" in started, "status": status,
           "seconds_to_result": seconds, "result": result,
           "frontend_rc": proc.returncode}
    if not (all(listed.values()) and out["refused_without_token"] and
            out["refused_jax"] and out["started"] and status and
            status["returncode"] == 0 and result and
            result["Device"] == _card(device) and
            result["Total epochs"] == CHILD_EPOCHS and
            proc.returncode == 0):
        with open(out_path) as fin:
            tail = fin.read()[-3000:]
        raise AssertionError("services (e): %s\n%s" % (json.dumps(out),
                                                        tail))
    return out


def daemon(device, directory, state):
    """(f): ``-b``: the parent leaves at once, the daemon trains."""
    log_file = os.path.join(directory, "daemon.log")
    result_file = os.path.join(directory, "daemon.json")
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "-b", "--log-file",
         log_file] + _run_args(device, result_file), capture_output=True,
        text=True, timeout=120, env=_env(), cwd=ROOT)
    parent_s = time.perf_counter() - start
    result = _wait_json(result_file, DAEMON_LIMIT_S)
    seconds = time.perf_counter() - start
    pid = (result or {}).get("Pid")
    if pid:
        # the daemon ends after its result file; make sure it did
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                os.kill(pid, 0)
            except OSError:
                break
            time.sleep(0.2)
        else:
            os.kill(pid, signal.SIGKILL)
    with open(log_file) as fin:
        text = fin.read()
    card = _card(device)
    out = {"parent_rc": proc.returncode, "parent_s": parent_s,
           "seconds_to_result": seconds, "result": result,
           "log_names_card": ("workflow on %s" % card) in text}
    if not (proc.returncode == 0 and result and
            result["Device"] == card and
            result["Total epochs"] == CHILD_EPOCHS and
            out["log_names_card"] and seconds <= DAEMON_LIMIT_S):
        raise AssertionError("services (f): %s\n%s" % (json.dumps(out),
                                                        text[-3000:]))
    return out


def services_phase(device, directory, epochs=EPOCHS):
    """The services phase.  Returns ({kernel: launches}, summary): (a)'s
    launches, counted from 0 around the training."""
    import faulthandler
    seconds, summary, state = {}, {}, {}
    launches = {}
    faulthandler.dump_traceback_later(PHASE_LIMIT_S, exit=True)

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        leg_dir = os.path.join(directory, name)
        os.makedirs(leg_dir)
        result = fn(device, leg_dir, *args)
        seconds[name] = time.perf_counter() - t0
        if isinstance(result, tuple):
            result, counted = result
            launches.update(counted)
        summary[name] = result
        log("services %s: %s" % (name, json.dumps(result)))
        return result

    try:
        leg("plots", train_with_plotters, epochs, state)
        leg("publish", publish, state)
        leg("rest", rest, state)
        leg("forge", forge_native, state)
        leg("composer", composer, state)
        leg("daemon", daemon, state)
    finally:
        faulthandler.cancel_dump_traceback_later()
        launcher = state.get("launcher")
        if launcher is not None:
            launcher.workflow.stop()
    summary["packages"] = {
        "zmq": _version("zmq"), "matplotlib": _version("matplotlib"),
        "cmake": shutil.which("cmake"), "git": shutil.which("git"),
        "g++": shutil.which("g++")}
    summary["seconds"] = seconds
    summary["launches"] = launches
    return launches, summary


def _version(name):
    try:
        module = __import__(name)
    except ImportError:
        return None
    return getattr(module, "__version__", "?")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None,
                        help="also write the summary to this file")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import common
    device = Device(args.device)
    directory = tempfile.mkdtemp(prefix="services_phase_")
    os.environ["VELES_SCHEDULE_CACHE"] = os.path.join(directory, "cache")
    # a failure's flight dump goes beside it, not into the working
    # directory
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
        start = time.perf_counter()
        _, phase = services_phase(device, os.path.join(directory, "legs"),
                                  epochs=args.epochs)
        summary.update(phase)
        summary["phase_s"] = time.perf_counter() - start
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    text = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fout:
            fout.write(text)
    print("services: " + text, flush=True)


if __name__ == "__main__":
    main()
