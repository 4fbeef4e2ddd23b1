"""The port's thread pool (veles_tpu_torch/thread_pool.py) against the
JAX package's (veles_tpu/thread_pool.py) on the same tasks, and the
SIGINT escalation through the command line.

- callbacks, ``errback`` failure routing, ``pause`` / ``resume``,
  ``wait_idle``, shutdown callbacks and idempotent shutdown, ``reset``
  and ``threadsafe`` give the same outcomes in both packages;
- the escalating handler, in a fresh process each: the first SIGINT
  calls ``sigint_hook`` (once), the second shuts the pools down and
  raises ``KeyboardInterrupt``;
- one SIGINT to a ``-d cpu`` command-line run (fused, with the input
  pipeline) stops it gracefully: the port exits with the JAX package's
  code and writes its result file, as the JAX run does; a second SIGINT
  while a unit is still busy forces the exit in both, without a result
  file.  (The JAX package installs its handler with the first thread
  pool, the input pipeline's; the port's launcher installs it for every
  run.)
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import veles_tpu.thread_pool as jax_pool
import veles_tpu_torch.thread_pool as torch_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcomes(mod):
    """Run the same task script on ``mod``'s pool; returns what was
    observed."""
    pool = mod.ThreadPool(minthreads=1, maxthreads=4, name="tp-test")
    seen = {}
    try:
        results = []
        lock = threading.Lock()

        def task(i):
            with lock:
                results.append(i * i)
            return i * i

        futures = [pool.callInThread(task, i) for i in range(8)]
        seen["idle"] = pool.wait_idle(10)
        seen["results"] = sorted(results)
        seen["returns"] = [f.result(10) for f in futures]

        def boom(tag):
            raise ValueError(tag)

        pool.callInThread(boom, "first")
        pool.wait_idle(10)
        pool.callInThread(boom, "second")
        pool.wait_idle(10)
        seen["failure"] = (pool.failure[0].__name__,
                           str(pool.failure[1]))

        pool.pause()
        seen["paused"] = pool.paused
        ran = threading.Event()
        pool.callInThread(ran.set)
        seen["ran_while_paused"] = ran.wait(0.3)
        seen["idle_while_paused"] = pool.wait_idle(0.1)
        pool.resume()
        seen["ran_after_resume"] = ran.wait(10)
        seen["idle_after_resume"] = pool.wait_idle(10)

        calls = []
        pool.register_on_shutdown(lambda: calls.append("cb"))
        pool.register_on_shutdown(lambda: 1 / 0)  # logged, not raised
        pool.register_on_shutdown(lambda: calls.append("after"))
        pool.shutdown()
        pool.shutdown()
        seen["callbacks"] = calls
        seen["after_shutdown"] = pool.callInThread(task, 1)
        seen["unregistered"] = pool not in mod.ThreadPool.pools

        others = [mod.ThreadPool(maxthreads=1, name="tp-reset")
                  for _ in range(2)]
        mod.ThreadPool.reset()
        seen["reset"] = [o._shutting_down for o in others] + [
            any(o in mod.ThreadPool.pools for o in others)]

        class Counter(object):
            value = 0

            @mod.threadsafe
            def bump(self):
                value = self.value
                time.sleep(0.0005)
                self.value = value + 1

        counter = Counter()
        threads = [threading.Thread(
            target=lambda: [counter.bump() for _ in range(20)])
            for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        seen["threadsafe"] = counter.value
    finally:
        pool.shutdown()
    return seen


def test_pool_outcomes_match_jax():
    want = _outcomes(jax_pool)
    got = _outcomes(torch_pool)
    assert got == want
    assert got["results"] == [i * i for i in range(8)]
    assert got["failure"] == ("ValueError", "first")
    assert not got["ran_while_paused"] and got["ran_after_resume"]
    assert got["callbacks"] == ["cb", "after"]
    assert got["after_shutdown"] is None
    assert got["threadsafe"] == 80


_ESCALATION = textwrap.dedent("""
    import os, signal, sys
    from {pkg}.thread_pool import ThreadPool
    pool = ThreadPool(maxthreads=1, name="esc")
    hooks = []
    ThreadPool.sigint_hook = lambda: hooks.append(1)
    os.kill(os.getpid(), signal.SIGINT)
    print("after first", len(hooks), ThreadPool.sigint_hook is None,
          pool._shutting_down, flush=True)
    try:
        os.kill(os.getpid(), signal.SIGINT)
        print("no interrupt", flush=True)
    except KeyboardInterrupt:
        print("interrupted", len(hooks), pool._shutting_down, flush=True)
""")


@pytest.mark.parametrize("pkg", ["veles_tpu", "veles_tpu_torch"])
def test_sigint_escalation(pkg):
    """First ^C: the hook, once; second: shutdown + KeyboardInterrupt."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _ESCALATION.format(pkg=pkg)],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines() == [
        "after first 1 True False", "interrupted 1 True"], proc.stdout


_WF = textwrap.dedent('''
    import os
    import time

    import numpy
    from {pkg}.config import root
    from {pkg}.loader.fullbatch import FullBatchLoader
    from {pkg}.models.nn_workflow import StandardWorkflow
    from {pkg}.prng import RandomGenerator


    class SlowBlobs(FullBatchLoader):
        """Blobs; a minibatch served while the file ``BUSY`` exists
        holds the run for 60 s (a unit still busy at a ^C)."""

        def load_data(self):
            self.class_lengths[:] = [0, 32, 96]
            self._calc_class_end_offsets()
            self.create_originals((8,))
            rng = numpy.random.RandomState(1)
            centers = rng.randn(3, 8) * 2
            for i in range(self.total_samples):
                label = i % 3
                self.original_data.mem[i] = (
                    centers[label] + rng.randn(8) * 0.2)
                self.original_labels[i] = label

        def run(self):
            if os.path.exists("BUSY"):
                time.sleep(60)
            time.sleep(0.002)
            super(SlowBlobs, self).run()


    def build(launcher):
        return StandardWorkflow(
            launcher,
            layers=[{{"type": "softmax", "output_sample_shape": 3,
                      "learning_rate": 0.05}}],
            loader_factory=lambda w: SlowBlobs(
                w, minibatch_size=32, prng=RandomGenerator("sig", seed=4)),
            decision_config=dict(max_epochs=100000, fail_iterations=100000),
            result_file=root.common.get("result_file"))


    def run(load, main):
        workflow, _ = load(build)
        # fused with the input pipeline: the JAX package installs its
        # SIGINT handler with the pipeline's thread pool
        workflow.fuse(pipeline=True)
        main()
''')


def _start(pkg, directory):
    os.makedirs(directory)
    wf = os.path.join(directory, "sig_workflow.py")
    with open(wf, "w") as fout:
        fout.write(_WF.format(pkg=pkg))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("VELES_BACKEND", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", pkg, wf, "-", "-d", "cpu", "--result-file",
         os.path.join(directory, "result.json")],
        cwd=directory, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    lines = []

    def read():
        for line in proc.stderr:
            lines.append(line)
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, lines, reader


def _wait_for_epochs(runs, n=3, timeout=120):
    deadline = time.time() + timeout
    for proc, lines, _ in runs:
        while sum("Epoch" in line for line in lines) < n:
            assert proc.poll() is None, "".join(lines)[-3000:]
            assert time.time() < deadline, "".join(lines)[-3000:]
            time.sleep(0.05)


def _finish(run, timeout=60):
    proc, lines, reader = run
    proc.wait(timeout=timeout)
    reader.join(timeout=10)
    return proc.returncode, "".join(lines)


def test_cli_sigint_graceful_then_forced(tmp_path):
    """One ^C: a graceful stop, exit 0 and the result file, in both
    packages.  Two ^C while a unit is busy: the second forces the exit,
    with the same code in both and no result file."""
    graceful = {pkg: _start(pkg, str(tmp_path / ("graceful_" + pkg)))
                for pkg in ("veles_tpu", "veles_tpu_torch")}
    forced = {pkg: _start(pkg, str(tmp_path / ("forced_" + pkg)))
              for pkg in ("veles_tpu", "veles_tpu_torch")}
    try:
        _wait_for_epochs(list(graceful.values()) + list(forced.values()))
        for pkg, run in graceful.items():
            run[0].send_signal(signal.SIGINT)
        for pkg, run in forced.items():
            open(str(tmp_path / ("forced_" + pkg) / "BUSY"), "w").close()
        time.sleep(1.0)  # each forced run is inside its 60 s minibatch
        for run in forced.values():
            run[0].send_signal(signal.SIGINT)
        time.sleep(0.5)
        started = time.time()
        for run in forced.values():
            run[0].send_signal(signal.SIGINT)
        codes = {}
        for kind, runs in (("graceful", graceful), ("forced", forced)):
            for pkg, run in runs.items():
                codes[kind, pkg] = _finish(run)
        assert time.time() - started < 30, "the second ^C did not force"
    finally:
        for run in list(graceful.values()) + list(forced.values()):
            if run[0].poll() is None:
                run[0].kill()
                run[0].wait()
    for pkg in ("veles_tpu", "veles_tpu_torch"):
        code, err = codes["graceful", pkg]
        assert code == 0, (pkg, err[-3000:])
        with open(str(tmp_path / ("graceful_" + pkg) / "result.json")) as f:
            result = json.load(f)
        assert 3 <= result["Total epochs"] < 100000
        assert "graceful stop" in err
        code, err = codes["forced", pkg]
        assert not os.path.exists(
            str(tmp_path / ("forced_" + pkg) / "result.json"))
    assert codes["graceful", "veles_tpu_torch"][0] == \
        codes["graceful", "veles_tpu"][0]
    assert codes["forced", "veles_tpu_torch"][0] == \
        codes["forced", "veles_tpu"][0] != 0
