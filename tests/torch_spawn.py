"""Spawned gloo worlds for the port's parallel tests.

``spawn(fn, world, tmp_path, *args)`` starts ``world`` processes (the
``spawn`` start method), each of which joins a gloo process group by a
file store under ``tmp_path`` (no fixed port, so tests on several xdist
workers never collide), runs ``fn(rank, world, *args)`` with one
intra-op thread, and sends back its result.  The parent waits at most
``timeout`` seconds for the whole world, then kills every process and
fails the test.  A rank's exception comes back as its traceback and
fails the test too.  ``fn`` lives in a module that does not import JAX
(``tests/torch_ranks.py``), so a rank starts in about a second.
"""

import multiprocessing
import os
import queue
import time
import traceback


def _child(fn, rank, world, store, out, args):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world, tmp_path, *args, timeout=120):
    """[result of rank 0, ..., result of rank world - 1]."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(tmp_path), "store_%d_%d" % (
        os.getpid(), time.monotonic_ns()))
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, out,
                                              args), daemon=True)
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    results, failures = {}, []
    try:
        while len(results) + len(failures) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError(
                    "spawned world of %d did not finish in %d s (ranks "
                    "done: %s)" % (world, timeout, sorted(results)))
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    time.sleep(0.5)
                    if out.empty():
                        raise AssertionError(
                            "a rank died with exit code %s" % dead)
                continue
            if ok:
                results[rank] = value
            else:
                failures.append("rank %d:\n%s" % (rank, value))
                # the others may wait on the failed rank forever
                break
        if failures:
            raise AssertionError("\n".join(failures))
    finally:
        for proc in procs:
            proc.join(timeout=max(deadline - time.monotonic(), 0.1)
                      if not failures else 0.1)
            if proc.is_alive():
                proc.kill()
                proc.join(5)
    return [results[r] for r in range(world)]
