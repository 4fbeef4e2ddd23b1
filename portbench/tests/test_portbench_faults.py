"""Whole runs of tiny cells on the CPU with the look for a card skipped:
a sound run is correct, and each fault the cell can have, planted in
the program underneath the timed path, makes ``correct`` false."""

import time

import numpy
import pytest
import torch

from portbench.bench import Bench
from portbench.harness import run_cell

SEED = 7000000001


def run(root, workload, trace=0, seconds=0.4):
    return run_cell(Bench(root), workload, SEED, seconds, trace, "cpu",
                    time.perf_counter())


def check_rows(result):
    return {name: (value, limit) for name, value, limit in
            result["checks"]}


@pytest.mark.parametrize("workload", ["tiny.train", "tiny.serve_f32",
                                      "tiny.serve_int8"])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct_and_its_last_line_has_the_keys(
        tiny_root, workload, trace):
    result, numbers = run(tiny_root, workload, trace)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = Bench(tiny_root)
    listed = bench.per_layer(workload) if trace else \
        bench.end_to_end(workload)
    assert set(result["metrics"]) <= {m["name"] for m in listed}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in listed}
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    if trace:
        assert "busy_s" in result["device"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny_root,
                                                          monkeypatch):
    from veles_tpu_torch import compiler

    def unchanged(plans, hypers, state, grads):
        return [dict(s) for s in state]
    monkeypatch.setattr(compiler, "_apply_solver", unchanged)
    result, numbers = run(tiny_root, "tiny.train")
    assert not result["correct"]
    assert numbers["change_gap"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(tiny_root, monkeypatch):
    from veles_tpu_torch import compiler
    real = compiler._loss

    def half(loss, out, target, batch_size, row_offset=0):
        n = out.shape[0] // 2
        return real(loss, out[:n], target[:n], batch_size / 2.0,
                    row_offset)
    monkeypatch.setattr(compiler, "_loss", half)
    result, numbers = run(tiny_root, "tiny.train")
    assert not result["correct"]
    assert max(numbers["grad_gap"], numbers["change_gap"]) > 0.01


def test_the_wrong_dropout_masks_are_caught(tiny_root, monkeypatch):
    from veles_tpu_torch import threefry
    real = threefry.fold_in
    monkeypatch.setattr(threefry, "fold_in",
                        lambda k, data: real(k, data + 1))
    result, _ = run(tiny_root, "tiny.train")
    assert not result["correct"]


@pytest.mark.parametrize("workload", ["tiny.serve_f32", "tiny.serve_int8"])
def test_an_answer_altered_where_it_is_produced_is_caught(
        tiny_root, workload, monkeypatch):
    from veles_tpu_torch.serve.engine import AOTEngine
    real = AOTEngine.run_host

    def altered(self, batch, rung):
        out = real(self, batch, rung)
        return torch.roll(out, 1, dims=-1)
    monkeypatch.setattr(AOTEngine, "run_host", altered)
    result, numbers = run(tiny_root, workload)
    assert not result["correct"]
    assert numbers["logp_gap"] > 0.01


def test_a_request_never_answered_is_caught(tiny_root, monkeypatch):
    from veles_tpu_torch.serve.batcher import ContinuousBatcher
    real = ContinuousBatcher.submit
    count = {"n": 0}

    def drop_one(self, sample, slo_class=None, trace=None):
        req = real(self, sample, slo_class, trace)
        count["n"] += 1
        if count["n"] == 20:  # inside the window, after the warm-up
            req.cancelled = True
        return req
    monkeypatch.setattr(ContinuousBatcher, "submit", drop_one)
    monkeypatch.setattr("portbench.serve.GRACE_S", 1.0)
    result, _ = run(tiny_root, "tiny.serve_f32")
    assert not result["correct"]
    assert result["failed"] >= 1
    assert numpy.isfinite(result["metrics"]["serve_p95_ms"]["value"])
