"""The port's transformer (veles_tpu_torch/models/transformer.py and the
zoo's ``transformer_layers``) against the JAX package's, on the same
seeded numpy inputs, at B = 3, T = 12, D = 16, 2 heads, MLP hidden 32.

The JAX side runs its attention through the flash kernels in interpret
mode (``PALLAS_BWD_ENV`` = "1", the ``pallas_on`` fixture of
tests/test_torch_train.py) or, with the knob off, through its stock
reference; the port always runs ``flash_attention``, through its plain
versions on the CPU.  Tolerances: forward max-rel 1e-5 (the JAX kernel's
level-0 bf16x3 products against true f32); 3 chained momentum steps with
the loss within 1e-5 rel and every state leaf within max-rel 1e-4, the
limits of tests/test_torch_train.py.  The initial zoo state is bit-equal.
"""

import numpy
import pytest
import torch

from test_torch_train import (CPU, NAN, _max_rel, assert_metrics_close,
                              assert_states_close, assert_states_equal,
                              pallas_on, port_plans,  # noqa: F401
                              run_both)
from veles_tpu_torch.compiler import build_forward, build_train_step
from veles_tpu_torch.convert import params_from_jax, state_from_jax
from veles_tpu_torch.models import transformer
from veles_tpu_torch.models.zoo import (build_plans_and_state,
                                        transformer_layers)

B, T, D, HEADS, HIDDEN, CLASSES = 3, 12, 16, 2, 32, 10
SPEC = (transformer_layers(blocks=2, heads=HEADS, hidden=HIDDEN,
                           classes=CLASSES), (T, D))
#: the layer-by-layer units of the same families
UNITS = ([{"type": "layer_norm", "learning_rate": 0.05,
           "gradient_moment": 0.9},
          {"type": "attention", "heads": HEADS, "learning_rate": 0.05,
           "gradient_moment": 0.9},
          {"type": "transformer", "heads": 4, "learning_rate": 0.05,
           "gradient_moment": 0.9},
          {"type": "softmax", "output_sample_shape": CLASSES,
           "learning_rate": 0.05, "gradient_moment": 0.9}], (T, D))


@pytest.fixture(params=["1", "0"], ids=["flash", "stock"])
def jax_attention(request, monkeypatch):
    """The JAX model's attention: its flash kernels (interpret mode) or
    its stock reference."""
    from veles_tpu.ops import common
    monkeypatch.setattr(common, "PALLAS_BWD_ENV", request.param)
    return request.param


def _tt(*arrays):
    return tuple(torch.from_numpy(numpy.array(a)) for a in arrays)


def _x(seed=0, b=B):
    return numpy.random.RandomState(seed).randn(b, T, D).astype(
        numpy.float32)


def _block_params(seed):
    rng = numpy.random.RandomState(seed)
    w, b = transformer.init_block_params(D, HIDDEN, rng)
    return w, (rng.randn(*b.shape) * 0.1).astype(numpy.float32)


def test_layer_norm_matches_jax():
    from veles_tpu.models.transformer import layer_norm as jax_ln
    rng = numpy.random.RandomState(1)
    x = (rng.randn(B, T, D) * 3 + 1).astype(numpy.float32)
    gamma = rng.randn(D).astype(numpy.float32)
    beta = rng.randn(D).astype(numpy.float32)
    want = numpy.asarray(jax_ln(x, gamma, beta))
    got = transformer.layer_norm(*_tt(x, gamma, beta)).numpy()
    assert _max_rel(got, want) < 1e-6


def test_multi_head_attention_matches_jax(jax_attention):
    from veles_tpu.models.transformer import MultiHeadAttention as JaxMHA
    rng = numpy.random.RandomState(2)
    # the zoo's init scale: randn * 0.3 doubles the projections, and the
    # JAX kernel's bf16x3 error with them, to ~1e-5
    w = (rng.uniform(-1, 1, (D, 4 * D)) / numpy.sqrt(D)).astype(
        numpy.float32)
    b = (rng.randn(4 * D) * 0.1).astype(numpy.float32)
    x = _x(3)
    want = numpy.asarray(JaxMHA.apply({"weights": w, "bias": b}, x,
                                      heads=HEADS))
    tw, tb, tx = _tt(w, b, x)
    got = transformer.MultiHeadAttention.apply(
        {"weights": tw, "bias": tb}, tx, heads=HEADS).numpy()
    assert got.shape == (B, T, D)
    assert _max_rel(got, want) < 1e-5


def test_transformer_block_matches_jax(jax_attention):
    from veles_tpu.models.transformer import transformer_block as jax_block
    w, b = _block_params(4)
    x = _x(5)
    want = numpy.asarray(jax_block(x, w, b, heads=HEADS, hidden=HIDDEN))
    got = transformer.transformer_block(*_tt(x, w, b), heads=HEADS,
                                        hidden=HIDDEN).numpy()
    assert _max_rel(got, want) < 1e-5


def test_block_layout_and_init_match_jax():
    from veles_tpu.models import transformer as jax_tf
    assert transformer.block_param_sizes(D, HIDDEN) == \
        jax_tf.block_param_sizes(D, HIDDEN)
    got = transformer.init_block_params(D, HIDDEN,
                                        numpy.random.RandomState(6))
    want = jax_tf.init_block_params(D, HIDDEN, numpy.random.RandomState(6))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and numpy.array_equal(g, w)
    wp, bp = transformer.split_block_params(*_tt(*got), D, HIDDEN)
    jwp, jbp = jax_tf.split_block_params(*want, D, HIDDEN)
    for ours, theirs in ((wp, jwp), (bp, jbp)):
        assert sorted(ours) == sorted(theirs)
        for name in theirs:
            assert numpy.array_equal(ours[name].numpy(),
                                     numpy.asarray(theirs[name]))


@pytest.mark.parametrize("spec", [SPEC, UNITS], ids=["zoo", "units"])
def test_zoo_state_bit_equal_to_jax(spec):
    from veles_tpu.models.zoo import build_plans_and_state as jax_build
    jplans, jstate, jshape = jax_build(*spec, seed=3)
    plans, state, shape = build_plans_and_state(*spec, seed=3)
    assert shape == jshape
    assert [p.forward_cls.MAPPING for p in plans] == \
        [p.forward_cls.MAPPING for p in jplans]
    for plan, jplan in zip(plans, jplans):
        assert plan.static == jplan.static and plan.hyper == jplan.hyper
    for entry, jentry in zip(state, jstate):
        assert sorted(entry) == sorted(jentry)
        for key, leaf in jentry.items():
            if leaf is None:
                assert entry[key] is None
            else:
                assert entry[key].dtype == leaf.dtype
                assert numpy.array_equal(entry[key], leaf), key


def test_full_width_spec_counts():
    """The repo's transformer workload: 2 blocks, 8 heads, hidden 2048
    over (128, 512), a 10-class head: 6,960,138 parameters."""
    plans, state, shape = build_plans_and_state(
        transformer_layers(blocks=2, heads=8, hidden=2048), (128, 512))
    assert shape == (10,)
    sizes = [sum(e[k].size for k in ("weights", "bias")) for e in state]
    assert sizes == [3146752 + 5632] * 2 + [655370]
    assert sum(sizes) == 6960138
    assert plans[0].static == {"heads": 8, "hidden": 2048, "eps": 1e-5}


def test_heads_must_divide_features():
    with pytest.raises(ValueError, match="heads"):
        build_plans_and_state(transformer_layers(heads=3), (T, D))
    with pytest.raises(ValueError, match="heads"):
        build_plans_and_state([{"type": "attention", "heads": 5}], (T, D))


@pytest.mark.parametrize("spec", [SPEC, UNITS], ids=["zoo", "units"])
def test_build_forward_matches_jax(spec, jax_attention):
    from veles_tpu.compiler import build_forward as jax_forward
    from veles_tpu.models.zoo import build_plans_and_state as jax_build
    jplans, jstate, _ = jax_build(*spec, seed=7)
    params = [{"weights": e["weights"], "bias": e["bias"]} for e in jstate]
    x = _x(8, b=5)
    want = numpy.asarray(jax_forward(jplans)(params, x))
    got = build_forward(port_plans(jplans))(params_from_jax(params, CPU),
                                            torch.from_numpy(x)).numpy()
    assert got.shape == (5, CLASSES)
    assert _max_rel(got, want) < 1e-5


def _data(n=3, batch=8, seed=9):
    rng = numpy.random.RandomState(seed)
    return [(rng.randn(batch, T, D).astype(numpy.float32),
             rng.randint(0, CLASSES, batch).astype(numpy.int32))
            for _ in range(n)]


@pytest.mark.parametrize("spec", [SPEC, UNITS], ids=["zoo", "units"])
def test_three_steps_match_jax(spec, pallas_on):
    from veles_tpu.models.zoo import build_plans_and_state as jax_build
    jplans, state, _ = jax_build(*spec, seed=10)
    pm, jm, ps, js = run_both(jplans, state, _data(), (0, 1, 2))
    assert_metrics_close(pm, jm)
    assert_states_close(ps, js)
    assert not numpy.array_equal(ps[0]["weights"], state[0]["weights"])
    assert numpy.abs(ps[1]["accum_bias"]).max() > 0


def test_poisoned_step_leaves_state_bit_identical():
    plans, state, _ = build_plans_and_state(*SPEC, seed=11)
    # functional (donate=False): the test holds states across calls
    step = build_train_step(plans, donate=False)
    data = [_tt(x, t) for x, t in _data(seed=12)]
    s, m = step(state_from_jax(state, CPU), *data[0], 8.0)
    assert int(m["skipped"]) == 0
    got, m = step(s, *data[1], 8.0, grad_poison=numpy.float32(NAN))
    assert not bool(m["finite"]) and int(m["skipped"]) == 1
    assert_states_equal(got, s)
    got, m = step(s, *data[1], 8.0, loss_poison=numpy.float32(NAN))
    assert int(m["skipped"]) == 1
    assert_states_equal(got, s)


def test_epochs_run_the_transformer():
    """The epoch and eval entry points over a (N, T, D) dataset with a
    masked tail: the epoch equals its steps run by hand."""
    from veles_tpu_torch.compiler import build_eval_epoch, build_train_epoch
    plans, state, _ = build_plans_and_state(*SPEC, seed=13)
    rng = numpy.random.RandomState(14)
    data = rng.randn(21, T, D).astype(numpy.float32)
    labels = rng.randint(0, CLASSES, 21).astype(numpy.int32)
    order = rng.permutation(21).astype(numpy.int32)
    got, totals = build_train_epoch(plans, 8)(
        state_from_jax(state, CPU), *_tt(data, labels, order))
    step = build_train_step(plans)
    want = state_from_jax(state, CPU)
    for i, n in ((0, 8), (8, 8), (16, 5)):
        idx = order[i:i + 8]
        if len(idx) < 8:
            idx = numpy.concatenate([idx, idx[-1:].repeat(8 - len(idx))])
        y = labels[idx].copy()
        y[n:] = -1
        want, _ = step(want, *_tt(data[idx], y), float(n))
    assert_states_equal(got, want)
    assert int(totals["skipped"]) == 0
    params = [{"weights": e["weights"], "bias": e["bias"]} for e in got]
    evaluated = build_eval_epoch(plans, 8)(params, *_tt(data, labels, order))
    assert int(evaluated["samples"]) == 21
    assert 0 <= int(evaluated["n_err"]) <= 21


def test_engine_and_batcher_serve_the_transformer():
    """AOTEngine over the transformer spec equals build_forward, and
    ContinuousBatcher answers equal engine.infer bit for bit."""
    from veles_tpu_torch.serve import AOTEngine, ContinuousBatcher
    plans, state, _ = build_plans_and_state(*SPEC, seed=15)
    params = [{"weights": e["weights"], "bias": e["bias"]} for e in state]
    engine = AOTEngine(plans, params, (T, D), ladder=(1, 4), device=CPU)
    receipt = engine.compile()
    assert receipt["warmups"] == 2
    x = _x(16, b=4)
    got = engine.infer(x)
    with torch.no_grad():
        want = build_forward(plans)(params_from_jax(params, CPU),
                                    torch.from_numpy(x)).numpy()
    assert got.shape == (4, CLASSES)
    numpy.testing.assert_array_equal(got, want)
    batcher = ContinuousBatcher(engine, max_delay_s=0.05).start()
    try:
        requests = [batcher.submit(row) for row in x]
        for req in requests:
            assert req.done.wait(30) and req.error is None
    finally:
        batcher.stop()
    numpy.testing.assert_array_equal(
        numpy.stack([req.result for req in requests]), got)
