"""The port's serving path (veles_tpu_torch/serve, backends.py) against
the JAX package's AOTEngine, and the batcher's own contracts.

Tolerances: f32 engine rtol 1e-5 (summation order), int8 engine atol
1e-3 on the softmax outputs (a 1-ulp activation difference can move one
quantization level).  Batched equals sequential bit for bit on rungs
>= 8: on the CPU the rung-1 program may take another matrix-vector
kernel and differ by an ulp, as on the JAX side."""

import threading

import numpy
import pytest
import torch

from tests.test_torch_models import CPU, build_both, samples
from tests.torch_observe import port_observe_isolated  # noqa: F401
from veles_tpu_torch.backends import Device
from veles_tpu_torch.serve import (AOTEngine, ContinuousBatcher,
                                   ServeOverload, engine_digest_extra,
                                   model_digest)

pytestmark = pytest.mark.serve


def _engines(name, quantized, ladder=(8, 32)):
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.quant import \
        quantize_model_spec as jax_quantize_model_spec
    from veles_tpu.serve.engine import AOTEngine as JaxAOTEngine
    jplans, plans, params = build_both(name)
    if quantized:
        params, _ = jax_quantize_model_spec(jplans, params,
                                            samples(name, 64, seed=2))
    shape = samples(name, 1).shape[1:]
    jax_engine = JaxAOTEngine(jplans, params, shape, ladder=ladder,
                              device=JaxDevice(backend="cpu"))
    jax_engine.compile()
    engine = AOTEngine(plans, params, shape, ladder=ladder, device=CPU)
    engine.compile()
    return jax_engine, engine


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_f32_engine_matches_jax(name):
    jax_engine, engine = _engines(name, quantized=False)
    assert not engine.quantized
    x = samples(name, 45, seed=4)   # 32 + a 13-row tail padded to 32
    want = jax_engine.infer(x)
    got = engine.infer(x)
    assert got.shape == want.shape
    numpy.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_int8_engine_matches_jax(name):
    jax_engine, engine = _engines(name, quantized=True)
    assert engine.quantized and jax_engine.quantized
    assert engine.compile_receipt["quantized"] is True
    x = samples(name, 20, seed=4)
    numpy.testing.assert_allclose(engine.infer(x), jax_engine.infer(x),
                                  rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def engine():
    _, plans, params = build_both("convnet")
    eng = AOTEngine(plans, params, (16, 16, 1), ladder=(1, 8, 32),
                    device=CPU)
    eng.compile()
    return eng


def test_compile_receipt(engine):
    receipt = engine.compile_receipt
    assert receipt["rungs"] == [1, 8, 32]
    assert receipt["warmups"] == 3
    assert receipt["quantized"] is False
    assert receipt["seconds"] >= 0
    assert engine.rung_for(1) == 1 and engine.rung_for(2) == 8
    assert engine.rung_for(9) == 32 and engine.rung_for(99) == 32


def test_batched_equals_sequential_bit_for_bit(engine):
    """Requests co-batched by the worker (single samples and a block,
    with a padded tail) equal the same rows through engine.infer on the
    8-rung, bit for bit."""
    x = samples("convnet", 13, seed=5)
    sequential = numpy.stack([engine.infer(
        numpy.concatenate([x[i:i + 1]] * 8))[0] for i in range(13)])
    batcher = ContinuousBatcher(engine, max_delay_s=0.5).start()
    try:
        block = batcher.submit_block(x[:4])
        singles = [batcher.submit(x[i]) for i in range(4, 13)]
        for req in [block] + singles:
            assert req.done.wait(10)
            assert req.error is None
    finally:
        batcher.stop()
    got = numpy.concatenate([block.result] +
                            [req.result[None] for req in singles])
    assert batcher.rungs and min(batcher.rungs) >= 8
    assert batcher.stats["padded_rows"] > 0
    assert (got == sequential).all(), numpy.abs(got - sequential).max()


def test_padded_rows_never_leak(engine):
    x = samples("convnet", 5, seed=6)
    zeros = numpy.zeros((8, 16, 16, 1), numpy.float32)
    garbage = numpy.random.RandomState(7).rand(8, 16, 16, 1).astype(
        numpy.float32) * 1e3
    zeros[:5] = x
    garbage[:5] = x
    a = engine.run(CPU.put(zeros), 8)[:5]
    b = engine.run(CPU.put(garbage), 8)[:5]
    assert torch.equal(a, b)


def test_max_queue_sheds_with_retry_after(engine):
    """With the worker held inside a dispatch, submits past max_queue
    raise ServeOverload with a positive retry_after."""
    gate = threading.Event()
    entered = threading.Event()
    run = engine.run

    def held_run(x_dev, rung):
        entered.set()
        gate.wait(10)
        return run(x_dev, rung)

    engine.run = held_run
    batcher = ContinuousBatcher(engine, max_delay_s=0.0,
                                max_queue=2).start()
    try:
        first = batcher.submit(samples("convnet", 1)[0])
        assert entered.wait(10)
        queued = [batcher.submit(samples("convnet", 1)[0])
                  for _ in range(2)]
        with pytest.raises(ServeOverload) as info:
            batcher.submit(samples("convnet", 1)[0])
        assert info.value.retry_after > 0
        assert batcher.stats["shed"] == 1
    finally:
        gate.set()
        del engine.run
        for req in [first] + queued:
            req.done.wait(10)
        batcher.stop()
    assert all(req.error is None for req in [first] + queued)


def test_stopped_batcher_refuses_and_fails_pending(engine):
    batcher = ContinuousBatcher(engine)
    with pytest.raises(ServeOverload):
        batcher.submit(samples("convnet", 1)[0])
    batcher.start()
    assert batcher.infer(samples("convnet", 1)[0]).shape == (10,)
    batcher.stop()
    assert not batcher.running
    with pytest.raises(ServeOverload):
        batcher.infer(samples("convnet", 1)[0])


def test_submit_validates_shapes(engine):
    batcher = ContinuousBatcher(engine).start()
    try:
        with pytest.raises(ValueError):
            batcher.submit(numpy.zeros((16, 16), numpy.float32))
        with pytest.raises(ValueError):
            batcher.submit_block(numpy.zeros((33, 16, 16, 1),
                                             numpy.float32))
    finally:
        batcher.stop()


def test_swap_params_refuses_digest_mismatch(engine):
    from veles_tpu_torch.models import zoo
    from tests.test_torch_models import MODELS
    _, plans, params = build_both("convnet")
    before = engine.infer(samples("convnet", 3))
    # same architecture, new weights: swapped in place
    _, state, _ = zoo.build_plans_and_state(MODELS["convnet"][0],
                                            (16, 16, 1), seed=9)
    new = [{"weights": s["weights"], "bias": s["bias"]} for s in state]
    try:
        assert engine.swap_params(new) == engine.digest
        assert not (engine.infer(samples("convnet", 3)) == before).all()
    finally:
        engine.swap_params(params)
    assert (engine.infer(samples("convnet", 3)) == before).all()
    # a changed shape is another architecture
    bad = [dict(entry) for entry in params]
    bad[2] = {"weights": numpy.zeros((512, 32), numpy.float32),
              "bias": numpy.zeros(32, numpy.float32)}
    with pytest.raises(ValueError):
        engine.swap_params(bad)


def test_model_digest_separates_f32_and_int8():
    from veles_tpu_torch.quant import quantize_model_spec
    _, plans, params = build_both("mlp")
    qparams, _ = quantize_model_spec(plans, params, samples("mlp", 16),
                                     device=CPU)
    extra = engine_digest_extra(numpy.float32)
    f32 = model_digest(plans, params, (784,), extra=extra)
    assert model_digest(plans, qparams, (784,), extra=extra) != f32
    assert model_digest(plans, params, (784,),
                        extra=engine_digest_extra(numpy.float16)) != f32
    _, plans2, params2 = build_both("mlp", seed=3)
    assert model_digest(plans2, params2, (784,), extra=extra) == f32


def test_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Device()
    with pytest.raises(RuntimeError):
        AOTEngine(*build_both("mlp")[1:], (784,))


def test_cpu_device_works_and_pins_f32():
    device = Device(backend="cpu")
    assert device.backend_name == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    src = numpy.arange(6, dtype=numpy.float32).reshape(2, 3)
    put = device.put(src)
    src[:] = -1   # the tensor owns its memory
    assert put.device.type == "cpu"
    assert put.tolist() == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError):
        Device(backend="tpu")


def test_value_digest_matches_jax_and_tracks_values():
    from veles_tpu.serve.engine import value_digest as jax_value_digest
    from veles_tpu_torch.serve import value_digest
    _, _, params = build_both("convnet")
    assert value_digest(params) == jax_value_digest(params)
    ported = [{k: None if v is None else torch.from_numpy(v)
               for k, v in entry.items()} for entry in params]
    assert value_digest(ported) == value_digest(params)
    _, _, other = build_both("convnet", seed=4)
    assert value_digest(other) != value_digest(params)
