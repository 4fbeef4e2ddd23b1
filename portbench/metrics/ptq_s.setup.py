"""ptq_s.setup: the seconds of the program's post-training quantization
in set-up: the calibration forward, the host percentiles and the
weights' rounding (the registry's ``quant.ptq_seconds``)."""


def read(ctx):
    from veles_tpu_torch.observe.metrics import registry
    counter = registry.peek("quant.ptq_seconds")
    return None if counter is None else float(counter.value)
