"""capture_s.setup: the seconds the program's CUDA-graph captures took
in set-up, their warm-ups included and a kernel library's load that
fell inside one left out (the registry's ``compile.capture_seconds``,
read after the window, which captures nothing)."""


def read(ctx):
    from veles_tpu_torch.observe.metrics import registry
    counter = registry.peek("compile.capture_seconds")
    return None if counter is None else float(counter.value)
