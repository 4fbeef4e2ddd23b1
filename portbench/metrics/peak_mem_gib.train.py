"""peak_mem_gib.train: the device memory the caching allocator held
at its peak over the window (``torch.cuda.max_memory_reserved()``,
the peak statistics reset at the window's start), in GiB.  Reserved,
not allocated: the captured step's activations live in its graph's
private pool, which counts as reserved between replays."""


def read(ctx):
    if ctx.kind != "train" or not ctx.peak_window_bytes:
        return None
    return ctx.peak_window_bytes / 2.0 ** 30
