"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, in GB (1e9 bytes)."""


def read(ctx):
    return None if ctx.window_peak_bytes is None \
        else ctx.window_peak_bytes / 1e9
