"""Device kernel launches in the traced window, counted in the trace, per
window of the driver's engine (``counts["windows"]``): the dispatch work
that a fusion or a CUDA graph removes. One file for every suffix
(``.tokens``, ``.samples``): the suffix names the end-to-end metric the
count moves."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels_in_window()) / ctx.done["windows"]
