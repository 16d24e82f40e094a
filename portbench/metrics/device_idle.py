"""The share of the traced window in which no kernel, copy or memset ran
on the device, in %. One file for every suffix (``.tokens``,
``.samples``): the suffix names the end-to-end metric the share moves."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
