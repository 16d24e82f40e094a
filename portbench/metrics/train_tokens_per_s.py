"""Every token trained in the window, summed over workers, over the
window's host time, which ends in a synchronise."""


def read(ctx):
    return ctx.done["tokens"] / ctx.window_s
