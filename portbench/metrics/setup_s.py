"""Process start to the window's start, host clock: imports, the kernels'
libraries loaded (built on a checkout's first run), the trainer and engine
built, weights and traffic made, and the checked first windows, which
warm up every shape the window uses."""


def read(ctx):
    return ctx.setup_s
