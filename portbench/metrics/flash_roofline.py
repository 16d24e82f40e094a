"""K2, K3 and K4 (``ops/flash_attention.py`` → ``csrc/flash_attention*.cu``)
over the traced window: the bound time of the attention the window needs
(each block's forward and backward once a local step, every worker's rows
in one call, ``flops/flash.py``) over the device time of the kernels whose
names start ``fa_``, in %."""

import re

from portbench.flops import flash, peaks

FLASH = re.compile(r"\bfa_\w*kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    spent = sum(b - a for a, b, name, *_ in ctx.trace.kernels_in_window()
                if FLASH.search(name)) / 1e6
    if spent <= 0:
        return None
    kw = ctx.bench.config["kwargs"]
    H, D = int(kw["heads"]), int(kw["dim"]) // int(kw["heads"])
    B, L = ctx.lead * ctx.batch, int(ctx.bench.traffic["length"])
    esz = 2 if ctx.precision == "bf16" else 4
    per_step = sum(peaks.bound_s(*k(B, L, H, H, D, esz), ctx.precision)
                   for k in (flash.k2, flash.k3, flash.k4))
    calls = ctx.done["windows"] * ctx.window * int(kw["depth"])
    return 100.0 * calls * per_step / spent
