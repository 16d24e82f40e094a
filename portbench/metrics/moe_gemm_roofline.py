"""The expert layer's grouped products (``ops/moe_gemm.py`` →
``csrc/moe_gemm.cu``) over the traced window: the bound time of the six
products a layer call needs at the pairs computed here
(``flops/afmoe.py``; the pairs from the span pass's counters,
``portbench.moeload``) over the device time of the kernels named
``moe_gemm…``, in %."""

import re

from portbench import moeload
from portbench.flops import afmoe, peaks

KERNEL = re.compile(r"\bmoe_gemm\w*kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    spent = sum(b - a for a, b, name, *_ in ctx.trace.kernels_in_window()
                if KERNEL.search(name)) / 1e6
    load = moeload.per_window(ctx)
    if spent <= 0 or load is None:
        return None
    pairs, calls = load
    kw = ctx.bench.config["kwargs"]
    groups = ctx.lead * int(kw["experts_held"])
    esz = 2 if ctx.precision == "bf16" else 4
    per_call = sum(peaks.bound_s(ops, nbytes, ctx.precision)
                   for ops, nbytes in afmoe.grouped_products(
                       pairs / calls, groups, int(kw["dim"]),
                       int(kw["expert_dim"]), esz))
    return 100.0 * per_call * calls * ctx.done["windows"] / spent
