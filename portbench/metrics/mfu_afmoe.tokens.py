"""AFMoE's model FLOPs over the traced window's host time, as a share of
the bf16 peak (``flops/peaks.json``), in %: every token trained at the
operations outside the routed experts (``flops/afmoe.py``), plus each
(token, expert) pair the held experts computed (the pairs a window from
the span pass's counters, ``portbench.moeload``)."""

from portbench import moeload
from portbench.flops import afmoe, peaks


def read(ctx):
    load = moeload.per_window(ctx)
    if load is None:
        return None
    kw = ctx.bench.config["kwargs"]
    ops = (afmoe.train_flops_per_token(kw, int(ctx.bench.traffic["length"]))
           * ctx.done["tokens"]
           + afmoe.expert_flops_per_pair(kw) * load[0] * ctx.done["windows"])
    return 100.0 * ops / ctx.window_s / peaks.flops(ctx.precision)
