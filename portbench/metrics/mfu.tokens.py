"""The LM's model FLOPs a token (``flops/lm.py``) times the tokens the
traced window trained, over its host time, as a share of the bf16 peak
(``flops/peaks.json``), in %."""

from portbench.flops import lm, peaks


def read(ctx):
    kw = ctx.bench.config["kwargs"]
    per = lm.train_flops_per_token(int(kw["dim"]), int(kw["depth"]),
                                   int(ctx.bench.traffic["length"]),
                                   int(kw["vocab"]))
    return 100.0 * per * ctx.done["tokens"] / ctx.window_s \
        / peaks.flops(ctx.precision)
