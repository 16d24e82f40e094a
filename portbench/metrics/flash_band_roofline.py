"""K2, K3 and K4 (``ops/flash_attention.py`` → ``csrc/flash_attention*.cu``)
over the traced window for AFMoE's attention: the bound time of each
layer's forward and backward once a local step, every worker's rows in one
call, at GQA ``heads / kv_heads``, with the band's pairs on the sliding
layers and the causal pairs on the full ones (``flops/afmoe.py``), over
the device time of the kernels whose names start ``fa_``, in %."""

import re

from portbench.flops import afmoe, peaks

FLASH = re.compile(r"\bfa_\w*kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    spent = sum(b - a for a, b, name, *_ in ctx.trace.kernels_in_window()
                if FLASH.search(name)) / 1e6
    if spent <= 0:
        return None
    kw = ctx.bench.config["kwargs"]
    H, Hkv, D = int(kw["heads"]), int(kw["kv_heads"]), int(kw["head_dim"])
    B, L = ctx.lead * ctx.batch, int(ctx.bench.traffic["length"])
    esz = 2 if ctx.precision == "bf16" else 4
    per_step = 0.0
    for kind in kw["layer_types"]:
        window = int(kw["window"]) if kind == "sliding_attention" else None
        pairs = afmoe.band_pairs(B, L, window)
        per_step += sum(peaks.bound_s(ops, nbytes, ctx.precision)
                        for ops, nbytes in afmoe.flash_calls(
                            B, L, H, Hkv, D, pairs, esz))
    steps = ctx.done["windows"] * ctx.window
    return 100.0 * steps * per_step / spent
