"""The port's expert-load counters, as the traced run's span pass leaves
them (``portbench.spanpass``: the pass runs the cell with the port's
tracer on, and the expert layer totals the pairs it computed window by
window, ``distkeras_tpu_torch.parallel.expert.LOAD``). The routing, and so
the pairs each held expert computes, depends on the data and the weights:
these are what the inputs needed, not the most they could."""

from __future__ import annotations

import importlib

from portbench import spanpass


def per_window(ctx):
    """``(pairs, layer calls)`` a window of the pass, or None where the
    pass or the port's counters are missing."""
    if spanpass.split(ctx) is None:
        return None
    try:
        expert = importlib.import_module(
            "distkeras_tpu_torch.parallel.expert")
    except ImportError:
        return None
    load = getattr(expert, "LOAD", None)
    if load is None or not load.windows:
        return None
    return load.pairs / load.windows, load.calls / load.windows
