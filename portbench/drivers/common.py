"""What the drivers share: the model built from its configuration file,
its parameter shapes and buffers, and the seeded pool of traffic split
into the checked windows and the staged epoch."""

from __future__ import annotations

import gc

import torch

from portbench import core


def build_spec(config: dict, traffic: dict):
    """The port's training ``ModelSpec``: ``models.<builder>(**kwargs)``
    with the traffic's length as ``maxlen`` and the dtype by name."""
    from distkeras_tpu_torch import models

    kw = dict(config["kwargs"])
    kw["dtype"] = getattr(torch, kw["dtype"])
    return getattr(models, config["builder"])(maxlen=int(traffic["length"]),
                                              **kw)


def shapes(spec) -> dict:
    return {n: tuple(p.shape) for n, p in spec.module.named_parameters()}


def buffers(spec, device) -> dict:
    """The model's non-trainable state (its buffers: RoPE's angle table)
    on ``device``."""
    return {n: b.to(device) for n, b in spec.module.named_buffers()}


def pool(bench, seed: int, lead: int, window: int, batch: int, device,
         epoch_windows: int):
    """The seeded traffic as ``(checked, staged)``: the first
    ``core.CHECKED_WINDOWS`` windows, each ``[lead, window·batch, …]``,
    and the epoch's ``epoch_windows`` windows ``[lead, rows, …]``, all of
    distinct rows."""
    if int(bench.traffic["rows_per_step"]) != lead * batch:
        raise ValueError(
            f"traffic {bench.workload['traffic']} has "
            f"{bench.traffic['rows_per_step']} rows a step, the cell's "
            f"trainer {lead} x {batch}")
    per = window * batch
    n = core.CHECKED_WINDOWS
    cols = core.make_columns(bench.traffic, bench.config, lead,
                             (n + epoch_windows) * per, seed, device)
    checked = [tuple(c[:, s * per:(s + 1) * per].contiguous() for c in cols)
               for s in range(n)]
    staged = tuple(c[:, n * per:].contiguous() for c in cols)
    return checked, staged


def counts(bench, rows: int, windows: int) -> dict:
    return {"samples": rows, "tokens": rows * int(bench.traffic["length"]),
            "windows": windows}


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
