"""The table of peaks (``peaks.json``) and a roofline bound."""

from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "peaks.json")) as _f:
    PEAKS = json.load(_f)


def flops(precision: str) -> float:
    """Peak operations a second of ``precision`` (``bf16``, ``fp8``,
    ``tf32``, ``f32``)."""
    return float(PEAKS[precision + "_flops"])


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak of their precision and the bytes over HBM's rate."""
    return max(ops / flops(precision),
               nbytes / float(PEAKS["hbm_bytes_per_s"]))
