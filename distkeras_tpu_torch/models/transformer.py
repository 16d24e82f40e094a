"""Position tables shared by the transformer families (the port's copy of
``distkeras_tpu/models/transformer.py::sincos_positions``)."""

from __future__ import annotations

import numpy as np


def sincos_positions(maxlen: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal position table [maxlen, dim] (Vaswani et al. 2017)."""
    pos = np.arange(maxlen)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    table = np.zeros((maxlen, dim), np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table
