"""LSTM sequence classifier (IMDB sentiment, BASELINE config 5).
Port of ``distkeras_tpu/models/lstm.py``.

Variable-length sequences arrive padded to a static length with a mask
column (``datasets.imdb``); classification reads a mask-weighted mean of
the hidden states over valid timesteps. The input half of the gate math
(``x_t @ W_x + b`` for every t) has no sequential dependence and runs as
one ``wx`` Dense over all timesteps before the recurrence; the recurrent
``wh [H, 4H]`` is its own f32 parameter and only ``h @ wh`` stays inside
the scan (``ops.recurrent.lstm_scan``: the hand-written kernels K6/K7).

The gate math is explicit, not ``torch.nn.LSTM``: the forget-gate +1.0 is
in the math, not in a bias. Cell state stays f32; gates and hidden states
compute in ``dtype``, ``wh`` stays f32, the pooled mean accumulates in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module
from distkeras_tpu_torch.models.layers import Dense, Embed
from distkeras_tpu_torch.ops.recurrent import lstm_scan


class LSTMClassifier(nn.Module):
    """``(tokens [B, T], mask [B, T]) → logits [B, num_classes]`` (f32).
    Parameters carry flax's names: ``Embed_0``, ``wx``, ``wh``,
    ``Dense_0``. ``scan_impl``: "kernel" (K6/K7: the CUDA kernels on the
    card, their plain versions on the CPU), "plain" (the plain versions on
    any device), "reference" (the plain-torch ``lax.scan`` oracle)."""

    def __init__(self, vocab: int = 20000, embed_dim: int = 128,
                 hidden_dim: int = 128, num_classes: int = 2,
                 dtype=torch.bfloat16, scan_impl: str = "kernel"):
        super().__init__()
        if scan_impl not in ("kernel", "plain", "reference"):
            raise ValueError(f"unknown scan_impl {scan_impl!r}")
        H = hidden_dim
        self.dtype = dtype
        self.scan_impl = scan_impl
        self.Embed_0 = Embed(vocab, embed_dim, dtype)
        self.wx = Dense(embed_dim, 4 * H, dtype)
        self.wh = nn.Parameter(torch.empty((H, 4 * H)))
        self.Dense_0 = Dense(H, num_classes, dtype)

    def reset_parameters(self, generator) -> None:
        self.Embed_0.reset_parameters(generator)
        self.wx.reset_parameters(generator)
        nn.init.orthogonal_(self.wh, generator=generator)
        self.Dense_0.reset_parameters(generator)

    def forward(self, tokens, mask=None):
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        gates_x = self.wx(self.Embed_0(tokens))              # [B, T, 4H]
        outs = lstm_scan(gates_x, self.wh, impl=self.scan_impl)  # [B, T, H]
        m = mask.to(torch.float32)[..., None]
        pooled = torch.sum(outs.to(torch.float32) * m, dim=1) / torch.clamp(
            torch.sum(m, dim=1), min=1.0)
        return self.Dense_0(pooled.to(self.dtype)).to(torch.float32)


def lstm_classifier(vocab=20000, maxlen=200, embed_dim=128, hidden_dim=128,
                    num_classes=2, dtype=torch.bfloat16,
                    scan_impl="kernel") -> ModelSpec:
    """``maxlen`` is the padded length of the inputs, and the example
    input's; the model itself takes any length."""
    module = LSTMClassifier(vocab=vocab, embed_dim=embed_dim,
                            hidden_dim=hidden_dim, num_classes=num_classes,
                            dtype=dtype, scan_impl=scan_impl)
    example = (torch.zeros((1, maxlen), dtype=torch.int64),
               torch.ones((1, maxlen), dtype=torch.float32))
    return from_module(module, name="lstm_classifier", example=example)
