"""Layers of the training zoo with flax's conventions: float32 parameters,
compute in the model dtype (flax's ``Dense(dtype=bf16)`` casts inputs and
kernel per call), and flax's default initializers drawn from a
``torch.Generator`` (``reset_parameters(generator)``).

Layouts are PyTorch's (``weight [out, in]``, convolutions OIHW on NCHW
activations); ``convert.py`` maps them to and from flax's (``kernel [in,
out]``, HWIO on NHWC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_TRUNC = .87962566103423978   # stddev of a unit normal truncated at ±2


def lecun_normal_(w, fan_in: int, generator) -> None:
    """flax's lecun-normal: truncated normal at ±2σ, σ = sqrt(1/fan_in)
    corrected for the truncation."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight [out, in]`` and ``bias`` in f32, the
    product in ``dtype``. ``nhwc_from = (C, H, W)`` marks a Dense that
    reads a flattened conv feature map: the port flattens NCHW, flax NHWC,
    so the weight bridge permutes its columns."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 nhwc_from: tuple | None = None):
        super().__init__()
        self.dtype = dtype
        self.nhwc_from = nhwc_from
        self.weight = nn.Parameter(torch.empty((features, in_features)))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME")`` at stride 1 on
    NCHW activations: ``weight [out, in, k, k]`` and ``bias`` in f32, the
    convolution in ``dtype``."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 dtype=torch.float32):
        super().__init__()
        if kernel % 2 == 0:
            raise ValueError("SAME padding here needs an odd kernel")
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_channels, kernel, kernel)))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)
        self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.weight.shape[-1] // 2)


class Embed(nn.Module):
    """flax ``nn.Embed``: an f32 table ``weight [vocab, dim]`` whose rows
    are gathered and then cast to ``dtype`` (the same values as casting
    the table first)."""

    def __init__(self, vocab: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((vocab, dim)))

    def reset_parameters(self, generator) -> None:
        self.weight.normal_(0.0, self.weight.shape[1] ** -0.5,
                            generator=generator)

    def forward(self, tokens):
        return F.embedding(tokens.to(torch.int64), self.weight).to(self.dtype)


def reset_children(module: nn.Module, generator) -> None:
    """``reset_parameters(generator)`` on every direct child, in order."""
    for child in module.children():
        child.reset_parameters(generator)
