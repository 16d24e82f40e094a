"""Dense MLP family (MNIST-MLP and Higgs-MLP, BASELINE configs 1 and 4).
Port of ``distkeras_tpu/models/mlp.py``."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module
from distkeras_tpu_torch.models.layers import Dense, reset_children


class MLP(nn.Module):
    """Flatten → hidden dense+relu stack → logits (f32). Compute dtype
    defaults to bfloat16; params stay float32. Layers are named as flax
    names them: ``Dense_0``, ``Dense_1``, …"""

    def __init__(self, in_features: int, hidden: Sequence[int] = (500, 300),
                 num_classes: int = 10, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = [in_features, *hidden, num_classes]
        for n, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"Dense_{n}", Dense(a, b, dtype))

    def reset_parameters(self, generator) -> None:
        reset_children(self, generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        layers = list(self.children())
        for layer in layers[:-1]:
            x = torch.relu(layer(x))
        return layers[-1](x).to(torch.float32)


def mlp(input_shape=(28, 28, 1), hidden=(500, 300), num_classes=10,
        dtype=torch.bfloat16) -> ModelSpec:
    module = MLP(int(np.prod(input_shape)), tuple(hidden), num_classes, dtype)
    example = torch.zeros((1,) + tuple(input_shape), dtype=torch.float32)
    return from_module(module, name="mlp", example=example)
