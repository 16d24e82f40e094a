"""Convolutional families: LeNet (MNIST, BASELINE config 2, the ADAG
flagship) and VGG-small (CIFAR-10, config 3). Port of
``distkeras_tpu/models/cnn.py``.

Inputs keep the JAX package's NHWC layout at the public boundary and are
moved to NCHW once, inside; the convolutions and pools are stock PyTorch
(they were XLA, not Pallas, in the JAX package). No batch norm: every
model in the zoo is stateless.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module
from distkeras_tpu_torch.models.layers import Conv, Dense, reset_children


class _ConvNet(nn.Module):
    """Conv stages (each ``convs_per_stage`` SAME convs + relu, then a 2×2
    max pool) → Dense(hidden) + relu → Dense(num_classes) logits (f32).
    Layers are named as flax names them (``Conv_0``…, ``Dense_0``…)."""

    def __init__(self, input_shape, widths, kernel, convs_per_stage,
                 hidden, num_classes, dtype):
        super().__init__()
        self.dtype = dtype
        self.convs_per_stage = convs_per_stage
        h, w, c = input_shape
        n = 0
        for width in widths:
            for _ in range(convs_per_stage):
                self.add_module(f"Conv_{n}", Conv(c, width, kernel, dtype))
                c, n = width, n + 1
            h, w = h // 2, w // 2
        self.Dense_0 = Dense(c * h * w, hidden, dtype, nhwc_from=(c, h, w))
        self.Dense_1 = Dense(hidden, num_classes, dtype)

    def reset_parameters(self, generator) -> None:
        reset_children(self, generator)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)     # NHWC → NCHW
        convs = [m for m in self.children() if isinstance(m, Conv)]
        for n, conv in enumerate(convs):
            x = torch.relu(conv(x))
            if (n + 1) % self.convs_per_stage == 0:
                x = F.max_pool2d(x, 2, 2)
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x).to(torch.float32)


class LeNet(_ConvNet):
    """LeNet-style MNIST CNN: conv32-5 / pool / conv64-5 / pool / 256 /
    logits."""

    def __init__(self, input_shape=(28, 28, 1), num_classes=10,
                 dtype=torch.bfloat16):
        super().__init__(input_shape, (32, 64), 5, 1, 256, num_classes, dtype)


class VGGSmall(_ConvNet):
    """VGG-small for CIFAR-10: three blocks of two 3×3 convs + pool, then
    512 / logits."""

    def __init__(self, input_shape=(32, 32, 3), num_classes=10,
                 widths=(64, 128, 256), dtype=torch.bfloat16):
        super().__init__(input_shape, tuple(widths), 3, 2, 512, num_classes,
                         dtype)


def _image_example(input_shape):
    return torch.zeros((1,) + tuple(input_shape), dtype=torch.float32)


def lenet(input_shape=(28, 28, 1), num_classes=10,
          dtype=torch.bfloat16) -> ModelSpec:
    return from_module(LeNet(tuple(input_shape), num_classes, dtype),
                       name="lenet", example=_image_example(input_shape))


def vgg_small(input_shape=(32, 32, 3), num_classes=10,
              dtype=torch.bfloat16) -> ModelSpec:
    return from_module(VGGSmall(tuple(input_shape), num_classes, dtype=dtype),
                       name="vgg_small", example=_image_example(input_shape))
