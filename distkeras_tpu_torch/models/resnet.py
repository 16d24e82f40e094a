"""ResNet family: the batch-norm model, whose BatchNorm running statistics
are the non-trainable state. Port of ``distkeras_tpu/models/resnet.py``.

A small CIFAR-style residual network. The engine carries one set of
statistics a worker in its stacked ``nt`` (``LocalSGDEngine``), as standard
data-parallel BN; ``sync_bn=True`` averages the batch statistics over the
stacked workers (``parallel.local_sgd.worker_mean``), global-batch BN on
the collective backend only. The module's forward returns ``(logits,
new_state)`` (``returns_state``): the seam ``model.from_module`` reads.

Inputs are NHWC at the public boundary, moved to NCHW once inside. Convs
in ``dtype`` without a bias (BN follows each), BN and the residual add in
f32, with the casts of the JAX module.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module
from distkeras_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    prefixed,
    reset_children,
)


class ResidualBlock(nn.Module):
    """Two 3×3 convs with BN (``Conv_0``/``bn1``, ``Conv_1``/``bn2``) and,
    when the width or the stride changes, a 1×1 ``proj``/``bn_proj`` on
    the shortcut. ``forward(x, training) -> (y, new_state)``."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16, bn_momentum: float = 0.9,
                 sync_bn: bool = False):
        super().__init__()
        self.dtype = dtype

        def bn():
            return BatchNorm(filters, bn_momentum, sync=sync_bn)

        self.Conv_0 = Conv(in_channels, filters, 3, dtype, stride=stride,
                           use_bias=False)
        self.bn1 = bn()
        self.Conv_1 = Conv(filters, filters, 3, dtype, use_bias=False)
        self.bn2 = bn()
        self.has_proj = in_channels != filters or stride != 1
        if self.has_proj:
            self.proj = Conv(in_channels, filters, 1, dtype, stride=stride,
                             use_bias=False)
            self.bn_proj = bn()

    def reset_parameters(self, generator) -> None:
        reset_children(self, generator)

    def forward(self, x, training: bool = False):
        new = {}
        h, s = self.bn1(self.Conv_0(x).to(torch.float32), training)
        new.update(prefixed("bn1", s))
        h = torch.relu(h)
        h, s = self.bn2(self.Conv_1(h.to(self.dtype)).to(torch.float32),
                        training)
        new.update(prefixed("bn2", s))
        if self.has_proj:
            x, s = self.bn_proj(self.proj(x.to(self.dtype))
                                .to(torch.float32), training)
            new.update(prefixed("bn_proj", s))
        return torch.relu(x + h), new


class ResNetSmall(nn.Module):
    """ResNet-8-style CIFAR network: ``stem`` conv + ``bn_stem``, then
    ``len(widths)`` stages of ``blocks_per_stage`` residual blocks
    (``stage{i}_block{b}``, stride 2 at the first block of every stage but
    the first), global average pool, ``Dense_0`` → f32 logits."""

    returns_state = True

    def __init__(self, num_classes: int = 10, widths=(16, 32, 64),
                 blocks_per_stage: int = 1, dtype=torch.bfloat16,
                 in_channels: int = 3, sync_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        c = widths[0]
        self.stem = Conv(in_channels, c, 3, dtype, use_bias=False)
        self.bn_stem = BatchNorm(c, 0.9, sync=sync_bn)
        for i, w in enumerate(widths):
            for b in range(blocks_per_stage):
                stride = 2 if (i > 0 and b == 0) else 1
                self.add_module(f"stage{i}_block{b}", ResidualBlock(
                    c, w, stride, dtype, sync_bn=sync_bn))
                c = w
        self.Dense_0 = Dense(c, num_classes, dtype)

    def reset_parameters(self, generator) -> None:
        reset_children(self, generator)

    def forward(self, x, training: bool = False):
        x = x.to(self.dtype).permute(0, 3, 1, 2)      # NHWC → NCHW
        x, new = self.bn_stem(self.stem(x).to(torch.float32), training)
        new = prefixed("bn_stem", new)
        x = torch.relu(x)
        for name, blk in self.named_children():
            if isinstance(blk, ResidualBlock):
                x, s = blk(x, training)
                new.update(prefixed(name, s))
        x = torch.mean(x, dim=(2, 3))                 # global average pool
        return self.Dense_0(x.to(self.dtype)).to(torch.float32), new


def resnet_small(num_classes: int = 10, input_shape=(32, 32, 3),
                 widths=(16, 32, 64), blocks_per_stage: int = 1,
                 dtype=torch.bfloat16, sync_bn: bool = False) -> ModelSpec:
    """``sync_bn=True`` averages BN statistics over the collective
    backend's stacked workers (global-batch BN) and marks the spec
    ``requires_worker_axis``: the PS backend's threads have no such axis,
    and its trainers refuse the spec."""
    module = ResNetSmall(num_classes=num_classes, widths=tuple(widths),
                         blocks_per_stage=blocks_per_stage, dtype=dtype,
                         in_channels=int(input_shape[-1]),
                         sync_bn=bool(sync_bn))
    example = torch.zeros((1,) + tuple(input_shape), dtype=torch.float32)
    spec = from_module(module, name="resnet_small", example=example)
    return dataclasses.replace(spec, requires_worker_axis=bool(sync_bn))
