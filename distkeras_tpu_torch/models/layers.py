"""Layers of the training zoo with flax's conventions: float32 parameters,
compute in the model dtype (flax's ``Dense(dtype=bf16)`` casts inputs and
kernel per call), and flax's default initializers drawn from a
``torch.Generator`` (``reset_parameters(generator)``).

Layouts are PyTorch's (``weight [out, in]``, convolutions OIHW on NCHW
activations); ``convert.py`` maps them to and from flax's (``kernel [in,
out]``, HWIO on NHWC).

:class:`BatchNorm` is functional: its forward returns the new running
statistics instead of writing its buffers, so it runs under
``torch.func.vmap`` with one set a worker. :func:`remat_block` runs a
block whose activations are recomputed in the backward pass (flax's
``nn.remat``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch import nn

from distkeras_tpu_torch.parallel import mesh as mesh_mod
from distkeras_tpu_torch.parallel.local_sgd import worker_mean
from distkeras_tpu_torch.parallel.tensor import embed_lookup, parallel_linear

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
    so the weight bridge permutes its columns. ``parallel`` is the layer's
    Megatron role ("column", "row" or None), applied while a
    tensor-parallel context is active (``parallel/tensor.py``)."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 nhwc_from: tuple | None = None, parallel: str | None = None):
        super().__init__()
        self.dtype = dtype
        self.nhwc_from = nhwc_from
        self.parallel = parallel
        self.weight = nn.Parameter(torch.empty((features, in_features)))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        self.bias.zero_()

    def forward(self, x):
        return parallel_linear(x, self.weight, self.bias, self.parallel,
                               self.dtype)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one axis: ``ceil(size / stride)``
    outputs, the padding split low ``total // 2`` and high the rest
    (``lax.padtype_to_pads``), so a stride-2 conv on an even width pads
    (0, 1) where ``padding=k // 2`` would pad (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=stride, padding="SAME",
    use_bias=use_bias)`` on NCHW activations: ``weight [out, in, k, k]``
    (and ``bias``) in f32, the convolution in ``dtype``."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 dtype=torch.float32, stride: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.stride = int(stride)
        self.weight = nn.Parameter(torch.empty(
            (features, in_channels, kernel, kernel)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        k, s = self.weight.shape[-1], self.stride
        bias = None if self.bias is None else self.bias.to(dt)
        (top, bottom), (left, right) = (same_pads(n, k, s)
                                        for n in x.shape[-2:])
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, stride=s,
                        padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon=1e-5, dtype=float32)`` over
    the channels of NCHW activations. Params ``weight`` (flax ``scale``)
    and ``bias``; state buffers ``mean`` and ``var`` (flax's
    ``batch_stats``), read but never written: ``forward(x, training)``
    returns ``(y, new_state)``.

    Training normalizes with the batch's f32 statistics over (N, H, W),
    ``var = max(0, E[x²] - E[x]²)`` (flax's ``use_fast_variance``), and
    returns ``{"mean", "var"}`` moved ``momentum`` of the way to them;
    with ``sync`` the two moments are first averaged over the engine's
    stacked workers in one :func:`worker_mean` (flax's ``pmean`` over
    ``axis_name``), giving the global batch's statistics. Eval mode uses
    the running statistics and returns ``{}``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, sync: bool = False):
        super().__init__()
        self.momentum, self.eps, self.sync = momentum, eps, sync
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x, training: bool = False):
        x = x.to(torch.float32)
        if training:
            axes = (0,) + tuple(range(2, x.dim()))
            moments = torch.stack([x.mean(axes), (x * x).mean(axes)])
            if self.sync:
                moments = worker_mean(moments)
            mean, mean2 = moments.unbind(0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            m = self.momentum
            new = {"mean": m * self.mean + (1 - m) * mean,
                   "var": m * self.var + (1 - m) * var}
        else:
            mean, var, new = self.mean, self.var, {}
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape)
        return y + self.bias.reshape(shape), new


def prefixed(prefix: str, state: dict) -> dict:
    """A child's new state keyed by its parent's buffer names."""
    return {f"{prefix}.{k}": v for k, v in state.items()}


class Embed(nn.Module):
    """flax ``nn.Embed``: an f32 table ``weight [vocab, dim]`` whose rows
    are gathered and then cast to ``dtype`` (the same values as casting
    the table first); vocab-parallel under a tensor-parallel context
    (``parallel.tensor.embed_lookup``)."""

    def __init__(self, vocab: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((vocab, dim)))

    def reset_parameters(self, generator) -> None:
        self.weight.normal_(0.0, self.weight.shape[1] ** -0.5,
                            generator=generator)

    def forward(self, tokens):
        return embed_lookup(self.weight, tokens).to(self.dtype)


def reset_children(module: nn.Module, generator) -> None:
    """``reset_parameters(generator)`` on every direct child, in order."""
    for child in module.children():
        child.reset_parameters(generator)


class _Remat(torch.autograd.Function):
    """``fn(*tensors)`` with nothing saved but its inputs: the forward
    runs under ``no_grad`` and the backward runs ``fn`` again through
    ``torch.func.vjp``. ``torch.utils.checkpoint`` cannot do this under
    the engine's ``vmap(grad_and_value)``: its saved-tensor hooks are
    refused by ``torch.func.grad``. ``generate_vmap_rule`` lets
    ``torch.func.vmap`` batch both passes, so Functions inside ``fn``
    (the flash kernels') meet their own ``vmap`` rules each time."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        with torch.no_grad():
            return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        # torch.func.grad differentiates with create_graph=True, so a
        # backward run with grad enabled records the recompute for a second
        # derivative and keeps every block's activations alive until the
        # gradient is done; under no_grad only vjp's own level records
        with torch.no_grad():
            _, pull = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
            return (None,) + tuple(pull(g))


def remat_block(block: nn.Module, *args):
    """``block(*args)`` (one tensor out) rematerialized in the backward
    pass: activations inside the block are not kept, and the backward
    pays one more forward of it. The block's parameters and buffers are
    explicit inputs of the Function and keep their names (a buffer that
    ``functional_call`` swapped in, the engine's per-worker state, is a
    batched tensor the Function must see); ``args`` may hold ``None`` and
    tuples of tensors (a RoPE table). The recompute runs under the mesh
    context of the forward (a strategy's groups)."""
    names, params = zip(*block.named_parameters(),
                        *block.named_buffers())
    ctx = mesh_mod.context()
    flat, spec = pytree.tree_flatten(args)
    where = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]
    n = len(names)

    def run(*tensors):
        leaves = list(flat)
        for i, t in zip(where, tensors[n:]):
            leaves[i] = t
        with mesh_mod.using(ctx):
            return torch.func.functional_call(
                block, dict(zip(names, tensors[:n])),
                tuple(pytree.tree_unflatten(leaves, spec)))

    return _Remat.apply(run, *params, *(flat[i] for i in where))
