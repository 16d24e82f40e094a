"""The matrix product of a precision, and TF32 switched off."""

from __future__ import annotations

import torch

#: (dtype, largest finite value) of the fp8 formats: e4m3 for the forward
#: pass's operands, e5m2 for the backward pass's gradients (fp8
#: training's usual split)
E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def no_tf32() -> None:
    """f32 products in f32: the reference's matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, fmt=E4M3) -> torch.Tensor:
    """``x`` rounded to an fp8 format with one scale per tensor (its
    largest magnitude at the format's largest value), back in ``x``'s
    dtype."""
    dtype, top = fmt
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8MatMul(torch.autograd.Function):
    """``a @ b`` computed in fp8: the operands rounded to e4m3, the
    incoming gradient to e5m2, every product accumulated in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = a.shape, b.shape
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        sa, sb = ctx.shapes
        qg = fp8(g, E5M2)
        ga = torch.matmul(qg, qb.transpose(-1, -2)).sum_to_size(sa)
        gb = torch.matmul(qa.transpose(-1, -2), qg).sum_to_size(sb)
        return ga, gb


def matmul(precision: str):
    """``mm(a, b)``: ``a @ b`` in f32, or computed in fp8."""
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _FP8MatMul.apply
    raise ValueError(f"unknown precision {precision!r}")
