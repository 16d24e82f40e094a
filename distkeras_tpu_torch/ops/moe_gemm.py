"""Grouped matrix products over row-sorted groups: the dropless expert
layer's three products (``parallel/expert.py``), a hand-written kernel on
the card (``csrc/moe_gemm.cu``) and a plain version beside it.

The rows of ``x [R, ·]`` are sorted by group: group ``g`` holds rows
``offsets[g] <= r < offsets[g + 1]`` (``offsets`` int32 ``[G + 1]``, on
the rows' device, ascending; rows from ``offsets[G]`` on belong to no
group). Groups may be uneven and empty, and their sizes never reach the
host: the kernel reads the offsets on the device, and its grid is sized
from the static shapes.

- :func:`grouped_mm` ``y[r] = x[r] · w[g]ᵀ`` (``w [G, N, K]``, the port's
  ``[out, in]`` layout): the forward product;
- :func:`grouped_mm_dx` ``dx[r] = dy[r] · w[g]``: its input gradient;
- :func:`grouped_mm_dw` ``dw[g] = Σ_{r in g} dy[r]ᵀ x[r]``: its weight
  gradient, a reduction over each group's own rows (an empty group's is
  zero).

Rows in no group come out zero in the first two, so what the caller does
with every row afterwards (an activation, a weighted sum) never meets
uninitialised memory. Products take bf16 operands, accumulate in f32 and
round once to bf16.

Between the two products of the layer, :func:`swiglu_weighted` (``a =
silu(gate) · up · w`` over ``h = [gate | up]``) and its gradient
:func:`swiglu_weighted_grad` walk only the rows of some group (a
kernel of the same library on the card: the layer's buffers have the
static row count, about eight times the held rows at the Trinity cell);
their outputs in rows of no group are left unwritten, except the
gradient's per-row sum, which is zero there.

On CPU tensors the plain versions run (the same arithmetic: one masked
product a group, in f32, rounded once to the operands' dtype; the SwiGLU
over every row); on CUDA tensors the kernels launch or raise. Each
wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.ops import _build

#: the kernel's tile: rows a block (two warpgroups of 64), columns a block
TILE_M, TILE_N = 128, 128
_MODE = {"fwd": 0, "dx": 1, "dw": 2}


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dk_moe_gemm.argtypes = [i, vp, vp, vp, vp, i, i, i, i, vp]
    lib.dk_moe_gemm.restype = i
    lib.dk_moe_swiglu.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i, vp]
    lib.dk_moe_swiglu.restype = i


def _group_masks(offsets, rows, device):
    """``[G, R, 1]`` booleans: row r lies in group g."""
    r = torch.arange(rows, device=device)[None, :, None]
    off = offsets.to(torch.int64)
    return (r >= off[:-1, None, None]) & (r < off[1:, None, None])


def grouped_mm_plain(x, w, offsets):
    masks = _group_masks(offsets, x.shape[0], x.device)
    xf = x.to(torch.float32)
    out = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for g in range(w.shape[0]):
        out = out + torch.where(masks[g], xf @ w[g].to(torch.float32).t(),
                                0.0)
    return out.to(x.dtype)


def grouped_mm_dx_plain(dy, w, offsets):
    masks = _group_masks(offsets, dy.shape[0], dy.device)
    df = dy.to(torch.float32)
    out = torch.zeros((dy.shape[0], w.shape[2]), dtype=torch.float32,
                      device=dy.device)
    for g in range(w.shape[0]):
        out = out + torch.where(masks[g], df @ w[g].to(torch.float32), 0.0)
    return out.to(dy.dtype)


def grouped_mm_dw_plain(x, dy, offsets):
    masks = _group_masks(offsets, x.shape[0], x.device)
    xf = x.to(torch.float32)
    df = dy.to(torch.float32)
    return torch.stack([torch.where(masks[g], df, 0.0).t() @ xf
                        for g in range(offsets.shape[0] - 1)]).to(x.dtype)


def _check(mode, a, b, offsets):
    for t in (a, b):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise TypeError(f"moe_gemm takes contiguous bf16 operands, got "
                            f"{t.dtype} with strides {t.stride()}")
    if (offsets.dtype != torch.int32 or offsets.dim() != 1
            or not offsets.is_contiguous() or offsets.device != a.device
            or b.device != a.device):
        raise TypeError("moe_gemm offsets must be contiguous int32 [G + 1] "
                        "on the operands' device")
    rows = a.shape[0]
    if mode == "dw":
        G = offsets.shape[0] - 1
        n, k = a.shape[1], b.shape[1]
        if b.shape[0] != rows:
            raise ValueError(f"moe_gemm dw: x has {b.shape[0]} rows, dy "
                             f"{rows}")
    else:
        G, n, k = b.shape
        if offsets.shape[0] != G + 1:
            raise ValueError(f"moe_gemm: {offsets.shape[0]} offsets for "
                             f"{G} groups")
        if a.shape[1] != (k if mode == "fwd" else n):
            raise ValueError(f"moe_gemm {mode}: rows of width {a.shape[1]} "
                             f"against weights {tuple(b.shape)}")
    if n % TILE_N or k % TILE_N:
        raise ValueError(f"moe_gemm takes widths that are multiples of "
                         f"{TILE_N}, got {n} and {k}")
    if rows * max(n, k) >= 2 ** 31 or G < 1 or G > 65535:
        raise ValueError(f"moe_gemm: {rows} rows of {max(n, k)} over {G} "
                         f"groups is out of the kernel's range")
    return G, rows, n, k


def _launch(mode, fn, a, b, out, offsets):
    G, rows, n, k = _check(mode, a, b, offsets)
    lib = _build.load("moe_gemm", _bind)
    err = lib.dk_moe_gemm(
        _MODE[mode], a.data_ptr(), b.data_ptr(), out.data_ptr(),
        offsets.data_ptr(), G, rows, n, k,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, f"moe_gemm {mode}")
    _build.count_launch(fn)
    return out


def _device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe_gemm runs on cpu or cuda tensors, got "
                         f"{t.device}")
    return t.device.type


def grouped_mm(x, w, offsets):
    """``y [R, N]``: ``x [R, K] · w[g]ᵀ`` for the rows of group g
    (``w [G, N, K]``), zero in rows of no group."""
    if _device(x) == "cpu":
        return grouped_mm_plain(x, w, offsets)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    return _launch("fwd", grouped_mm, x, w, out, offsets)


def grouped_mm_dx(dy, w, offsets):
    """``dx [R, K]``: ``dy [R, N] · w[g]`` for the rows of group g, zero in
    rows of no group."""
    if _device(dy) == "cpu":
        return grouped_mm_dx_plain(dy, w, offsets)
    out = torch.empty((dy.shape[0], w.shape[2]), dtype=dy.dtype,
                      device=dy.device)
    return _launch("dx", grouped_mm_dx, dy, w, out, offsets)


def grouped_mm_dw(x, dy, offsets):
    """``dw [G, N, K]``: ``Σ dy[r]ᵀ x[r]`` over the rows r of group g
    (``x [R, K]``, ``dy [R, N]``); zero for an empty group."""
    if _device(x) == "cpu":
        return grouped_mm_dw_plain(x, dy, offsets)
    G = offsets.shape[0] - 1
    out = torch.empty((G, dy.shape[1], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return _launch("dw", grouped_mm_dw, dy, x, out, offsets)


grouped_mm.launches = 0
grouped_mm_dx.launches = 0
grouped_mm_dw.launches = 0


def swiglu_weighted_plain(h, ws):
    g, u = h.to(torch.float32).chunk(2, dim=1)
    return (F.silu(g) * u * ws[:, None]).to(h.dtype)


def swiglu_weighted_grad_plain(h, ws, da):
    g, u = h.to(torch.float32).chunk(2, dim=1)
    sg = torch.sigmoid(g)
    act = g * sg * u
    d = da.to(torch.float32)
    dws = torch.sum(d * act, dim=1)
    d = d * ws[:, None]
    dh = torch.cat([d * u * sg * (1.0 + g * (1.0 - sg)), d * g * sg], dim=1)
    return dh.to(h.dtype), (act * ws[:, None]).to(h.dtype), dws


def _check_swiglu(h, ws, offsets, *more):
    if h.dtype != torch.bfloat16 or not h.is_contiguous():
        raise TypeError("moe_swiglu takes contiguous bf16 h")
    rows, f2 = h.shape
    if f2 % 16:
        raise ValueError(f"moe_swiglu takes gate|up widths of 16k, got {f2}")
    if (ws.dtype != torch.float32 or not ws.is_contiguous()
            or tuple(ws.shape) != (rows,)):
        raise TypeError("moe_swiglu weights must be contiguous f32 [rows]")
    for t in more:
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or tuple(t.shape) != (rows, f2 // 2)):
            raise TypeError("moe_swiglu da must be contiguous bf16 [rows, F]")
    if (offsets.dtype != torch.int32 or not offsets.is_contiguous()
            or offsets.device != h.device or ws.device != h.device):
        raise TypeError("moe_swiglu offsets must be contiguous int32 on the "
                        "rows' device")
    return rows, f2 // 2


def swiglu_weighted(h, ws, offsets):
    """``a [R, F] = silu(h[:, :F]) · h[:, F:] · ws`` (``h [R, 2F]``,
    ``ws`` f32 ``[R]``) in the rows of some group; f32 inside, rounded
    once to ``h``'s dtype."""
    if _device(h) == "cpu":
        return swiglu_weighted_plain(h, ws)
    rows, f = _check_swiglu(h, ws, offsets)
    out = torch.empty((rows, f), dtype=h.dtype, device=h.device)
    lib = _build.load("moe_gemm", _bind)
    err = lib.dk_moe_swiglu(
        0, h.data_ptr(), ws.data_ptr(), None, out.data_ptr(), None, None,
        offsets.data_ptr(), offsets.shape[0] - 1, rows, f,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "moe_swiglu forward")
    _build.count_launch(swiglu_weighted)
    return out


def swiglu_weighted_grad(h, ws, da, offsets):
    """The gradient of :func:`swiglu_weighted` given ``da`` (``[R, F]``,
    the gradient of its output before the weights: ``d/d(act · ws)``):
    ``(dh [R, 2F], a_w = act · ws [R, F], dws [R] f32)``, ``dws[r] =
    Σ_j da[r, j] · act[r, j]`` (zero in rows of no group on the card)."""
    if _device(h) == "cpu":
        return swiglu_weighted_grad_plain(h, ws, da)
    rows, f = _check_swiglu(h, ws, offsets, da)
    dh = torch.empty_like(h)
    a_w = torch.empty((rows, f), dtype=h.dtype, device=h.device)
    dws = torch.empty((rows,), dtype=torch.float32, device=h.device)
    lib = _build.load("moe_gemm", _bind)
    err = lib.dk_moe_swiglu(
        1, h.data_ptr(), ws.data_ptr(), da.data_ptr(), dh.data_ptr(),
        a_w.data_ptr(), dws.data_ptr(), offsets.data_ptr(),
        offsets.shape[0] - 1, rows, f,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "moe_swiglu backward")
    _build.count_launch(swiglu_weighted_grad)
    return dh, a_w, dws


swiglu_weighted.launches = 0
swiglu_weighted_grad.launches = 0
