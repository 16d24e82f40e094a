"""The LSTM recurrence as hand-written CUDA kernels, forward and backward.

Port of ``distkeras_tpu/ops/recurrent.py``. The TPU kernels ran the whole
scan as one Pallas grid with the h/c carries in VMEM; on Hopper the same
work is ``csrc/lstm.cu``: the forward scan (K6; in bf16 at H 32, 64 and
128 spread over a thread-block cluster per group of 8 or 16 batch rows,
see :func:`forward_launch`), and the reverse-time backward scan with its
weight-gradient product (K7). Gate math as in
``models.lstm``: forget bias +1.0, c carried in f32, h in the model dtype.

The numerics follow the kernel, not :func:`lstm_scan_reference`: ``z``
adds ``gx`` in f32 to the f32-accumulated ``h @ wh`` (the reference adds
in the model dtype first); the two agree in f32. ``hs`` and ``cs`` are
saved in the model dtype, ``dwh`` is accumulated in f32 and cast to
``wh``'s dtype.

Entry: :func:`lstm_scan` takes batch-major ``gates_x [B, T, 4H]`` and
``wh [H, 4H]``. It goes through two ``torch.autograd.Function`` s, one
launching the forward kernel and one launching the backward kernels (the
first one's ``backward`` calls the second). Both have a leading problem
axis G and a ``vmap`` rule that folds the vmapped axis into G, so the
engine's ``torch.func.vmap`` over W stacked workers launches each kernel
once for all workers; inside ``vmap`` the tensors are batched wrappers
with no ``data_ptr``, which is why the rule, not the body, meets the
kernel. On CPU tensors the same Functions run the plain versions below,
batched along G the same way.
"""

from __future__ import annotations

import ctypes

import torch

from distkeras_tpu_torch.ops import _build
from distkeras_tpu_torch.utils import fold_vmapped as _fold
from distkeras_tpu_torch.utils import unfold_vmapped as _unfold

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _gates(z):
    """z [..., 4H] f32 → activated (i, f, g, o), forget bias +1.0."""
    i, f, g, o = z.chunk(4, dim=-1)
    return (torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.tanh(g),
            torch.sigmoid(o))


def _lstm_fwd_plain(gx, wh, save_c: bool):
    """Plain version of the forward kernel: gx [G,B,T,4H] (model dtype),
    wh [G,H,4H] → hs [G,B,T,H] (model dtype) and cs (or an empty tensor).
    Products of model-dtype values are exact in f32, so ``h.float() @
    wh_c.float()`` is the kernel's f32-accumulated product up to order."""
    G, B, T, H4 = gx.shape
    H = H4 // 4
    dt = gx.dtype
    whc = wh.to(dt).to(torch.float32)
    h = torch.zeros((G, B, H), dtype=dt, device=gx.device)
    c = torch.zeros((G, B, H), dtype=torch.float32, device=gx.device)
    hs = torch.empty((G, B, T, H), dtype=dt, device=gx.device)
    cs = torch.empty((G, B, T, H) if save_c else (0,), dtype=dt,
                     device=gx.device)
    for t in range(T):
        z = gx[:, :, t].to(torch.float32) + torch.bmm(h.to(torch.float32), whc)
        i, f, g, o = _gates(z)
        c = f * c + i * g
        h = (o * torch.tanh(c)).to(dt)
        hs[:, :, t] = h
        if save_c:
            cs[:, :, t] = c.to(dt)
    return hs, cs


def _lstm_bwd_plain(gx, wh, hs, cs, dhs):
    """Plain version of the backward kernels → (dgx [G,B,T,4H] model
    dtype, dwh [G,H,4H] f32)."""
    G, B, T, H4 = gx.shape
    H = H4 // 4
    dt = gx.dtype
    f32 = torch.float32
    whc = wh.to(dt).to(f32)
    dgx = torch.empty_like(gx)
    dwh = torch.zeros((G, H, H4), dtype=f32, device=gx.device)
    dc = torch.zeros((G, B, H), dtype=f32, device=gx.device)
    dh_carry = torch.zeros((G, B, H), dtype=f32, device=gx.device)
    zeros = torch.zeros((G, B, H), dtype=f32, device=gx.device)
    for t in range(T - 1, -1, -1):
        h_prev = hs[:, :, t - 1].to(f32) if t > 0 else zeros
        c_prev = cs[:, :, t - 1].to(f32) if t > 0 else zeros
        z = gx[:, :, t].to(f32) + torch.bmm(h_prev, whc)
        i, f, g, o = _gates(z)
        c = cs[:, :, t].to(f32)
        tc = torch.tanh(c)
        dh = dhs[:, :, t].to(f32) + dh_carry
        d_o = dh * tc * o * (1.0 - o)
        dct = dh * o * (1.0 - tc * tc) + dc
        d_i = dct * g * i * (1.0 - i)
        d_f = dct * c_prev * f * (1.0 - f)
        d_g = dct * i * (1.0 - g * g)
        dc = dct * f
        dz = torch.cat([d_i, d_f, d_g, d_o], dim=-1).to(dt)
        dgx[:, :, t] = dz
        dz32 = dz.to(f32)
        dh_carry = torch.bmm(dz32, whc.transpose(1, 2))
        dwh += torch.bmm(h_prev.transpose(1, 2), dz32)
    return dgx, dwh


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dk_lstm_supported.argtypes = [i, i]
    lib.dk_lstm_supported.restype = i
    lib.dk_lstm_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp]
    lib.dk_lstm_fwd.restype = i
    lib.dk_lstm_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                vp]
    lib.dk_lstm_bwd.restype = i
    lib.dk_lstm_fwd_cluster.argtypes = [i, i]
    lib.dk_lstm_fwd_cluster.restype = i
    lib.dk_lstm_fwd_cluster_rows.argtypes = [i, i, i]
    lib.dk_lstm_fwd_cluster_rows.restype = i


def _check(gx, wh, *rest):
    dtype = _DTYPE_CODE.get(gx.dtype)
    if dtype is None:
        raise TypeError(f"lstm kernels take float32 or bfloat16 gates, got "
                        f"{gx.dtype}")
    if wh.dtype != torch.float32:
        raise TypeError(f"lstm kernels take a float32 wh, got {wh.dtype}")
    for t in (gx, wh, *rest):
        if t.device != gx.device:
            raise ValueError("lstm kernel inputs must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("lstm kernel inputs must be contiguous")
    for t in rest:
        if t.dtype != gx.dtype:
            raise TypeError(f"lstm kernel sequences must share gx's dtype "
                            f"{gx.dtype}, got {t.dtype}")
    G, B, T, H4 = gx.shape
    lib = _build.load("lstm", _bind)
    if not lib.dk_lstm_supported(dtype, H4 // 4):
        raise ValueError(f"lstm kernels take H a multiple of 16 whose tiles "
                         f"fit in shared memory; got H={H4 // 4} in "
                         f"{gx.dtype}")
    return lib, dtype


def _lstm_fwd_cuda(gx, wh, save_c: bool):
    lib, dtype = _check(gx, wh)
    G, B, T, H4 = gx.shape
    hs = torch.empty((G, B, T, H4 // 4), dtype=gx.dtype, device=gx.device)
    cs = torch.empty_like(hs) if save_c else hs.new_empty((0,))
    err = lib.dk_lstm_fwd(gx.data_ptr(), wh.data_ptr(), hs.data_ptr(),
                          cs.data_ptr() if save_c else None, G, B, T, H4 // 4,
                          int(save_c), dtype,
                          torch.cuda.current_stream(gx.device).cuda_stream)
    _build.check(err, "lstm forward")
    _build.count_launch(lstm_forward)
    return hs, cs


def forward_launch(gx) -> dict:
    """How K6 launches on this ``gx [G,B,T,4H]`` (a CUDA tensor): the
    cluster size (0 for the per-block scan, which f32, an H the cluster
    plan does not take, or a gx not 16-byte aligned get), the batch rows a
    cluster (or block) takes, the blocks and the threads a block."""
    G, B, T, H4 = gx.shape
    H = H4 // 4
    lib = _build.load("lstm", _bind)
    dtype = _DTYPE_CODE[gx.dtype]
    c = lib.dk_lstm_fwd_cluster(dtype, H) if gx.data_ptr() % 16 == 0 else 0
    if c:
        rows = lib.dk_lstm_fwd_cluster_rows(G, B, c)
        return dict(cluster=c, rows=rows, blocks=G * -(-B // rows) * c,
                    threads=32 * H // (8 * c))
    return dict(cluster=0, rows=16, blocks=G * -(-B // 16),
                threads=32 * min(H // 16, 8))


def _lstm_bwd_into(dgx, dwh, gx, wh, hs, cs, dhs, parts: int = 3):
    """Launch K7 into ``dgx`` and ``dwh``: ``parts`` 1 runs the reverse
    scan (dgx), 2 the weight-gradient product (dwh, from ``hs`` and the
    ``dgx`` in place), 3 both. Counts nothing: :func:`lstm_backward` is the
    entry; ``chip_smoke.py`` times the two launches apart through this."""
    lib, dtype = _check(gx, wh, hs, cs, dhs, dgx)
    G, B, T, H4 = gx.shape
    err = lib.dk_lstm_bwd(gx.data_ptr(), wh.data_ptr(), hs.data_ptr(),
                          cs.data_ptr(), dhs.data_ptr(), dgx.data_ptr(),
                          dwh.data_ptr(), G, B, T, H4 // 4, dtype, parts,
                          torch.cuda.current_stream(gx.device).cuda_stream)
    _build.check(err, "lstm backward")


def _lstm_bwd_cuda(gx, wh, hs, cs, dhs):
    G, B, T, H4 = gx.shape
    dgx = torch.empty_like(gx)
    dwh = torch.empty((G, H4 // 4, H4), dtype=torch.float32, device=gx.device)
    _lstm_bwd_into(dgx, dwh, gx, wh, hs, cs, dhs)
    _build.count_launch(lstm_backward)
    return dgx, dwh


def _on_device(kernel, plain, *args, impl):
    dev = args[0].device
    if impl == "plain" or dev.type == "cpu":
        return plain(*args)
    if dev.type == "cuda":
        return kernel(*args)
    raise ValueError(f"lstm kernels run on cpu or cuda tensors, got {dev}")


def lstm_forward(gx, wh, save_c: bool, impl: str = "kernel"):
    """K6 on ``gx [G,B,T,4H]``, ``wh [G,H,4H]`` → ``(hs, cs)``: the
    hand-written kernel on CUDA tensors (or raise), the plain version on
    CPU tensors or with ``impl="plain"``. ``launches`` counts kernel
    launches."""
    return _on_device(_lstm_fwd_cuda, _lstm_fwd_plain,
                      gx.contiguous(), wh.contiguous(), save_c, impl=impl)


def lstm_backward(gx, wh, hs, cs, dhs, impl: str = "kernel"):
    """K7 → ``(dgx [G,B,T,4H], dwh [G,H,4H] f32)``; dispatch as
    :func:`lstm_forward`."""
    return _on_device(_lstm_bwd_cuda, _lstm_bwd_plain, gx.contiguous(),
                      wh.contiguous(), hs.contiguous(), cs.contiguous(),
                      dhs.contiguous(), impl=impl)


lstm_forward.launches = 0
lstm_backward.launches = 0


class _ScanBackward(torch.autograd.Function):
    """K7 as a Function, so ``torch.func`` can batch it (its own backward,
    a second derivative, is not provided)."""

    @staticmethod
    def forward(gx, wh, hs, cs, dhs, impl):
        return lstm_backward(gx, wh, hs, cs, dhs, impl=impl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ddgx, ddwh):
        raise NotImplementedError("the LSTM scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, gx, wh, hs, cs, dhs, impl):
        n = info.batch_size
        args = [_fold(x, d, n) for x, d in zip((gx, wh, hs, cs, dhs),
                                                in_dims[:5])]
        dgx, dwh = _ScanBackward.apply(*args, impl)
        return (_unfold(dgx, n), _unfold(dwh, n)), (0, 0)


class _Scan(torch.autograd.Function):
    """K6 as a Function whose backward launches K7."""

    @staticmethod
    def forward(gx, wh, save_c, impl):
        return lstm_forward(gx, wh, save_c, impl=impl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        gx, wh, _, impl = inputs
        hs, cs = output
        ctx.mark_non_differentiable(cs)
        ctx.impl = impl
        ctx.save_for_backward(gx, wh, hs, cs)

    @staticmethod
    def backward(ctx, dhs, _dcs):
        gx, wh, hs, cs = ctx.saved_tensors
        dgx, dwh = _ScanBackward.apply(gx, wh, hs, cs, dhs, ctx.impl)
        return dgx, dwh.to(wh.dtype), None, None

    @staticmethod
    def vmap(info, in_dims, gx, wh, save_c, impl):
        n = info.batch_size
        hs, cs = _Scan.apply(_fold(gx, in_dims[0], n), _fold(wh, in_dims[1], n),
                             save_c, impl)
        if cs.numel() == 0:
            return (_unfold(hs, n), cs), (0, None)
        return (_unfold(hs, n), _unfold(cs, n)), (0, 0)


def lstm_scan_reference(gates_x, wh):
    """The ``lax.scan`` oracle's math in plain PyTorch (batch-major I/O,
    ``z`` added in the model dtype first): ``gates_x [B, T, 4H]``,
    ``wh [H, 4H]`` → ``hs [B, T, H]``. Differentiated by autograd."""
    B, T, H4 = gates_x.shape
    H = H4 // 4
    dt = gates_x.dtype
    c = torch.zeros((B, H), dtype=torch.float32, device=gates_x.device)
    h = torch.zeros((B, H), dtype=dt, device=gates_x.device)
    whc = wh.to(dt)
    outs = []
    for t in range(T):
        z = (gates_x[:, t] + h @ whc).to(torch.float32)
        i, f, g, o = _gates(z)
        c = f * c + i * g
        h = (o * torch.tanh(c)).to(dt)
        outs.append(h)
    return torch.stack(outs, dim=1)


def lstm_scan(gates_x, wh, impl: str = "kernel"):
    """Run the LSTM recurrence over pre-projected gate inputs.

    ``gates_x [B, T, 4H]`` (``x @ W_x + b`` for every step, hoisted out of
    the recurrence as one matmul) and ``wh [H, 4H]`` (f32) → ``hs [B, T,
    H]`` in ``gates_x.dtype``; differentiable in both, and batchable by
    ``torch.func.vmap``.

    ``impl``: ``"kernel"`` runs K6/K7 (the CUDA kernels on the card, their
    plain versions on the CPU), ``"plain"`` the plain versions on any
    device, ``"reference"`` :func:`lstm_scan_reference`.
    """
    if impl not in ("kernel", "plain", "reference"):
        raise ValueError(f"unknown lstm impl {impl!r}; use 'kernel', "
                         f"'plain' or 'reference'")
    if impl == "reference":
        return lstm_scan_reference(gates_x, wh)
    hs, _ = _Scan.apply(gates_x[None], wh[None], torch.is_grad_enabled(),
                        impl)
    return hs[0]
