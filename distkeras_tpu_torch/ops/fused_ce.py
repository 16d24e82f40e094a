"""Chunked fused linear + softmax cross-entropy: large-vocab LM training
without the ``[N, V]`` logits tensor.

Port of ``distkeras_tpu/ops/fused_ce.py``. The loss needs three reductions
of the logits — the per-row log-sum-exp, the picked label logit and, in the
backward, the softmax row — so both passes walk the rows ``chunk`` at a
time: each chunk's ``[chunk, V]`` logits live for one loop step, and the
backward recomputes them from the saved ``hidden`` (FLOPs for memory, as
the flash backward does) and accumulates ``d_kernel`` in f32. Peak extra
memory is ``O(chunk · V)`` plus one f32 kernel-shaped accumulator.

The chunk products are cuBLAS products. As in the JAX op
(``preferred_element_type=float32``), each product takes its operands in
the hidden dtype and returns f32: a chunk's logits are never rounded to
bf16 before the f32 softmax math, and ``d_kernel`` is summed from f32
products. ``dh`` is the f32 product rounded once to the hidden dtype. On
CUDA that is one bf16 × bf16 → f32 product (``torch.bmm(...,
out_dtype=torch.float32)``); on the CPU, the same product of f32 upcasts.

Between the products, a chunk's f32 row work is one hand-written kernel a
pass (``csrc/fused_ce.cu``; the JAX package has no Pallas kernel here, its
op is XLA): :func:`ce_fwd_rows` reads the logits once and writes each
row's log-sum-exp and nll, which the forward keeps; :func:`ce_bwd_rows`
reads them once more with that lse and writes ``dlogits`` in the hidden
dtype, the label's −1 put in by index, with ``d_bias``'s column sums in
f32. The backward sums ``d_kernel`` inside its product (``baddbmm`` into
the f32 accumulator), ``_PAIR`` chunks of ``dlogits`` a product, and takes
``d_mask`` from the forward's nll. On a CPU tensor the plain versions
beside the kernels run instead (the same arithmetic in PyTorch); on a CUDA
tensor the kernels launch or raise.

:func:`chunked_softmax_cross_entropy` is a ``torch.autograd.Function`` over
a leading group axis. It and its backward (a second Function) have
``vmap`` rules that fold a vmapped worker axis into that axis, so the
training engine's ``torch.func.vmap(grad)`` over stacked workers runs one
batched product and one kernel launch per chunk for all workers in both
passes (the f32-output product has no batching rule of its own, and would
fall back to a loop over workers).

With ``observability.trace`` on, the forward records ``fused_ce.forward``
and the backward ``fused_ce.backward`` (on the thread autograd runs it
on), around the chunks' products and their f32 work.
"""

from __future__ import annotations

import ctypes

import torch

from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.ops import _build
from distkeras_tpu_torch.utils import fold_vmapped as _fold
from distkeras_tpu_torch.utils import unfold_vmapped as _unfold

# chunks of dlogits that one d_kernel product sums: two bf16 chunks are the
# bytes of one f32 logits chunk, and halve the f32 accumulator's traffic
_PAIR = 2
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _mm_f32(a, b):
    """``[G, m, k] @ [G, k, n]`` in the operands' dtype, f32 out."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def _mm_f32_acc(acc, a, b):
    """``acc += a @ b`` inside the product (the f32 ``acc`` is its C
    operand, read and written once), operands as :func:`_mm_f32`."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.baddbmm(acc, a, b, out=acc)
    if a.is_cuda:
        return torch.baddbmm(acc, a, b, out_dtype=torch.float32, out=acc)
    return torch.baddbmm(acc, a.to(torch.float32), b.to(torch.float32),
                         out=acc)


def _rows_fwd_plain(logits, bias, labels):
    """Plain version of ``ce_fwd_rows``: per-row ``(lse, nll)`` ``[G, c]``
    of one chunk's f32 logits ``[G, c, V]`` (+ f32 bias ``[G, V]``)."""
    x = logits if bias is None else logits + bias[:, None, :]
    lse = torch.logsumexp(x, dim=-1)
    picked = torch.gather(x, -1, labels[..., None])[..., 0]
    return lse, lse - picked


def _rows_bwd_plain(logits, bias, labels, lse, mask, scale, out_dtype):
    """Plain version of ``ce_bwd_rows``: ``dlogits = (exp(x − lse) −
    [j = label]) · mask · scale`` rounded once to ``out_dtype``, and its
    f32 column sums ``[G, V]`` before that rounding."""
    x = logits if bias is None else logits + bias[:, None, :]
    d = torch.exp(x - lse[..., None])
    d.scatter_add_(-1, labels[..., None],
                   torch.full_like(lse[..., None], -1.0))
    d = d * (mask * scale[:, None])[..., None]
    return d.to(out_dtype), torch.sum(d, dim=1)


def _bind(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dk_ce_fwd_rows.argtypes = [vp, ll, vp, vp, ll, vp, vp, ll, i, i, i,
                                   i, vp]
    lib.dk_ce_fwd_rows.restype = i
    lib.dk_ce_bwd_rows.argtypes = [vp, ll, vp, vp, ll, vp, ll, vp, ll, vp,
                                   vp, ll, i, vp, vp, vp, i, i, i, i, i, vp]
    lib.dk_ce_bwd_rows.restype = i
    lib.dk_ce_bwd_cols.argtypes = []
    lib.dk_ce_bwd_cols.restype = i


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(logits, bias, labels, *rows):
    if logits.dtype != torch.float32:
        raise TypeError(f"fused CE kernels take f32 logits, got "
                        f"{logits.dtype}")
    if bias is not None and (bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise TypeError("fused CE kernels take a contiguous f32 bias")
    if labels.dtype != torch.int64:
        raise TypeError(f"fused CE labels must be int64, got {labels.dtype}")
    G, c, V = logits.shape
    if logits.stride(1) != V:
        raise ValueError("fused CE logits rows must be contiguous")
    for t in (labels, *rows):
        if tuple(t.shape[:2]) != (G, c):
            raise ValueError(f"fused CE row operand {tuple(t.shape)} does "
                             f"not match logits {tuple(logits.shape)}")
    for t in (logits, labels, *rows):
        # group strides are passed to the kernels; the last axis is dense
        if t.stride(-1) != 1:
            raise ValueError(f"fused CE kernels need a contiguous last axis, "
                             f"got strides {t.stride()}")
    if G > 65535:
        raise ValueError(f"fused CE kernels take at most 65535 groups, "
                         f"got {G}")
    return G, c, V


def _vec(V, *ts):
    """The kernels' four-element path: ``V % 4 == 0`` and each tensor
    aligned to four of its elements, with a group stride that keeps it
    so."""
    return V % 4 == 0 and all(
        t is None or (t.data_ptr() % (4 * t.element_size()) == 0
                      and (t.dim() < 3 or t.stride(0) % 4 == 0))
        for t in ts)


def ce_fwd_rows(logits, bias, labels, lse, nll):
    """Per-row log-sum-exp and nll of one chunk, written into ``lse`` and
    ``nll`` (f32 ``[G, c]``, views of the ``[G, N]`` outputs): logits f32
    ``[G, c, V]``, bias f32 ``[G, V]`` or None, labels int64 ``[G, c]``.
    One launch of ``ce_fwd_rows`` on CUDA tensors (or raise), the plain
    version on CPU tensors. ``launches`` counts kernel launches."""
    dev = logits.device
    if dev.type == "cpu":
        lse_c, nll_c = _rows_fwd_plain(logits, bias, labels)
        lse.copy_(lse_c)
        nll.copy_(nll_c)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused CE runs on cpu or cuda tensors, got {dev}")
    G, c, V = _check(logits, bias, labels, lse, nll)
    if lse.stride(0) != nll.stride(0):
        raise ValueError("fused CE lse and nll must share a layout")
    lib = _build.load("fused_ce", _bind)
    err = lib.dk_ce_fwd_rows(
        logits.data_ptr(), logits.stride(0), _ptr(bias), labels.data_ptr(),
        labels.stride(0), lse.data_ptr(), nll.data_ptr(), lse.stride(0), G,
        c, V, int(_vec(V, logits, bias)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ce_fwd_rows")
    _build.count_launch(ce_fwd_rows)


ce_fwd_rows.launches = 0


def bwd_splits(groups, vocab, rows, sms, cols):
    """Row splits S of one ``ce_bwd_rows`` launch over ``cols``-column
    tiles: enough blocks (tiles × groups × S) for four a multiprocessor,
    each split at least 64 rows."""
    tiles = -(-vocab // cols)
    want = -(-4 * sms // (tiles * groups))
    return max(1, min(want, rows // 64, 65535))


def bwd_tickets(groups, vocab, device):
    """The zeroed ticket counters that ``ce_bwd_rows`` launches of one
    backward share (each launch leaves them 0), or None on the CPU."""
    if device.type != "cuda":
        return None
    lib = _build.load("fused_ce", _bind)
    tiles = -(-vocab // lib.dk_ce_bwd_cols())
    return torch.zeros((groups * tiles,), dtype=torch.int32, device=device)


def ce_bwd_rows(logits, bias, labels, lse, mask, scale, dlogits, db,
                tickets):
    """One chunk's ``dlogits`` (written into the ``[G, c, V]`` view
    ``dlogits``, in its dtype) and ``db += Σ_rows dlogits`` in f32 (``db``
    f32 ``[G, V]``), from the forward's ``lse`` and the row weights ``mask
    · scale`` (mask f32 ``[G, c]``, scale f32 ``[G]``); ``tickets`` from
    :func:`bwd_tickets`. Dispatch and ``launches`` as
    :func:`ce_fwd_rows`."""
    dev = logits.device
    if dev.type == "cpu":
        d, col = _rows_bwd_plain(logits, bias, labels, lse, mask, scale,
                                 dlogits.dtype)
        dlogits.copy_(d)
        db.add_(col)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused CE runs on cpu or cuda tensors, got {dev}")
    G, c, V = _check(logits, bias, labels, lse, mask, dlogits)
    if dlogits.dtype not in _OUT_CODE:
        raise TypeError(f"fused CE dlogits must be float32, bfloat16 or "
                        f"float16, got {dlogits.dtype}")
    if dlogits.stride(1) != V:
        raise ValueError("fused CE dlogits rows must be contiguous")
    if (db.dtype != torch.float32 or tuple(db.shape) != (G, V)
            or not db.is_contiguous() or scale.dtype != torch.float32
            or tuple(scale.shape) != (G,) or not scale.is_contiguous()):
        raise ValueError("fused CE db must be contiguous f32 [G, V] and "
                         "scale contiguous f32 [G]")
    lib = _build.load("fused_ce", _bind)
    splits = bwd_splits(G, V, c, torch.cuda.get_device_properties(dev)
                        .multi_processor_count, lib.dk_ce_bwd_cols())
    partial = None
    if splits > 1:
        partial = torch.empty((splits, G, V), dtype=torch.float32, device=dev)
        tiles = -(-V // lib.dk_ce_bwd_cols())
        if (tickets is None or tickets.dtype != torch.int32
                or tickets.numel() < G * tiles or tickets.device != dev):
            raise ValueError("fused CE tickets must come from bwd_tickets "
                             "for these groups and this vocabulary")
    err = lib.dk_ce_bwd_rows(
        logits.data_ptr(), logits.stride(0), _ptr(bias), labels.data_ptr(),
        labels.stride(0), lse.data_ptr(), lse.stride(0), mask.data_ptr(),
        mask.stride(0), scale.data_ptr(), dlogits.data_ptr(),
        dlogits.stride(0), _OUT_CODE[dlogits.dtype], db.data_ptr(),
        _ptr(partial), _ptr(tickets), G, c, V, splits,
        int(_vec(V, logits, bias, dlogits)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ce_bwd_rows")
    _build.count_launch(ce_bwd_rows)


ce_bwd_rows.launches = 0


def _fused_ce_grad(hidden, kernel, bias, labels, mask, total, msum, lse,
                   nll, g, chunk):
    """(dh, dkernel, dbias, dmask) of :class:`_FusedCE` for the loss
    cotangent ``g`` ``[G]``, from its saved per-row ``lse`` and ``nll``;
    dbias is summed whether or not there is a bias."""
    G, N, D = hidden.shape
    V = kernel.shape[2]
    denom = torch.clamp(msum, min=1.0)
    scale = (g / denom).to(torch.float32).contiguous()
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    kernel_t = kernel.transpose(1, 2)
    dev = hidden.device
    dk = torch.zeros(kernel.shape, dtype=torch.float32, device=dev)
    db = torch.zeros((G, V), dtype=torch.float32, device=dev)
    dh = torch.empty((G, N, D), dtype=hidden.dtype, device=dev)
    step = min(_PAIR * chunk, N)
    dl = torch.empty((G, step, V), dtype=hidden.dtype, device=dev)
    tickets = bwd_tickets(G, V, dev)
    for i in range(0, N, step):
        n = min(step, N - i)
        for j in range(i, i + n, chunk):
            c = min(chunk, i + n - j)
            ce_bwd_rows(_mm_f32(hidden[:, j:j + c], kernel), bias32,
                        labels[:, j:j + c], lse[:, j:j + c],
                        mask[:, j:j + c], scale, dl[:, j - i:j - i + c], db,
                        tickets)
        # dh rounded once to the hidden dtype, dk summed in f32
        dh[:, i:i + n] = _mm_f32(dl[:, :n], kernel_t)
        _mm_f32_acc(dk, hidden[:, i:i + n].transpose(1, 2), dl[:, :n])
    # loss = T/D with T = Σ nll_i·m_i, D = max(Σm, 1):
    # ∂loss/∂m_i = nll_i/D − T·[Σm > 1]/D² (the unfused masked mean's)
    ddenom = (msum > 1.0).to(torch.float32)
    dmask = g[:, None] * (nll / denom[:, None]
                          - (total * ddenom / denom ** 2)[:, None])
    db = db.to(torch.float32 if bias is None else bias.dtype)
    return dh, dk.to(kernel.dtype), db, dmask.to(mask.dtype)


def _fold_all(info, in_dims, args):
    n = info.batch_size
    return [x if d is None and not isinstance(x, torch.Tensor)
            else _fold(x, d, n) for x, d in zip(args, in_dims)]


class _FusedCEGrad(torch.autograd.Function):
    """The backward as a Function, so that under ``torch.func.vmap(grad)``
    its ``vmap`` rule, not a per-worker fallback, batches the products
    (its own backward, a second derivative, is not provided)."""

    @staticmethod
    def forward(hidden, kernel, bias, labels, mask, total, msum, lse, nll,
                g, chunk):
        return _fused_ce_grad(hidden, kernel, bias, labels, mask, total,
                              msum, lse, nll, g, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the fused cross-entropy has no second "
                                  "derivative")

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _FusedCEGrad.apply(*_fold_all(info, in_dims, args))
        return tuple(_unfold(o, info.batch_size) for o in outs), (0, 0, 0, 0)


class _FusedCE(torch.autograd.Function):
    """The loss over a leading group axis G: hidden ``[G, N, D]``, kernel
    ``[G, D, V]``, bias ``[G, V]`` or None, labels and mask ``[G, N]`` →
    (loss, total, msum), each ``[G]``, and the per-row lse and nll ``[G,
    N]`` that the backward reads (not differentiable)."""

    @staticmethod
    def forward(hidden, kernel, bias, labels, mask, chunk):
        with _trace.span("fused_ce.forward"):
            G, N = hidden.shape[:2]
            lse = hidden.new_empty((G, N), dtype=torch.float32)
            nll = hidden.new_empty((G, N), dtype=torch.float32)
            bias32 = (None if bias is None
                      else bias.to(torch.float32).contiguous())
            for i in range(0, N, chunk):
                ce_fwd_rows(_mm_f32(hidden[:, i:i + chunk], kernel), bias32,
                            labels[:, i:i + chunk], lse[:, i:i + chunk],
                            nll[:, i:i + chunk])
            total = torch.sum(nll * mask, dim=1)
            msum = torch.sum(mask, dim=1)
            return total / torch.clamp(msum, min=1.0), total, msum, lse, nll

    @staticmethod
    def setup_context(ctx, inputs, output):
        hidden, kernel, bias, labels, mask, chunk = inputs
        _, total, msum, lse, nll = output
        ctx.mark_non_differentiable(total, msum, lse, nll)
        ctx.save_for_backward(hidden, kernel, bias, labels, mask, total, msum,
                              lse, nll)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, g, _dtotal, _dmsum, _dlse, _dnll):
        (hidden, kernel, bias, labels, mask, total, msum, lse,
         nll) = ctx.saved_tensors
        with _trace.span("fused_ce.backward"):
            dh, dk, db, dmask = _FusedCEGrad.apply(
                hidden, kernel, bias, labels, mask, total, msum, lse, nll, g,
                ctx.chunk)
        return (dh, dk, None if bias is None else db, None, dmask, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _FusedCE.apply(*_fold_all(info, in_dims, args))
        return (tuple(_unfold(o, info.batch_size) for o in outs),
                (0, 0, 0, 0, 0))


def chunked_softmax_cross_entropy(hidden, labels, kernel, bias=None, *,
                                  mask=None, chunk: int = 256):
    """Mean sparse softmax cross-entropy of ``hidden @ kernel (+ bias)``
    against integer ``labels``, ``chunk`` rows at a time.

    Equal to ``sparse_softmax_cross_entropy(labels, logits)`` (or its
    masked form when ``mask`` is given) with the logits in f32, but the full
    ``[N, V]`` logits tensor exists in neither pass.

    Args:
      hidden: ``[N, D]`` final hidden states (callers flatten ``[B, L, D]``).
      labels: ``[N]`` integer class ids.
      kernel: ``[D, V]`` head weight, in ``hidden``'s dtype.
      bias: optional ``[V]`` head bias (any float dtype; added in f32).
      mask: optional ``[N]`` validity weights; the loss is
        ``sum(nll · mask) / max(sum(mask), 1)``. Default: all rows valid.
      chunk: rows per step — peak logits memory is ``chunk × V`` f32.
    """
    if hidden.dim() != 2:
        raise ValueError(f"hidden must be [rows, dim], got "
                         f"{tuple(hidden.shape)}")
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n = hidden.shape[0]
    labels = labels.to(torch.int64).reshape(n).contiguous()
    if mask is None:
        mask = torch.ones((n,), dtype=torch.float32, device=hidden.device)
    else:
        mask = mask.to(torch.float32).reshape(n).contiguous()
    loss = _FusedCE.apply(
        hidden[None], kernel[None], None if bias is None else bias[None],
        labels[None], mask[None], int(chunk))[0]
    return loss[0]
