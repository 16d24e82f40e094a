"""Chunked fused linear + softmax cross-entropy: large-vocab LM training
without the ``[N, V]`` logits tensor.

Port of ``distkeras_tpu/ops/fused_ce.py``. The loss needs three reductions
of the logits — the per-row log-sum-exp, the picked label logit and, in the
backward, the softmax row — so both passes walk the rows ``chunk`` at a
time: each chunk's ``[chunk, V]`` logits live for one loop step, and the
backward recomputes them from the saved ``hidden`` (FLOPs for memory, as
the flash backward does) and accumulates ``d_kernel`` in f32. Peak extra
memory is ``O(chunk · V)`` plus one f32 kernel-shaped accumulator.

The JAX package computes this in XLA, not in Pallas, so there is no kernel
here: the chunk products are cuBLAS products. As in the JAX op
(``preferred_element_type=float32``), each product takes its operands in
the hidden dtype and returns f32: a chunk's logits are never rounded to
bf16 before the f32 softmax math, and ``d_kernel`` is summed from f32
products. ``dh`` is the f32 product rounded once to the hidden dtype. On
CUDA that is one bf16 × bf16 → f32 product (``torch.bmm(...,
out_dtype=torch.float32)``); on the CPU, the same product of f32 upcasts.

:func:`chunked_softmax_cross_entropy` is a ``torch.autograd.Function`` over
a leading group axis. It and its backward (a second Function) have
``vmap`` rules that fold a vmapped worker axis into that axis, so the
training engine's ``torch.func.vmap(grad)`` over stacked workers runs one
batched product per chunk for all workers in both passes (the f32-output
product has no batching rule of its own, and would fall back to a loop
over workers).

With ``observability.trace`` on, the forward records ``fused_ce.forward``
and the backward ``fused_ce.backward`` (on the thread autograd runs it
on), around the chunks' products and their f32 work.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.utils import fold_vmapped as _fold
from distkeras_tpu_torch.utils import unfold_vmapped as _unfold


def _mm_f32(a, b):
    """``[G, m, k] @ [G, k, n]`` in the operands' dtype, f32 out."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def _chunk_logits(h_c, kernel, bias):
    """One chunk's logits in f32: ``[G, chunk, D] @ [G, D, V] (+ bias)``."""
    logits = _mm_f32(h_c, kernel)
    if bias is not None:
        logits = logits + bias.to(torch.float32)[:, None, :]
    return logits


def _nll(logits, lab):
    """Per-row ``lse - picked`` of one chunk, ``[G, chunk]``."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lab[..., None])[..., 0]
    return lse - picked


def _fused_ce_grad(hidden, kernel, bias, labels, mask, total, msum, g,
                   chunk):
    """(dh, dkernel, dbias, dmask) of :class:`_FusedCE` for the loss
    cotangent ``g`` ``[G]``; dbias is summed whether or not there is a
    bias."""
    V = kernel.shape[2]
    denom = torch.clamp(msum, min=1.0)
    scale = g / denom
    classes = torch.arange(V, device=hidden.device)
    kernel_t = kernel.transpose(1, 2)
    dk = torch.zeros(kernel.shape, dtype=torch.float32, device=kernel.device)
    db = torch.zeros((kernel.shape[0], V), dtype=torch.float32,
                     device=kernel.device)
    dhs, nlls = [], []
    for i in range(0, hidden.shape[1], chunk):
        h_c, lab_c = hidden[:, i:i + chunk], labels[:, i:i + chunk]
        logits = _chunk_logits(h_c, kernel, bias)
        nlls.append(_nll(logits, lab_c))
        onehot = (classes == lab_c[..., None]).to(torch.float32)
        dlogits = (torch.softmax(logits, dim=-1) - onehot) \
            * (mask[:, i:i + chunk] * scale[:, None])[..., None]
        # dh rounded once to the hidden dtype, dk summed in f32
        dl = dlogits.to(hidden.dtype)
        dhs.append(_mm_f32(dl, kernel_t).to(hidden.dtype))
        dk = dk + _mm_f32(h_c.transpose(1, 2), dl)
        db = db + torch.sum(dlogits, dim=1)
    dh = torch.cat(dhs, dim=1)
    nll = torch.cat(nlls, dim=1)
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
    def forward(hidden, kernel, bias, labels, mask, total, msum, g, chunk):
        return _fused_ce_grad(hidden, kernel, bias, labels, mask, total,
                              msum, g, chunk)

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
    (loss, total, msum), each ``[G]``."""

    @staticmethod
    def forward(hidden, kernel, bias, labels, mask, chunk):
        with _trace.span("fused_ce.forward"):
            total = hidden.new_zeros((hidden.shape[0],), dtype=torch.float32)
            for i in range(0, hidden.shape[1], chunk):
                logits = _chunk_logits(hidden[:, i:i + chunk], kernel, bias)
                total = total + torch.sum(
                    _nll(logits, labels[:, i:i + chunk])
                    * mask[:, i:i + chunk], dim=1)
            msum = torch.sum(mask, dim=1)
            return total / torch.clamp(msum, min=1.0), total, msum

    @staticmethod
    def setup_context(ctx, inputs, output):
        hidden, kernel, bias, labels, mask, chunk = inputs
        _, total, msum = output
        ctx.mark_non_differentiable(total, msum)
        ctx.save_for_backward(hidden, kernel, bias, labels, mask, total, msum)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, g, _dtotal, _dmsum):
        hidden, kernel, bias, labels, mask, total, msum = ctx.saved_tensors
        with _trace.span("fused_ce.backward"):
            dh, dk, db, dmask = _FusedCEGrad.apply(
                hidden, kernel, bias, labels, mask, total, msum, g,
                ctx.chunk)
        return (dh, dk, None if bias is None else db, None, dmask, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _FusedCE.apply(*_fold_all(info, in_dims, args))
        return tuple(_unfold(o, info.batch_size) for o in outs), (0, 0, 0)


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
    labels = labels.to(torch.int64).reshape(n)
    if mask is None:
        mask = torch.ones((n,), dtype=torch.float32, device=hidden.device)
    else:
        mask = mask.to(torch.float32).reshape(n)
    loss, _, _ = _FusedCE.apply(
        hidden[None], kernel[None], None if bias is None else bias[None],
        labels[None], mask[None], int(chunk))
    return loss[0]
