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
here: the chunk products are ``torch.matmul`` in the hidden dtype. A bf16
product rounds its logits to bf16 before the f32 softmax math (as the
unfused head does); the JAX op keeps them f32 (``preferred_element_type``).
In f32 the two are the same computation.

:func:`chunked_softmax_cross_entropy` is a ``torch.autograd.Function`` with
``generate_vmap_rule=True``, so the training engine's ``torch.func.vmap``
over stacked workers batches every chunk product.
"""

from __future__ import annotations

import torch


def _chunk_logits(h_c, kernel, bias):
    """One chunk's logits in f32: ``[chunk, D] @ [D, V] (+ bias)``."""
    logits = torch.matmul(h_c, kernel).to(torch.float32)
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    return logits


def _nll(logits, lab):
    """Per-row ``lse - picked`` of one chunk."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lab[:, None])[:, 0]
    return lse - picked


class _FusedCE(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(hidden, kernel, bias, labels, mask, chunk):
        total = hidden.new_zeros((), dtype=torch.float32)
        for i in range(0, hidden.shape[0], chunk):
            logits = _chunk_logits(hidden[i:i + chunk], kernel, bias)
            total = total + torch.sum(_nll(logits, labels[i:i + chunk])
                                      * mask[i:i + chunk])
        msum = torch.sum(mask)
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
        chunk = ctx.chunk
        V = kernel.shape[1]
        denom = torch.clamp(msum, min=1.0)
        scale = g / denom
        classes = torch.arange(V, device=hidden.device)
        dk = torch.zeros(kernel.shape, dtype=torch.float32,
                         device=kernel.device)
        db = None if bias is None else torch.zeros(
            (V,), dtype=torch.float32, device=kernel.device)
        dhs, nlls = [], []
        for i in range(0, hidden.shape[0], chunk):
            h_c, lab_c = hidden[i:i + chunk], labels[i:i + chunk]
            logits = _chunk_logits(h_c, kernel, bias)
            nlls.append(_nll(logits, lab_c))
            onehot = (classes == lab_c[:, None]).to(torch.float32)
            dlogits = (torch.softmax(logits, dim=-1) - onehot) \
                * (mask[i:i + chunk] * scale)[:, None]
            # dh in the hidden dtype, dk accumulated in f32
            dl = dlogits.to(hidden.dtype)
            dhs.append(torch.matmul(dl, kernel.transpose(0, 1))
                       .to(hidden.dtype))
            dk = dk + torch.matmul(h_c.transpose(0, 1), dl).to(torch.float32)
            if db is not None:
                db = db + torch.sum(dlogits, dim=0)
        dh = torch.cat(dhs)
        nll = torch.cat(nlls)
        # loss = T/D with T = Σ nll_i·m_i, D = max(Σm, 1):
        # ∂loss/∂m_i = nll_i/D − T·[Σm > 1]/D² (the unfused masked mean's)
        ddenom = (msum > 1.0).to(torch.float32)
        dmask = g * (nll / denom - total * ddenom / denom ** 2)
        dbias = None if bias is None else db.to(bias.dtype)
        return (dh, dk.to(kernel.dtype), dbias, None, dmask.to(mask.dtype),
                None)


def chunked_softmax_cross_entropy(hidden, labels, kernel, bias=None, *,
                                  mask=None, chunk: int = 256):
    """Mean sparse softmax cross-entropy of ``hidden @ kernel (+ bias)``
    against integer ``labels``, ``chunk`` rows at a time.

    Equal to ``sparse_softmax_cross_entropy(labels, logits)`` (or its
    masked form when ``mask`` is given), but the full ``[N, V]`` logits
    tensor exists in neither pass.

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
    loss, _, _ = _FusedCE.apply(hidden, kernel, bias, labels, mask,
                                int(chunk))
    return loss
