"""The causal LM from its equations: token embedding; ``depth`` pre-norm
blocks, each ``x + attn_out(attention(rope(q), rope(k), v))`` over
``LayerNorm(x)`` and ``x + mlp_down(gelu_tanh(mlp_up(LayerNorm(x))))``;
a final LayerNorm and the head; the mean softmax cross-entropy over every
token.

- LayerNorm: epsilon 1e-6, a scale and a bias.
- The q | k | v projection is one matrix, split in that order into
  ``heads`` heads of ``dim / heads``.
- RoPE rotates the interleaved feature pairs ``(x[2i], x[2i+1])`` of q and
  k at position ``p`` by ``p · 10000^(-2i / head_dim)``.
- Attention is causal with scale ``head_dim^-0.5``. It runs in blocks of
  queries, each recomputed in the backward pass
  (``torch.utils.checkpoint``), so that no ``[L, L]`` score matrix of a
  whole layer is kept: the same products, less memory.

Parameters carry the port's names (``blocks.<i>.qkv.weight``, …) and
``[out, in]`` matrices. Everything is f32 unless the precision says fp8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6
ROPE_BASE = 10000.0
#: bytes of f32 scores one attention block may hold
SCORE_BYTES = 1 << 30


def _linear(x, p, name, mm):
    return mm(x, p[name + ".weight"].t()) + p[name + ".bias"]


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"],
                        p[name + ".bias"], LN_EPS)


def _rope(x):
    """x ``[B, L, H, Dh]`` with its interleaved pairs rotated."""
    L, Dh = x.shape[1], x.shape[3]
    inv = ROPE_BASE ** (-torch.arange(0, Dh, 2, dtype=torch.float64,
                                      device=x.device) / Dh)
    ang = (torch.arange(L, dtype=torch.float64, device=x.device)[:, None]
           * inv[None]).to(x.dtype)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def _attend(q, k, v, start: int, scale: float, mm):
    """Queries ``start …`` of ``q [B, H, n, Dh]`` against the keys up to
    their last, ``k, v [B, H, start + n, Dh]``."""
    s = mm(q, k.transpose(-1, -2)) * scale
    qp = start + torch.arange(q.shape[2], device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None]
    s = s.masked_fill(kp > qp, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def causal_attention(q, k, v, mm):
    """``[B, L, H, Dh]`` in and out."""
    B, L, H, Dh = q.shape
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    block = max(128, min(L, SCORE_BYTES // (4 * B * H * L)))
    outs = []
    for s in range(0, L, block):
        e = min(L, s + block)
        outs.append(checkpoint(_attend, q[:, :, s:e], k[:, :, :e],
                               v[:, :, :e], s, Dh ** -0.5, mm,
                               use_reentrant=False))
    return torch.cat(outs, dim=2).transpose(1, 2)


def loss(p: dict, tokens, labels, config: dict, mm):
    """Mean next-token cross-entropy of one batch ``[B, L]``."""
    kw = config["kwargs"]
    dim, heads, depth = int(kw["dim"]), int(kw["heads"]), int(kw["depth"])
    B, L = tokens.shape
    x = p["embed.weight"][tokens.long()]
    for i in range(depth):
        b = f"blocks.{i}."
        qkv = _linear(_ln(x, p, b + "ln_attn"), p, b + "qkv", mm)
        q, k, v = (t.reshape(B, L, heads, dim // heads)
                   for t in qkv.split(dim, dim=-1))
        att = causal_attention(_rope(q), _rope(k), v, mm)
        x = x + _linear(att.reshape(B, L, dim), p, b + "attn_out", mm)
        h = _linear(_ln(x, p, b + "ln_mlp"), p, b + "mlp_up", mm)
        x = x + _linear(F.gelu(h, approximate="tanh"), p, b + "mlp_down", mm)
    logits = _linear(_ln(x, p, "ln_head"), p, "lm_head", mm)
    return F.cross_entropy(logits.reshape(B * L, -1),
                           labels.reshape(B * L).long())


def loss_and_grads(params: dict, columns: tuple, config: dict, mm):
    """Each worker's loss and gradient: ``params`` stacked ``[W, …]``,
    ``columns`` ``(tokens, labels)`` each ``[W, B, L]`` → ``(losses [W],
    grads stacked [W, …])``. Workers run one after another."""
    tokens, labels = columns
    grads = {n: torch.empty_like(v) for n, v in params.items()}
    losses = []
    for w in range(tokens.shape[0]):
        pw = {n: v[w].detach().requires_grad_(True)
              for n, v in params.items()}
        lw = loss(pw, tokens[w], labels[w], config, mm)
        for n, g in zip(pw, torch.autograd.grad(lw, list(pw.values()))):
            grads[n][w] = g
        losses.append(lw.detach())
    return torch.stack(losses), grads
