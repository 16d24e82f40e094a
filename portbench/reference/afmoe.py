"""AFMoE (Trinity) from its equations, as the ``afmoe`` modeling code
(``AfmoeAttention``, ``AfmoeTokenChoiceRouter``, ``AfmoeMoE``,
``AfmoeDecoderLayer``) writes them:

- ``x0 = embed(ids) · sqrt(dim)``;
- each block ``h = x + RMSNorm_post_attn(attn(RMSNorm_in(x)))``, then
  ``x' = h + RMSNorm_post_mlp(ffn(RMSNorm_pre_mlp(h)))``; RMSNorm is
  ``x · rsqrt(mean(x²) + eps) · weight``;
- attention: q, k, v and the gate from the normed input without bias; an
  RMSNorm over each head's q and k; on sliding layers RoPE with
  ``rotate_half`` (feature ``i`` paired with ``i + head_dim/2``, angle
  ``p · theta^(-2i/head_dim)``) and the band ``i − j < window``; full
  layers neither; causal softmax at ``head_dim^-0.5``, query head ``h``
  reading key head ``h // (heads / kv_heads)``; then ``o_proj(attn ·
  sigmoid(gate))``;
- the first ``dense_layers`` FFNs ``down(silu(gate(x)) · up(x))``; the
  others ``shared(x) + Σ_j w_j · expert_{idx_j}(x)`` over the picks whose
  expert is held here (``experts_held`` of ``experts``, ids
  ``first_expert …``): ``s = sigmoid(x · routerᵀ)``, ``idx = top_k(s +
  expert_bias)`` with ``expert_bias`` 0 (the value the trainers hold; the
  balancing that moves it is not trained here), ``w = s[idx] / (Σ s[idx]
  + 1e-20) · route_scale``; every expert a SwiGLU without bias, computed
  by a loop over the held experts on exactly the tokens routed to each;
- a final RMSNorm, the untied head without bias, the mean softmax
  cross-entropy over every token.

Attention runs in blocks of queries over the keys they may see, each
recomputed in the backward pass (``torch.utils.checkpoint``). Parameters
carry the port's names and ``[out, in]`` matrices: ``attn.qkvg`` is q | k
| v | gate in one matrix, an FFN's ``gate_up`` gate rows then up rows, the
held experts ``experts_gate_up [E, 2F, d]`` and ``experts_down [E, d,
F]``. Everything is f32 unless the precision says fp8, every matrix product
through ``mm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: bytes of f32 scores one attention block may hold
SCORE_BYTES = 1 << 30


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def _rope_half(x, theta):
    """x ``[B, L, H, D]`` rotated, feature ``i`` with ``i + D/2``."""
    L, D = x.shape[1], x.shape[3]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = (torch.arange(L, dtype=torch.float64, device=x.device)[:, None]
           * inv[None]).to(x.dtype)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, start: int, key0: int, window, scale: float, mm):
    """Queries ``start …`` of ``q [B, H, n, D]`` against keys ``key0 …``
    up to their last (``k, v [B, H, ·, D]``), causal and banded."""
    s = mm(q, k.transpose(-1, -2)) * scale
    qp = start + torch.arange(q.shape[2], device=q.device)[:, None]
    kp = key0 + torch.arange(k.shape[2], device=q.device)[None]
    bad = kp > qp
    if window is not None:
        bad = bad | (qp - kp >= window)
    return mm(torch.softmax(s.masked_fill(bad, float("-inf")), dim=-1), v)


def attention(q, k, v, window, mm):
    """``q [B, L, H, D]``, ``k, v [B, L, Hkv, D]`` → ``[B, L, H, D]``."""
    B, L, H, D = q.shape
    group = H // k.shape[2]
    q = q.transpose(1, 2)
    k, v = (t.repeat_interleave(group, dim=2).transpose(1, 2) for t in (k, v))
    block = max(128, min(L, SCORE_BYTES // (4 * B * H * L)))
    outs = []
    for s in range(0, L, block):
        e = min(L, s + block)
        k0 = 0 if window is None else max(0, s - window + 1)
        outs.append(checkpoint(_attend, q[:, :, s:e], k[:, :, k0:e],
                               v[:, :, k0:e], s, k0, window, D ** -0.5, mm,
                               use_reentrant=False))
    return torch.cat(outs, dim=2).transpose(1, 2)


def _swiglu(x, gate_up, down, mm):
    g, u = mm(x, gate_up.t()).chunk(2, dim=-1)
    return mm(F.silu(g) * u, down.t())


def moe(x, p, b: str, kw: dict, mm):
    """The shared expert plus the held experts' share, ``x [T, d]``
    (``expert_bias`` 0 unless ``p`` carries one)."""
    s = torch.sigmoid(mm(x, p[b + "router"].t()))
    bias = p.get(b + "expert_bias")
    idx = torch.topk(s if bias is None else s + bias, int(kw["top_k"]),
                     dim=-1).indices
    w = torch.gather(s, -1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * float(kw["route_scale"])
    y = _swiglu(x, p[b + "shared.gate_up.weight"], p[b + "shared.down.weight"],
                mm)
    first = int(kw.get("first_expert", 0))
    for e in range(p[b + "experts_gate_up"].shape[0]):
        tok, j = torch.nonzero(idx == first + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = _swiglu(x[tok], p[b + "experts_gate_up"][e],
                     p[b + "experts_down"][e], mm)
        y = y.index_add(0, tok, ye * w[tok, j][:, None])
    return y


def layer_types(kw: dict) -> list:
    depth = int(kw["depth"])
    return list(kw.get("layer_types") or [
        "full_attention" if (i + 1) % 4 == 0 else "sliding_attention"
        for i in range(depth)])


def logits(p: dict, tokens, config: dict, mm):
    """Next-token logits ``[B, L, vocab]`` of a batch ``[B, L]``."""
    kw = config["kwargs"]
    d, H, Hkv = int(kw["dim"]), int(kw["heads"]), int(kw["kv_heads"])
    D, eps = int(kw["head_dim"]), float(kw.get("rms_eps", 1e-5))
    theta = float(kw.get("rope_theta", 10000.0))
    B, L = tokens.shape
    x = p["embed.weight"][tokens.long()] * d ** 0.5
    for i, kind in enumerate(layer_types(kw)):
        b = f"blocks.{i}."
        sliding = kind == "sliding_attention"
        h = mm(_rms(x, p[b + "in_norm.weight"], eps),
               p[b + "attn.qkvg.weight"].t())
        q, k, v, gate = h.split([H * D, Hkv * D, Hkv * D, H * D], dim=-1)
        q = _rms(q.reshape(B, L, H, D), p[b + "attn.q_norm.weight"], eps)
        k = _rms(k.reshape(B, L, Hkv, D), p[b + "attn.k_norm.weight"], eps)
        v = v.reshape(B, L, Hkv, D)
        if sliding:
            q, k = _rope_half(q, theta), _rope_half(k, theta)
        att = attention(q, k, v, int(kw["window"]) if sliding else None, mm)
        o = mm(att.reshape(B, L, H * D) * torch.sigmoid(gate),
               p[b + "attn.o_proj.weight"].t())
        x = x + _rms(o, p[b + "post_attn_norm.weight"], eps)
        hn = _rms(x, p[b + "pre_mlp_norm.weight"], eps)
        if i < int(kw["dense_layers"]):
            f = _swiglu(hn, p[b + "ffn.gate_up.weight"],
                        p[b + "ffn.down.weight"], mm)
        else:
            f = moe(hn.reshape(B * L, d), p, b + "ffn.", kw,
                    mm).reshape(B, L, d)
        x = x + _rms(f, p[b + "post_mlp_norm.weight"], eps)
    return mm(_rms(x, p["norm.weight"], eps), p["lm_head.weight"].t())


def loss(p: dict, tokens, labels, config: dict, mm):
    """Mean next-token cross-entropy of one batch ``[B, L]``."""
    out = logits(p, tokens, config, mm)
    return F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           labels.reshape(-1).long())


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
        # a layer whose held experts got no token leaves them unused
        for n, g in zip(pw, torch.autograd.grad(lw, list(pw.values()),
                                                allow_unused=True)):
            grads[n][w] = 0.0 if g is None else g
        losses.append(lw.detach())
    return torch.stack(losses), grads
