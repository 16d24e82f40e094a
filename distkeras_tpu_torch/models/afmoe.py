"""AFMoE (Arcee's Trinity family): a causal LM of sliding-window and full
attention layers with gated GQA, QK-norm and sandwich norms, dense SwiGLU
layers first and dropless sigmoid-routed experts after, trained through the
port's trainers.

The block, as the ``afmoe`` modeling code writes it
(``AfmoeAttention``, ``AfmoeTokenChoiceRouter``, ``AfmoeMoE``,
``AfmoeDecoderLayer``):

- embedding ``x0 = embed(ids) · sqrt(dim)`` (muP);
- ``h = x + post_attn_norm(attn(in_norm(x)))``, then ``x' = h +
  post_mlp_norm(ffn(pre_mlp_norm(h)))``, every norm an RMSNorm;
- attention: q, k, v without bias, RMSNorm over each head's q and k,
  RoPE (half-split pairs, ``rotate_half``) on the sliding layers only, the
  full layers NoPE; causal softmax at ``head_dim^-0.5``, the sliding
  layers banded to ``i − j < window``; the heads gated, ``o_proj(attn ·
  sigmoid(gate_proj(x)))`` over the normed input;
- the first ``dense_layers`` FFNs a SwiGLU ``down(silu(gate(x)) ·
  up(x))``, the rest ``shared(x) + Σ_j w_j · expert_{idx_j}(x)`` with
  sigmoid routing (``parallel.expert.route_sigmoid_topk``: top-k over
  the scores plus ``expert_bias``, the picked scores normalised and
  scaled by ``route_scale``), each expert a SwiGLU without bias;
- a final RMSNorm and an untied head without bias.

Of the routed experts this module holds ``experts_held`` (ids
``first_expert …``): the router scores all ``experts`` and the layer adds
the held experts' share (``parallel.expert.held_experts``), as one chip of
an expert-parallel group computes it. ``expert_bias`` is a buffer (the
trainers' non-trainable state) at 0: the auxiliary-loss-free balancing
that updates it between steps is not part of this module.

The numerics follow :mod:`models.lm`: f32 master parameters, products in
``dtype`` (:class:`~distkeras_tpu_torch.models.lm.Dense`), the residual
stream, the norms, RoPE, the gate and the router in f32, the attention
through ``ops.flash_attention`` (the kernels on the card). With
``observability.trace`` on, the forward records ``lm.embed``, ``lm.attn``
and ``lm.mlp`` (each block's halves) and ``lm.head``, and the expert
layer its ``moe.*`` spans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module, per_thread
from distkeras_tpu_torch.models.layers import remat_block
from distkeras_tpu_torch.models.lm import Dense, fused_ce_loss
from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.ops.flash_attention import attention
from distkeras_tpu_torch.parallel.expert import (
    held_experts,
    route_sigmoid_topk,
)
from distkeras_tpu_torch.parallel.tensor import embed_lookup
from distkeras_tpu_torch.utils import resolve_device

SLIDING, FULL = "sliding_attention", "full_attention"


class RMSNorm(nn.Module):
    """``x · rsqrt(mean(x²) + eps) · weight`` over the last axis, in f32."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                              device=device))

    def forward(self, x):
        x = x.to(torch.float32)
        return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True)
                               + self.eps) * self.weight


def rope_half(x, cos, sin):
    """Rotate ``x [B, L, H, D]`` by ``cos``/``sin [L, D/2]`` pairing feature
    ``i`` with ``i + D/2`` (``rotate_half``), in f32."""
    f = x.to(torch.float32)
    x1, x2 = f.chunk(2, dim=-1)
    cos, sin = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _swiglu(dense_up, dense_down, x, dtype):
    """``down(silu(gate(x)) · up(x))`` with gate|up one product."""
    h = dense_up(x.to(dtype))
    g, u = h.to(torch.float32).chunk(2, dim=-1)
    return dense_down((F.silu(g) * u).to(dtype)).to(torch.float32)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, width: int, dtype, device, param_dtype):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype,
                  bias=False)
        self.dtype = dtype
        self.gate_up = Dense(dim, 2 * width, **kw)
        self.down = Dense(width, dim, **kw)

    def forward(self, x):
        return _swiglu(self.gate_up, self.down, x, self.dtype)


class MoE(nn.Module):
    """The shared expert plus the held routed experts' share."""

    def __init__(self, dim: int, width: int, experts: int, held: int,
                 first: int, top_k: int, route_scale: float, dtype, device,
                 param_dtype):
        super().__init__()
        if first < 0 or first + held > experts:
            raise ValueError(f"experts {first}..{first + held - 1} are not "
                             f"among the {experts}")
        self.dtype, self.first = dtype, int(first)
        self.top_k, self.route_scale = int(top_k), float(route_scale)
        self.router = nn.Parameter(torch.empty(
            (experts, dim), dtype=torch.float32, device=device))
        self.register_buffer("expert_bias", torch.zeros(
            experts, dtype=torch.float32, device=device))
        self.experts_gate_up = nn.Parameter(torch.empty(
            (held, 2 * width, dim), dtype=param_dtype, device=device))
        self.experts_down = nn.Parameter(torch.empty(
            (held, dim, width), dtype=param_dtype, device=device))
        self.shared = SwiGLU(dim, width, dtype, device, param_dtype)

    def forward(self, x):
        B, L, d = x.shape
        t = x.reshape(B * L, d)
        with _trace.span("moe.route"):
            idx, w = route_sigmoid_topk(t, self.router, self.expert_bias,
                                        self.top_k, self.route_scale)
        y = held_experts(t.to(self.dtype), idx, w,
                         self.experts_gate_up.to(self.dtype),
                         self.experts_down.to(self.dtype), self.first)
        return y.reshape(B, L, d) + self.shared(x)


class Attention(nn.Module):
    """Gated GQA with QK-norm; RoPE and the band on sliding layers."""

    def __init__(self, dim: int, heads: int, kv_heads: int, head_dim: int,
                 sliding: bool, window: int, eps: float, dtype, attn_impl,
                 device, param_dtype):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype,
                  bias=False)
        self.heads, self.kv_heads, self.dh = heads, kv_heads, head_dim
        self.sliding, self.window = bool(sliding), int(window)
        self.dtype, self.attn_impl = dtype, attn_impl
        # q | k | v | gate in one product
        self.qkvg = Dense(dim, (2 * heads + 2 * kv_heads) * head_dim, **kw)
        self.o_proj = Dense(heads * head_dim, dim, **kw)
        self.q_norm = RMSNorm(head_dim, eps, device)
        self.k_norm = RMSNorm(head_dim, eps, device)

    def forward(self, x, rope):
        B, L, _ = x.shape
        qd, kd = self.heads * self.dh, self.kv_heads * self.dh
        p = self.qkvg(x.to(self.dtype))
        q = self.q_norm(p[..., :qd].reshape(B, L, self.heads, self.dh))
        k = self.k_norm(p[..., qd:qd + kd].reshape(B, L, self.kv_heads,
                                                   self.dh))
        v = p[..., qd + kd:qd + 2 * kd].reshape(B, L, self.kv_heads, self.dh)
        gate = p[..., qd + 2 * kd:]
        if self.sliding:
            q, k = rope_half(q, *rope), rope_half(k, *rope)
        att = attention(q.to(self.dtype), k.to(self.dtype), v, causal=True,
                        impl=self.attn_impl,
                        window=self.window if self.sliding else None)
        att = att.reshape(B, L, qd).to(torch.float32) \
            * torch.sigmoid(gate.to(torch.float32))
        return self.o_proj(att.to(self.dtype)).to(torch.float32)


class Block(nn.Module):
    """``h = x + post_attn_norm(attn(in_norm(x)))``, ``x' = h +
    post_mlp_norm(ffn(pre_mlp_norm(h)))``."""

    def __init__(self, attn: Attention, ffn: nn.Module, dim: int, eps: float,
                 device):
        super().__init__()
        self.in_norm = RMSNorm(dim, eps, device)
        self.attn = attn
        self.post_attn_norm = RMSNorm(dim, eps, device)
        self.pre_mlp_norm = RMSNorm(dim, eps, device)
        self.ffn = ffn
        self.post_mlp_norm = RMSNorm(dim, eps, device)

    def forward(self, x, rope):
        with _trace.span("lm.attn"):
            x = x + self.post_attn_norm(self.attn(self.in_norm(x), rope))
        with _trace.span("lm.mlp"):
            return x + self.post_mlp_norm(self.ffn(self.pre_mlp_norm(x)))


def default_layer_types(depth: int, full_every: int = 4) -> list[str]:
    """Sliding layers with a full one every ``full_every``-th."""
    return [FULL if (i + 1) % full_every == 0 else SLIDING
            for i in range(depth)]


class AfmoeLM(nn.Module):
    """Token sequence → next-token logits ``[B, L, vocab]`` (f32), or the
    final normed hidden states with ``return_hidden``."""

    def __init__(self, vocab: int, maxlen: int, dim: int, heads: int,
                 kv_heads: int, head_dim: int, depth: int, layer_types=None,
                 dense_layers: int = 2, mlp_dim: int = 6144,
                 experts: int = 128, experts_held: int | None = None,
                 first_expert: int = 0, expert_dim: int = 1024,
                 top_k: int = 8, route_scale: float = 1.0,
                 window: int = 2048, rope_theta: float = 10000.0,
                 rms_eps: float = 1e-5, dtype=torch.bfloat16,
                 attn_impl: str = "flash", device="cuda", param_dtype=None,
                 remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        layer_types = list(layer_types or default_layer_types(depth))
        if len(layer_types) != depth or set(layer_types) - {SLIDING, FULL}:
            raise ValueError(f"layer_types must name {depth} layers as "
                             f"{SLIDING!r} or {FULL!r}, got {layer_types}")
        if heads % kv_heads or head_dim % 2:
            raise ValueError(f"heads {heads} must be a multiple of kv_heads "
                             f"{kv_heads}, head_dim {head_dim} even")
        param_dtype = param_dtype or dtype
        held = experts if experts_held is None else int(experts_held)
        self.vocab, self.maxlen, self.dim = vocab, maxlen, dim
        self.dtype, self.remat = dtype, bool(remat)
        self.layer_types = layer_types
        self.embed = nn.Embedding(vocab, dim, dtype=param_dtype,
                                  device=device)
        blocks = []
        for i, kind in enumerate(layer_types):
            attn = Attention(dim, heads, kv_heads, head_dim, kind == SLIDING,
                             window, rms_eps, dtype, attn_impl, device,
                             param_dtype)
            ffn = (SwiGLU(dim, mlp_dim, dtype, device, param_dtype)
                   if i < dense_layers else
                   MoE(dim, expert_dim, experts, held, first_expert, top_k,
                       route_scale, dtype, device, param_dtype))
            blocks.append(Block(attn, ffn, dim, rms_eps, device))
        self.blocks = nn.ModuleList(blocks)
        self.norm = RMSNorm(dim, rms_eps, device)
        self.lm_head = Dense(dim, vocab, dtype, device,
                             param_dtype=param_dtype, bias=False)
        inv = rope_theta ** (-np.arange(0, head_dim, 2) / head_dim)
        self.register_buffer("rope_table", torch.from_numpy(
            (np.arange(maxlen)[:, None] * inv[None, :]).astype(np.float32))
            .to(device), persistent=False)

    def reset_parameters(self, generator) -> None:
        """Every matrix (and stack of matrices) normal with std
        ``fan_in^-0.5`` (its last axis), every norm's scale 1."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.dim() == 1:
                    p.fill_(1.0)
                    continue
                w = torch.empty(p.shape, dtype=torch.float32,
                                device=p.device)
                w.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
                p.copy_(w)

    def forward(self, tokens, return_hidden: bool = False):
        with _trace.span("lm.embed"):
            x = embed_lookup(self.embed.weight, tokens).to(self.dtype) \
                .to(torch.float32) * (self.dim ** 0.5)
        ang = self.rope_table[:tokens.shape[1]]
        rope = (torch.cos(ang), torch.sin(ang))
        for blk in self.blocks:
            x = remat_block(blk, x, rope) if self.remat else blk(x, rope)
        with _trace.span("lm.head"):
            h = self.norm(x)
            if return_hidden:
                return h
            return self.lm_head(h.to(self.dtype)).to(torch.float32)


def afmoe_lm_spec(vocab=1024, maxlen=256, dim=64, heads=4, kv_heads=2,
                  head_dim=16, depth=4, layer_types=None, dense_layers=1,
                  mlp_dim=128, experts=8, experts_held=None, first_expert=0,
                  expert_dim=32, top_k=2, route_scale=1.0, window=64,
                  rope_theta=10000.0, rms_eps=1e-5, dtype=torch.bfloat16,
                  attn_impl="flash", fused_ce=True, ce_chunk=256,
                  remat=False) -> ModelSpec:
    """AFMoE training ``ModelSpec`` (:class:`AfmoeLM`) for the trainers:
    f32 master parameters, compute in ``dtype``. Train with
    ``loss="sparse_softmax_cross_entropy"`` on ``features = tokens [B,
    L]`` and ``label = next tokens [B, L]``; ``fused_ce=True`` adds the
    chunked fused cross-entropy over the hidden states and the head
    (:func:`models.lm.fused_ce_loss`). ``experts_held`` of the
    ``experts`` (ids ``first_expert …``) live here; ``expert_bias`` is
    the non-trainable state. The template module lives on the CPU."""
    module = AfmoeLM(
        vocab=vocab, maxlen=maxlen, dim=dim, heads=heads, kv_heads=kv_heads,
        head_dim=head_dim, depth=depth, layer_types=layer_types,
        dense_layers=dense_layers, mlp_dim=mlp_dim, experts=experts,
        experts_held=experts_held, first_expert=first_expert,
        expert_dim=expert_dim, top_k=top_k, route_scale=route_scale,
        window=window, rope_theta=rope_theta, rms_eps=rms_eps, dtype=dtype,
        attn_impl=attn_impl, device="cpu", param_dtype=torch.float32,
        remat=remat)
    spec = from_module(module, name="afmoe_lm",
                       example=torch.zeros((1, maxlen), dtype=torch.int64))
    if not fused_ce:
        return spec
    fused = fused_ce_loss(
        per_thread(module), dtype,
        lambda params: (params["lm_head.weight"].to(dtype).t(), None),
        ce_chunk)
    return dataclasses.replace(
        spec, fused_losses={"sparse_softmax_cross_entropy": fused})
