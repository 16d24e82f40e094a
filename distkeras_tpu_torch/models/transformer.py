"""Transformer encoder classifier, and the position table shared by the
transformer families.

Port of ``distkeras_tpu/models/transformer.py``: :func:`attention_sublayer`,
:class:`EncoderBlock`, :class:`TransformerClassifier` (with
``embed_tokens``/``head_logits``), :func:`transformer_classifier` and
:func:`sincos_positions`. A pre-norm encoder, non-causal by default, whose
head reads a masked mean of the last hidden states. f32 parameters with
compute in the model dtype (flax's ``nn.Dense(dtype=...)``), f32 residual
stream and LayerNorms (epsilon 1e-6), tanh GELU, f32 logits.

Attention (``attn_impl``): "reference" (plain softmax attention),
"flash"/"auto" (the flash kernels K2–K4 on the card, their plain versions
on the CPU) or "plain" (the flash path over the plain versions on any
device). ``"ring"`` and the mesh forwards (pipeline, sequence parallel)
belong to the parallelism portfolio and raise until it is ported.
``remat=True`` recomputes each block's activations in the backward pass
(``layers.remat_block``, flax's ``nn.remat``), parameter names unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module
from distkeras_tpu_torch.models.layers import (
    Dense,
    Embed,
    remat_block,
    reset_children,
)
from distkeras_tpu_torch.ops.flash_attention import (
    attention,
    attention_reference,
)

_LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)
_MESH = "ROADMAP.md A12 (parallelism portfolio)"


def sincos_positions(maxlen: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal position table [maxlen, dim] (Vaswani et al. 2017)."""
    pos = np.arange(maxlen)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    table = np.zeros((maxlen, dim), np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


class LayerNorm(nn.LayerNorm):
    """f32 LayerNorm with flax's epsilon and ``reset_parameters(generator)``
    (scale 1, bias 0)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=_LN_EPS)

    def reset_parameters(self, generator=None) -> None:
        super().reset_parameters()


def attention_sublayer(x, mask, ln_attn, qkv, attn_out, *, heads: int,
                       causal: bool, attn_impl: str = "reference",
                       attn_window: int | None = None):
    """Pre-norm self-attention + residual: ``x [B, L, dim]`` (f32) through
    ``ln_attn``, the fused ``qkv`` projection split in thirds, attention
    with ``mask`` as the key mask, and ``attn_out``."""
    B, L, dim = x.shape
    h = ln_attn(x)
    q, k, v = qkv(h).chunk(3, dim=-1)
    shape = (B, L, heads, dim // heads)
    q, k, v = (t.reshape(shape) for t in (q, k, v))
    if attn_impl == "reference":
        att = attention_reference(q, k, v, causal=causal, key_mask=mask,
                                  window=attn_window)
    else:
        att = attention(q, k, v, causal=causal, key_mask=mask,
                        impl=attn_impl, window=attn_window)
    return x + attn_out(att.reshape(B, L, dim)).to(torch.float32)


class EncoderBlock(nn.Module):
    """Pre-norm encoder block: :func:`attention_sublayer`, then the GELU
    MLP, each with a residual. Parameters carry flax's names."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 causal: bool = False, dtype=torch.bfloat16,
                 attn_impl: str = "reference",
                 attn_window: int | None = None):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.attn_impl, self.attn_window = attn_impl, attn_window
        self.ln_attn = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.attn_out = Dense(dim, dim, dtype)
        self.ln_mlp = LayerNorm(dim)
        self.mlp_up = Dense(dim, mlp_ratio * dim, dtype)
        self.mlp_down = Dense(mlp_ratio * dim, dim, dtype)

    def reset_parameters(self, generator) -> None:
        reset_children(self, generator)

    def forward(self, x, mask=None):
        x = attention_sublayer(x, mask, self.ln_attn, self.qkv, self.attn_out,
                               heads=self.heads, causal=self.causal,
                               attn_impl=self.attn_impl,
                               attn_window=self.attn_window)
        h = self.mlp_up(self.ln_mlp(x))
        h = self.mlp_down(F.gelu(h, approximate="tanh"))
        return x + h.to(torch.float32)


class TransformerClassifier(nn.Module):
    """``(tokens [B, L], mask [B, L]) → logits [B, num_classes]`` (f32).
    Parameters carry flax's names: ``embed``, ``blocks.i`` (flax
    ``blocks_i``), ``ln_head``, ``head``. ``remat``: each block through
    :func:`remat_block`."""

    def __init__(self, vocab: int = 20000, maxlen: int = 200, dim: int = 128,
                 heads: int = 4, depth: int = 2, num_classes: int = 2,
                 causal: bool = False, dtype=torch.bfloat16,
                 attn_impl: str = "reference",
                 attn_window: int | None = None, remat: bool = False):
        super().__init__()
        self.remat = bool(remat)
        if attn_impl == "ring":
            raise NotImplementedError(
                f"attn_impl='ring' (sequence-parallel ring attention) is not "
                f"ported yet: {_MESH}")
        if attn_impl not in ("reference", "flash", "auto", "plain"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.embed = Embed(vocab, dim, dtype)
        self.blocks = nn.ModuleList([
            EncoderBlock(dim, heads, causal=causal, dtype=dtype,
                         attn_impl=attn_impl, attn_window=attn_window)
            for _ in range(depth)])
        self.ln_head = LayerNorm(dim)
        self.head = Dense(dim, num_classes, dtype)
        self.register_buffer("pos_table", torch.from_numpy(
            sincos_positions(maxlen, dim)), persistent=False)

    def reset_parameters(self, generator) -> None:
        self.embed.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.ln_head.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def embed_tokens(self, tokens):
        x = self.embed(tokens).to(torch.float32)
        return x + self.pos_table[:tokens.shape[1]][None]

    def head_logits(self, x, mask):
        m = mask.to(torch.float32)[..., None]
        pooled = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                       min=1.0)
        return self.head(self.ln_head(pooled)).to(torch.float32)

    def forward(self, tokens, mask=None):
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        x = self.embed_tokens(tokens)
        for blk in self.blocks:
            x = remat_block(blk, x, mask) if self.remat else blk(x, mask)
        return self.head_logits(x, mask)


def transformer_classifier(vocab=20000, maxlen=200, dim=128, heads=4,
                           depth=2, num_classes=2, causal=False,
                           dtype=torch.bfloat16, attn_impl="reference",
                           remat=False, attn_window=None) -> ModelSpec:
    """The encoder classifier as a ``ModelSpec``: features ``(tokens,
    mask)`` (``features_col=["features", "mask"]``), f32 master params.
    The template module lives on the CPU; the trainer places params and
    state on its device. ``remat=True`` rematerializes each block in the
    backward pass: one more forward of it for activations not kept."""
    module = TransformerClassifier(
        vocab=vocab, maxlen=maxlen, dim=dim, heads=heads, depth=depth,
        num_classes=num_classes, causal=causal, dtype=dtype,
        attn_impl=attn_impl, attn_window=attn_window, remat=remat)
    example = (torch.zeros((1, maxlen), dtype=torch.int64),
               torch.ones((1, maxlen), dtype=torch.float32))
    return from_module(module, name="transformer_classifier",
                       example=example)


def pipelined_transformer_forward(*args, **kwargs):
    """The encoder stack pipelined over a mesh axis: not ported yet."""
    raise NotImplementedError(
        f"pipelined_transformer_forward is not ported yet: {_MESH}")


def sequence_parallel_transformer_forward(*args, **kwargs):
    """The encoder with ring attention over a mesh axis: not ported yet."""
    raise NotImplementedError(
        f"sequence_parallel_transformer_forward is not ported yet: {_MESH}")
