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
on the CPU), "plain" (the flash path over the plain versions on any
device) or "ring" (ring attention over the sequence-parallel ranks,
``parallel/sequence.py``: valid inside
:func:`sequence_parallel_transformer_forward`, which runs every block's
attention through the ring whatever ``attn_impl`` says).
``remat=True`` recomputes each block's activations in the backward pass
(``layers.remat_block``, flax's ``nn.remat``), parameter names unchanged.
Under a tensor-parallel context (``parallel/tensor.py``) ``qkv``/``mlp_up``
run column-parallel and ``attn_out``/``mlp_down`` row-parallel on
``heads / tp`` local heads. :func:`pipelined_transformer_forward` runs the
blocks as GPipe stages over a ``pp`` axis.
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
from distkeras_tpu_torch.parallel import mesh as mesh_mod

_LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


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
    with ``mask`` as the key mask, and ``attn_out``. Under a
    tensor-parallel context ``qkv`` gives this rank's heads only; under a
    sequence-parallel one the attention is the ring over the ranks'
    blocks."""
    B, L, dim = x.shape
    h = ln_attn(x)
    q, k, v = qkv(h).chunk(3, dim=-1)
    shape = (B, L, -1, dim // heads)
    q, k, v = (t.reshape(shape) for t in (q, k, v))
    ctx = mesh_mod.context()
    if ctx.sp_group is not None:
        from distkeras_tpu_torch.parallel.sequence import (
            ring_attention_shard,
        )

        window = attn_window
        if window is not None and window >= ctx.sp_size * L:
            window = None  # the band covers the whole (global) sequence
        att = ring_attention_shard(q, k, v, mask, group=ctx.sp_group,
                                   causal=causal,
                                   scale=(dim // heads) ** -0.5,
                                   window=window)
    elif attn_impl == "ring":
        raise ValueError(
            "attn_impl='ring' runs inside sequence_parallel_transformer_"
            "forward (or MeshTrainer(strategy='sequence')), where the ring's "
            "ranks are known")
    elif attn_impl == "reference":
        att = attention_reference(q, k, v, causal=causal, key_mask=mask,
                                  window=attn_window)
    else:
        att = attention(q, k, v, causal=causal, key_mask=mask,
                        impl=attn_impl, window=attn_window)
    return x + attn_out(att.reshape(B, L, -1)).to(torch.float32)


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
        self.qkv = Dense(dim, 3 * dim, dtype, parallel="column")
        self.attn_out = Dense(dim, dim, dtype, parallel="row")
        self.ln_mlp = LayerNorm(dim)
        self.mlp_up = Dense(dim, mlp_ratio * dim, dtype, parallel="column")
        self.mlp_down = Dense(mlp_ratio * dim, dim, dtype, parallel="row")

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
        self.vocab, self.maxlen, self.dim = vocab, maxlen, dim
        self.heads, self.depth, self.causal = heads, depth, causal
        self.dtype, self.attn_impl = dtype, attn_impl
        self.attn_window = attn_window
        if attn_impl not in ("reference", "flash", "auto", "plain", "ring"):
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
        ctx = mesh_mod.context()
        # a sequence-parallel rank holds positions [off, off + L_local)
        off = ctx.sp_index * tokens.shape[1] if ctx.sp_group is not None \
            else 0
        return x + self.pos_table[off:off + tokens.shape[1]][None]

    def head_logits(self, x, mask):
        m = mask.to(torch.float32)[..., None]
        num, den = torch.sum(x * m, dim=1), torch.sum(m, dim=1)
        g = mesh_mod.context().sp_group
        if g is not None:
            # the masked mean over the whole sequence: sum the ranks' parts
            num, den = mesh_mod.reduce_from(num, g), mesh_mod.reduce_from(
                den, g)
        pooled = num / torch.clamp(den, min=1.0)
        return self.head(self.ln_head(pooled)).to(torch.float32)

    def forward(self, tokens, mask=None, method: str | None = None):
        """The classifier's logits; ``method="embed_tokens"`` (of
        ``tokens``) or ``"head_logits"`` (of hidden states ``tokens`` and
        ``mask``) runs one part, flax's ``apply(..., method=)``."""
        if method == "embed_tokens":
            return self.embed_tokens(tokens)
        if method == "head_logits":
            return self.head_logits(tokens, mask)
        if method is not None:
            raise ValueError(f"unknown method {method!r}")
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


def _apply(module, params, *args, **kwargs):
    return torch.func.functional_call(module, params, args, kwargs)


def pipelined_transformer_forward(module: TransformerClassifier, params,
                                  tokens, mask, mesh, axis: str = "pp",
                                  microbatches: int | None = None,
                                  batch_axis: str | None = None):
    """The classifier's forward with its ``depth`` blocks as GPipe stages
    over ``axis`` (``depth == mesh.size(axis)``, one block a rank),
    ``params`` the model's ``{name: tensor}`` (every rank holds all of
    them). The embedding runs on the first stage, the head on the last,
    and the logits come back on every rank (this rank's rows of
    ``batch_axis`` when given). Gradients land where they are computed:
    a block's on its stage's rank, the embedding's on the first, the
    head's on the last; sum them over ``axis`` for the whole gradient."""
    from distkeras_tpu_torch.parallel.pipeline import pipeline_forward

    S = mesh.size(axis)
    if module.depth != S:
        raise ValueError(f"depth {module.depth} != mesh axis '{axis}' size "
                         f"{S}")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    if batch_axis is not None:
        n, i = mesh.size(batch_axis), mesh.index(batch_axis)
        rows = tokens.shape[0] // n
        tokens, mask = (t[i * rows:(i + 1) * rows] for t in (tokens, mask))
    p = mesh.index(axis)
    prefix = f"blocks.{p}."
    stage = {k[len(prefix):]: v for k, v in params.items()
             if k.startswith(prefix)}
    return pipeline_forward(
        module, stage, params, tokens, mask, mesh.group(axis),
        microbatches or S)


def sequence_parallel_transformer_forward(module: TransformerClassifier,
                                          params, tokens, mask, mesh,
                                          axis: str = "sp",
                                          batch_axis: str | None = None):
    """The classifier's forward with activations split along the sequence
    over ``axis``: every rank passes the whole ``tokens``/``mask [B, L]``
    (``L`` divisible by the axis size, at most ``maxlen``), runs every
    pointwise layer on its slice, attention through the ring
    (``parallel/sequence.py``), positions offset by its slice, and the
    masked-mean head over the ranks' summed parts. The logits ``[B,
    classes]`` are the same on every rank of ``axis`` (this rank's rows
    when ``batch_axis`` is given), and so are the parameters' gradients,
    whole on every rank."""
    N = mesh.size(axis)
    L = tokens.shape[1]
    if L % N:
        raise ValueError(f"sequence length {L} not divisible by mesh axis "
                         f"'{axis}' of size {N}")
    if L > module.maxlen:
        raise ValueError(
            f"sequence length {L} exceeds the model's maxlen "
            f"{module.maxlen} (the plain forward would fail too)")
    if batch_axis is not None and tokens.shape[0] % mesh.size(batch_axis):
        raise ValueError(
            f"batch {tokens.shape[0]} not divisible by mesh axis "
            f"'{batch_axis}' of size {mesh.size(batch_axis)}")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    if batch_axis is not None:
        n, i = mesh.size(batch_axis), mesh.index(batch_axis)
        rows = tokens.shape[0] // n
        tokens, mask = (t[i * rows:(i + 1) * rows] for t in (tokens, mask))
    s, Ll = mesh.index(axis), L // N
    tokens, mask = (t[:, s * Ll:(s + 1) * Ll] for t in (tokens, mask))
    g = mesh.group(axis)
    # the leaves used on this rank's slice enter through copy_to, so their
    # gradients come back summed over the ranks; the head runs after the
    # ranks' parts are summed, on the same values everywhere
    params = {k: (v if k.split(".")[0] in _AFTER_REDUCE
                  or not v.requires_grad else mesh_mod.copy_to(v, g))
              for k, v in params.items()}
    with mesh_mod.using(mesh_mod.MeshContext(sp_group=g)):
        return _apply(module, params, tokens, mask)


#: the classifier's modules downstream of the sequence-parallel reduce
_AFTER_REDUCE = ("ln_head", "head")
