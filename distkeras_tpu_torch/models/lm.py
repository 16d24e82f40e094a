"""Decoder-only causal LM, for serving and training, on PyTorch + CUDA.

Port of ``distkeras_tpu/models/lm.py``: the pre-norm causal transformer
(:class:`TransformerLM`, :class:`DecoderBlock`), its int8 weight-only
serving form (:class:`QDense`, :func:`quantize_lm`), the block-paged
entry points the serving engine drives (``prefill_raw``,
``paged_extend_rows``, ``paged_decode_step``) and the training spec
(:func:`transformer_lm_spec`, with the chunked fused cross-entropy).

The numerics follow the JAX package's dtype discipline: the residual stream
and every LayerNorm (epsilon 1e-6) run in f32, the Dense layers in the
model dtype, GELU is the tanh approximation, logits are f32. RoPE rotates
interleaved feature pairs ``(x[2i], x[2i+1])`` and the cache holds rotated
keys. Paged decode attention keeps its own order — q·k in the model dtype,
then f32 scale and softmax, masked at -1e30, probabilities cast to v's
dtype — and is plain torch, as it is plain einsum in the JAX package.
Prefill attention goes through ``ops.flash_attention`` (the hand-written
kernel on the card) and every ``QDense`` through ``ops.quant.q_matmul``.

Weights live in ``param_dtype``. :func:`transformer_lm` builds the served
module with weights in the model dtype (serving never trains);
:func:`transformer_lm_spec` builds the training form, which keeps f32
master params and casts them to the model dtype per call, as flax's
``nn.Dense(dtype=...)`` and ``nn.Embed`` do. Load a JAX param tree with
:func:`distkeras_tpu_torch.convert.params_from_jax`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module, per_thread
from distkeras_tpu_torch.models.transformer import sincos_positions
from distkeras_tpu_torch.ops.flash_attention import (
    attention,
    attention_reference,
)
from distkeras_tpu_torch.ops.fused_ce import chunked_softmax_cross_entropy
from distkeras_tpu_torch.ops.quant import QTensor, q_matmul, quantize
from distkeras_tpu_torch.utils import resolve_device

_LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


def rope_angles(maxlen: int, head_dim: int, base: float = 10000.0):
    """Rotary angle table ``[maxlen, head_dim // 2]``: position ``p``
    rotates feature pair ``i`` by ``p · base^(-2i/head_dim)``."""
    inv = base ** (-np.arange(0, head_dim, 2) / head_dim)
    return (np.arange(maxlen)[:, None] * inv[None, :]).astype(np.float32)


def _rotate(x, cos, sin):
    """Rotate interleaved pairs of ``x [..., L, H, Dh]`` by per-position
    ``cos``/``sin`` ``[L, Dh/2]`` or ``[B, L, Dh/2]``, in f32, cast back."""
    f32 = x.to(torch.float32)
    x1, x2 = f32[..., 0::2], f32[..., 1::2]
    cos, sin = cos[..., None, :], sin[..., None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(f32.shape).to(x.dtype)


def apply_rope(x, angles):
    """Rotate feature pairs of ``x [..., L, H, Dh]`` by ``angles``
    ``[L, Dh/2]`` (or ``[B, L, Dh/2]``, one position per row)."""
    return _rotate(x, torch.cos(angles), torch.sin(angles))


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)`` counterpart: ``weight [out, in]`` and
    ``bias`` in ``param_dtype`` (the model dtype unless given), the product
    in the model dtype."""

    def __init__(self, in_features: int, features: int, dtype, device,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_features), dtype=pdt, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=pdt,
                                             device=device))

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class QDense(nn.Module):
    """Dense over an int8 weight-only-quantized kernel: ``kernel_q``
    int8 ``[out, in]`` (the layout ``q_matmul``'s kernel streams),
    per-output-channel ``scale`` f32, ``bias`` kept in ``param_dtype`` (the
    model dtype unless given) and added in the activation dtype."""

    def __init__(self, in_features: int, features: int, dtype, device,
                 param_dtype=None):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros(
            (features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=param_dtype or dtype, device=device))

    def forward(self, x):
        out = q_matmul(x, QTensor(self.kernel_q, self.scale),
                       out_dtype=x.dtype)
        return out + self.bias.to(out.dtype)


def _layer_norm(dim, device):
    return nn.LayerNorm(dim, eps=_LN_EPS, dtype=torch.float32, device=device)


class DecoderBlock(nn.Module):
    """Pre-norm causal block: ``forward`` (full forward), ``prefill`` (full
    forward that also returns this block's K/V) and ``paged_extend`` (T
    positions per row against the block-paged cache)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, attn_impl: str = "reference",
                 attn_window: int | None = None, kv_heads: int | None = None,
                 rope: bool = False, quant: bool = False, device="cuda",
                 param_dtype=None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.attn_window = attn_window
        self.hkv = kv_heads if kv_heads is not None else heads
        self.rope = rope
        self.dh = dim // heads
        dense = QDense if quant else Dense
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.ln_attn = _layer_norm(dim, device)
        # one fused projection, width (H + 2·Hkv)·Dh, split q | k | v
        self.qkv = dense(dim, (heads + 2 * self.hkv) * self.dh, **kw)
        self.attn_out = dense(dim, dim, **kw)
        self.ln_mlp = _layer_norm(dim, device)
        self.mlp_up = dense(dim, mlp_ratio * dim, **kw)
        self.mlp_down = dense(mlp_ratio * dim, dim, **kw)

    def _project_qkv(self, x):
        """→ q [B, L, H, Dh], k/v [B, L, Hkv, Dh]."""
        B, L, _ = x.shape
        h = self.ln_attn(x)
        qkv = self.qkv(h.to(self.dtype))
        hd, kd = self.heads * self.dh, self.hkv * self.dh
        q = qkv[..., :hd].reshape(B, L, self.heads, self.dh)
        k = qkv[..., hd:hd + kd].reshape(B, L, self.hkv, self.dh)
        v = qkv[..., hd + kd:].reshape(B, L, self.hkv, self.dh)
        return q, k, v

    def _mlp(self, x):
        h = self.ln_mlp(x)
        h = self.mlp_up(h.to(self.dtype))
        h = F.gelu(h, approximate="tanh")
        h = self.mlp_down(h)
        return x + h.to(torch.float32)

    def _attn_full(self, x, mask, rope):
        B, L, _ = x.shape
        q, k, v = self._project_qkv(x)
        if self.rope:
            q, k = _rotate(q, *rope), _rotate(k, *rope)  # k rotated BEFORE caching
        if self.attn_impl == "reference":
            att = attention_reference(q, k, v, causal=True, key_mask=mask,
                                      window=self.attn_window)
        else:
            att = attention(q, k, v, causal=True, key_mask=mask,
                            impl=self.attn_impl, window=self.attn_window)
        att = att.reshape(B, L, self.dim)
        x = x + self.attn_out(att.to(self.dtype)).to(torch.float32)
        return x, k, v

    def forward(self, x, mask=None, rope=None):
        x, _, _ = self._attn_full(x, mask, rope)
        return self._mlp(x)

    def prefill(self, x, mask=None, rope=None):
        x, k, v = self._attn_full(x, mask, rope)
        return self._mlp(x), k, v

    def paged_extend(self, x, k_pool, v_pool, tables, write_slots, positions,
                     block_size: int, rope=None):
        """``T`` decode positions per row against flat slot pools ``[S, Hkv,
        Dh]``: row ``b``'s tokens occupy ``positions[b] ..
        positions[b]+T-1`` and are written IN PLACE to pool slots
        ``write_slots[b]`` ([B, T]); the block table ``tables`` [B, nb] maps
        logical block ``t // block_size`` to a pool block. The gather
        rebuilds each row's ``[nb·bs, Hkv, Dh]`` cache; unwritten slots are
        masked by the per-row causal validity. Returns ``(x, k_pool,
        v_pool)`` — the pools are the same tensors, updated."""
        B, T, _ = x.shape
        bs = int(block_size)
        nb = tables.shape[1]
        L = nb * bs
        q, k, v = self._project_qkv(x)
        if self.rope:
            q, k = _rotate(q, *rope), _rotate(k, *rope)
        flat = write_slots.reshape(-1)
        k_pool.index_copy_(0, flat, k.reshape(-1, self.hkv, self.dh)
                           .to(k_pool.dtype))
        v_pool.index_copy_(0, flat, v.reshape(-1, self.hkv, self.dh)
                           .to(v_pool.dtype))
        k_seq = k_pool.view(-1, bs, self.hkv, self.dh)[tables].reshape(
            B, L, self.hkv, self.dh)
        v_seq = v_pool.view(-1, bs, self.hkv, self.dh)[tables].reshape(
            B, L, self.hkv, self.dh)
        group = self.heads // self.hkv
        qg = q.reshape(B, T, self.hkv, group, self.dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_seq) \
            .to(torch.float32) * (self.dh ** -0.5)
        kp = torch.arange(L, device=x.device)[None, None, :]
        qp = (positions[:, None] + torch.arange(T, device=x.device)[None, :]
              )[:, :, None]
        valid = kp <= qp                      # per-row causal; unwritten
        if self.attn_window is not None:      # slots (kp > qp) masked too
            valid = valid & (qp - kp < self.attn_window)
        s = s.masked_fill(~valid[:, None, None, :, :], -1e30)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_seq.dtype), v_seq)
        att = att.reshape(B, T, self.dim)
        x = x + self.attn_out(att.to(self.dtype)).to(torch.float32)
        return self._mlp(x), k_pool, v_pool


class TransformerLM(nn.Module):
    """Token sequence → next-token logits ``[B, L, vocab]`` (f32), with
    the block-paged serving entry points. ``param_dtype`` (default: the
    model ``dtype``) is the dtype the Dense and embedding weights are kept
    in; the product runs in ``dtype`` either way. ``attn_impl``:
    "reference", "flash"/"auto" (the flash kernels on the card, their plain
    versions on the CPU) or "plain" (the flash path over the plain versions
    on any device)."""

    def __init__(self, vocab: int = 1024, maxlen: int = 256, dim: int = 128,
                 heads: int = 4, depth: int = 2, dtype=torch.bfloat16,
                 attn_impl: str = "reference",
                 attn_window: int | None = None,
                 kv_heads: int | None = None, pos_embedding: str = "sincos",
                 quant: bool = False, tie_embeddings: bool = False,
                 device="cuda", param_dtype=None):
        super().__init__()
        device = resolve_device(device)
        if kv_heads is not None and heads % kv_heads:
            raise ValueError(f"heads {heads} must be a multiple of kv_heads "
                             f"{kv_heads}")
        if pos_embedding not in ("sincos", "rope"):
            raise ValueError(f"unknown pos_embedding {pos_embedding!r}; use "
                             f"'sincos' or 'rope'")
        if pos_embedding == "rope" and (dim // heads) % 2:
            raise ValueError(f"RoPE needs an even head dim, got dim//heads = "
                             f"{dim // heads}")
        if attn_impl not in ("reference", "flash", "auto", "plain"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        param_dtype = param_dtype or dtype
        self.config = dict(
            vocab=vocab, maxlen=maxlen, dim=dim, heads=heads, depth=depth,
            dtype=dtype, attn_impl=attn_impl, attn_window=attn_window,
            kv_heads=kv_heads, pos_embedding=pos_embedding, quant=quant,
            tie_embeddings=tie_embeddings, param_dtype=param_dtype,
        )
        self.vocab, self.maxlen, self.dim = vocab, maxlen, dim
        self.heads, self.depth, self.dtype = heads, depth, dtype
        self.kv_heads = kv_heads
        self.attn_window = attn_window
        self.pos_embedding = pos_embedding
        self.quant = quant
        self.tie_embeddings = tie_embeddings
        self.embed = nn.Embedding(vocab, dim, dtype=param_dtype,
                                  device=device)
        self.blocks = nn.ModuleList([
            DecoderBlock(dim, heads, dtype=dtype, attn_impl=attn_impl,
                         attn_window=attn_window, kv_heads=kv_heads,
                         rope=pos_embedding == "rope", quant=quant,
                         device=device, param_dtype=param_dtype)
            for _ in range(depth)
        ])
        self.ln_head = _layer_norm(dim, device)
        if not tie_embeddings:
            head = QDense if quant else Dense
            self.lm_head = head(dim, vocab, dtype, device,
                                param_dtype=param_dtype)
        if pos_embedding == "rope":
            self.register_buffer("rope_table", torch.from_numpy(
                rope_angles(maxlen, dim // heads)).to(device),
                persistent=False)
        else:
            self.register_buffer("pos_table", torch.from_numpy(
                sincos_positions(maxlen, dim)).to(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def _rope(self, angles):
        if self.pos_embedding != "rope":
            return None
        return torch.cos(angles), torch.sin(angles)

    def reset_parameters(self, generator) -> None:
        """flax's default initializers drawn from ``generator`` (what
        ``ModelSpec.init`` calls on a fresh copy)."""
        _init_flax_defaults(self, generator)

    def _tokens(self, tokens):
        """Embedding rows in the model dtype, widened to f32 (flax's
        ``nn.Embed(dtype=...)`` then ``astype(f32)``)."""
        return self.embed(tokens.to(torch.int64)).to(self.dtype) \
            .to(torch.float32)

    def _embed_at(self, tokens, pos0: int = 0):
        """Embed ``tokens`` occupying positions ``pos0 .. pos0+L``."""
        x = self._tokens(tokens)
        if self.pos_embedding == "rope":
            return x
        return x + self.pos_table[pos0:pos0 + tokens.shape[1]][None]

    def _embed_rows(self, tokens, positions):
        """Embed ``tokens`` [B, T] where row ``b`` occupies positions
        ``positions[b] .. positions[b]+T-1``."""
        x = self._tokens(tokens)
        if self.pos_embedding == "rope":
            return x
        T = tokens.shape[1]
        idx = positions[:, None] + torch.arange(T, device=tokens.device)
        return x + self.pos_table[idx]

    def _head(self, h):
        """Output projection over post-``ln_head`` hiddens: model-dtype
        matmul, f32 logits; tied mode contracts against the embedding."""
        h16 = h.to(self.dtype)
        if self.tie_embeddings:
            return torch.matmul(h16, self.embed.weight.to(self.dtype).t()) \
                .to(torch.float32)
        return self.lm_head(h16).to(torch.float32)

    def _logits(self, x):
        return self._head(self.ln_head(x))

    def forward(self, tokens, mask=None, return_hidden: bool = False):
        """Logits ``[B, L, vocab]``, or with ``return_hidden`` the hidden
        states :meth:`hidden` gives (the fused loss's input, reachable
        through ``torch.func.functional_call``)."""
        h = self.hidden(tokens, mask)
        return h if return_hidden else self._head(h)

    def hidden(self, tokens, mask=None):
        """Final post-``ln_head`` hidden states ``[B, L, dim]`` (f32)."""
        x = self._embed_at(tokens)
        rope = self._rope(self.rope_table[:tokens.shape[1]]) \
            if self.pos_embedding == "rope" else None
        for blk in self.blocks:
            x = blk(x, mask, rope)
        return self.ln_head(x)

    def prefill_raw(self, tokens):
        """Full forward over the prompt: ``(logits, kvs)`` with per-block
        unpadded K/V ``[B, L, Hkv, Dh]`` (keys rotated under RoPE) — the
        serving engine scatters them into its block pools."""
        x = self._embed_at(tokens)
        rope = self._rope(self.rope_table[:tokens.shape[1]]) \
            if self.pos_embedding == "rope" else None
        kvs = []
        for blk in self.blocks:
            x, k, v = blk.prefill(x, None, rope)
            kvs.append((k.to(self.dtype), v.to(self.dtype)))
        return self._logits(x), tuple(kvs)

    def paged_extend_rows(self, tokens, k_pools, v_pools, tables,
                          write_slots, positions, block_size: int):
        """Multi-token decode against the block-paged cache: ``tokens``
        [B, T], row ``b`` at positions ``positions[b] ..``; per-layer flat
        pools are updated in place. Returns ``(logits [B, T, vocab],
        k_pools, v_pools)``."""
        x = self._embed_rows(tokens, positions)
        rope = None
        if self.pos_embedding == "rope":
            T = tokens.shape[1]
            idx = positions[:, None] + torch.arange(T, device=tokens.device)
            rope = self._rope(self.rope_table[idx])
        for blk, kp, vp in zip(self.blocks, k_pools, v_pools):
            x, _, _ = blk.paged_extend(x, kp, vp, tables, write_slots,
                                       positions, block_size, rope)
        return self._logits(x), k_pools, v_pools

    def paged_decode_step(self, tok, k_pools, v_pools, tables, write_slot,
                          positions, block_size: int):
        """One paged decode step: ``tok`` [B], each row at its own
        ``positions[b]`` writing pool slot ``write_slot[b]`` → ``(logits
        [B, vocab], k_pools, v_pools)``."""
        logits, k_pools, v_pools = self.paged_extend_rows(
            tok[:, None], k_pools, v_pools, tables, write_slot[:, None],
            positions, block_size)
        return logits[:, 0], k_pools, v_pools


def _init_flax_defaults(model: TransformerLM, generator) -> None:
    """flax's default initializers, drawn from ``generator``: Dense kernels
    lecun-normal (truncated normal at ±2σ, σ = sqrt(1/fan_in)/.8796),
    zero biases, LayerNorm scale 1 and bias 0, embeddings normal with
    std sqrt(1/dim)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                fan_in = mod.weight.shape[1]
                std = (1.0 / fan_in) ** 0.5 / .87962566103423978
                w = torch.empty(mod.weight.shape, dtype=torch.float32,
                                device=mod.weight.device)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                w = torch.empty(mod.weight.shape, dtype=torch.float32,
                                device=mod.weight.device)
                w.normal_(0.0, mod.weight.shape[1] ** -0.5,
                          generator=generator)
                mod.weight.copy_(w)


def transformer_lm(vocab=1024, maxlen=256, dim=128, heads=4, depth=2,
                   dtype=torch.bfloat16, attn_impl="reference",
                   attn_window=None, kv_heads=None, pos_embedding="sincos",
                   tie_embeddings=False, *, device="cuda",
                   seed: int = 0) -> TransformerLM:
    """A causal LM on ``device`` (the card unless the caller asks for the
    CPU) with weights drawn from flax's default initializers through a
    ``torch.Generator`` seeded with ``seed``. The JAX package's options
    keep their meaning: ``attn_window`` (sliding window), ``kv_heads``
    (grouped-query attention; 1 = multi-query), ``pos_embedding``
    ("sincos" or "rope"), ``tie_embeddings``; ``attn_impl="flash"`` runs
    prefill attention through the flash kernel."""
    device = resolve_device(device)
    model = TransformerLM(
        vocab=vocab, maxlen=maxlen, dim=dim, heads=heads, depth=depth,
        dtype=dtype, attn_impl=attn_impl, attn_window=attn_window,
        kv_heads=kv_heads, pos_embedding=pos_embedding,
        tie_embeddings=tie_embeddings, device=device,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    _init_flax_defaults(model, gen)
    return model.eval()


def transformer_lm_spec(vocab=1024, maxlen=256, dim=128, heads=4, depth=2,
                        dtype=torch.bfloat16, attn_impl="reference",
                        attn_window=None, kv_heads=None,
                        pos_embedding="sincos", fused_ce=False,
                        ce_chunk=256, remat=False,
                        tie_embeddings=False) -> ModelSpec:
    """Causal-LM ``ModelSpec`` for the trainers: the counterpart of
    ``distkeras_tpu.models.transformer_lm``, with its kwargs and defaults.
    (The port's :func:`transformer_lm` returns the served module, so the
    training spec has its own name.) f32 master params, compute in
    ``dtype``. Train with ``loss="sparse_softmax_cross_entropy"`` on
    ``features = tokens [B, L]`` and ``label = next tokens [B, L]``
    (:func:`distkeras_tpu_torch.data.next_token_dataset`).
    ``fused_ce=True`` adds a fused loss under that name: the chunked
    cross-entropy of ``ops/fused_ce.py`` over the hidden states and the
    head (``lm_head``, or the tied embedding), ``ce_chunk`` rows of logits
    at a time, so the ``[B, L, vocab]`` logits never exist. The template
    module lives on the CPU; the trainer places params and state on its
    device."""
    if remat:
        raise NotImplementedError(
            "remat=True is not ported yet: ROADMAP.md A10 (remat)")
    module = TransformerLM(
        vocab=vocab, maxlen=maxlen, dim=dim, heads=heads, depth=depth,
        dtype=dtype, attn_impl=attn_impl, attn_window=attn_window,
        kv_heads=kv_heads, pos_embedding=pos_embedding,
        tie_embeddings=tie_embeddings, device="cpu",
        param_dtype=torch.float32)
    spec = from_module(module, name="transformer_lm")
    if not fused_ce:
        return spec
    chunk = int(ce_chunk)
    module_here = per_thread(module)

    def fused(params, state, x, y, training, mask=None):
        h = torch.func.functional_call(module_here(), {**params, **state},
                                       (x,), {"return_hidden": True})
        b_, l_, d_ = h.shape
        token_mask = None
        if mask is not None:
            # per-row validity [B] covers every token of its row; [B, L]
            # passes through
            mask = torch.as_tensor(mask, dtype=torch.float32,
                                   device=h.device)
            token_mask = (mask.repeat_interleave(l_) if mask.dim() == 1
                          else mask.reshape(b_ * l_))
        if module.tie_embeddings:
            # the head IS the embedding: contract against its transpose
            kernel, bias = params["embed.weight"].to(module.dtype).t(), None
        else:
            kernel = params["lm_head.weight"].to(module.dtype).t()
            bias = params["lm_head.bias"]
        loss = chunked_softmax_cross_entropy(
            h.to(module.dtype).reshape(b_ * l_, d_), y.reshape(b_ * l_),
            kernel, bias, mask=token_mask, chunk=chunk)
        return loss, state

    return dataclasses.replace(
        spec, fused_losses={"sparse_softmax_cross_entropy": fused})


def quantize_lm(model: TransformerLM) -> TransformerLM:
    """Post-training int8 weight-only quantization: a new
    :class:`TransformerLM` on the same device whose every Dense
    (qkv/attn_out/mlp_up/mlp_down/lm_head) is a :class:`QDense` over
    ``quantize(weight)`` (per-output-channel absmax of the model's own
    weights); embeddings and LayerNorms are copied unchanged. A tied head
    stays the embedding, in the model dtype."""
    if not isinstance(model, TransformerLM):
        raise TypeError(f"quantize_lm() needs a TransformerLM, got "
                        f"{type(model)}")
    if model.quant:
        raise ValueError("model is already quantized")
    qmodel = TransformerLM(**{**model.config, "quant": True},
                           device=model.device)
    src = dict(model.named_modules())
    with torch.no_grad():
        for name, mod in qmodel.named_modules():
            if isinstance(mod, QDense):
                qt = quantize(src[name].weight, axis=1)
                mod.kernel_q.copy_(qt.q)
                mod.scale.copy_(qt.scale)
                mod.bias.copy_(src[name].bias)
            elif isinstance(mod, (nn.LayerNorm, nn.Embedding)):
                mod.load_state_dict(src[name].state_dict())
    return qmodel.eval()
