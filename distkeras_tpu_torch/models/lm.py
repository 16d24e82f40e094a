"""Decoder-only causal LM, for serving and training, on PyTorch + CUDA.

Port of ``distkeras_tpu/models/lm.py``: the pre-norm causal transformer
(:class:`TransformerLM`, :class:`DecoderBlock`), its int8 weight-only
serving form (:func:`quantize_lm`, over ``ops.quant.QDense``), the dense and ring
KV cache (``prefill``, ``decode_step``, ``extend``) and the decoding
functions over it (:func:`generate`, :func:`speculative_generate`,
:func:`beam_search`), the block-paged entry points the serving engine
drives (``prefill_raw``, ``paged_extend_rows``, ``paged_decode_step``)
and the training spec (:func:`transformer_lm_spec`, with the chunked
fused cross-entropy). The served module carries its own weights, so the
decoding functions take the module where the JAX package's take a spec
and its params.

The numerics follow the JAX package's dtype discipline: the residual stream
and every LayerNorm (epsilon 1e-6) run in f32, the Dense layers in the
model dtype, GELU is the tanh approximation, logits are f32. RoPE rotates
interleaved feature pairs ``(x[2i], x[2i+1])`` and the cache holds rotated
keys. Cached decode attention (dense, ring and paged) keeps its own
order — q·k in the model dtype, then f32 scale and softmax, masked at
-1e30, probabilities cast to v's dtype — and is plain torch, as it is
plain einsum in the JAX package.
Prefill attention goes through ``ops.flash_attention`` (the hand-written
kernel on the card) and every ``QDense`` through ``ops.quant.q_matmul``.

Weights live in ``param_dtype``. :func:`transformer_lm` builds the served
module with weights in the model dtype (serving never trains);
:func:`transformer_lm_spec` builds the training form, which keeps f32
master params and casts them to the model dtype per call, as flax's
``nn.Dense(dtype=...)`` and ``nn.Embed`` do. Load a JAX param tree with
:func:`distkeras_tpu_torch.convert.params_from_jax`.

With ``observability.trace`` on, the full forward records ``lm.embed``
(the embedding), ``lm.attn`` and ``lm.mlp`` (each block's attention and
MLP halves, residual adds included) and ``lm.head`` (the final
LayerNorm, and the head's projection where the logits are made here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.model import ModelSpec, from_module, per_thread
from distkeras_tpu_torch.models.layers import remat_block
from distkeras_tpu_torch.models.transformer import sincos_positions
from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.ops.flash_attention import (
    attention,
    attention_reference,
)
from distkeras_tpu_torch.ops.fused_ce import chunked_softmax_cross_entropy
from distkeras_tpu_torch.ops.quant import QDense, quantize
from distkeras_tpu_torch.parallel.tensor import (
    embed_lookup,
    parallel_linear,
    tp_heads,
)
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
    ``bias`` (none with ``bias=False``) in ``param_dtype`` (the model dtype
    unless given), the product in the model dtype."""

    def __init__(self, in_features: int, features: int, dtype, device,
                 param_dtype=None, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.parallel = None    # a Megatron role, set by DecoderBlock
        pdt = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_features), dtype=pdt, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=pdt, device=device)) if bias else None

    def forward(self, x):
        return parallel_linear(x, self.weight, self.bias, self.parallel,
                               self.dtype)


def _layer_norm(dim, device):
    return nn.LayerNorm(dim, eps=_LN_EPS, dtype=torch.float32, device=device)


class DecoderBlock(nn.Module):
    """Pre-norm causal block: ``forward`` (full forward), ``prefill`` (full
    forward that also returns this block's K/V), ``step`` and ``extend``
    (one or ``T`` decode positions against a dense or ring cache) and
    ``paged_extend`` (T positions per row against the block-paged cache).
    ``maxlen`` tells a full-length cache from a sliding window's ring."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, attn_impl: str = "reference",
                 attn_window: int | None = None, kv_heads: int | None = None,
                 rope: bool = False, quant: bool = False, device="cuda",
                 param_dtype=None, maxlen: int = 0):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.maxlen = int(maxlen)
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
        if not quant:
            # Megatron roles, applied under a tensor-parallel context
            for name, role in (("qkv", "column"), ("attn_out", "row"),
                               ("mlp_up", "column"), ("mlp_down", "row")):
                getattr(self, name).parallel = role

    def _project_qkv(self, x):
        """→ q [B, L, H, Dh], k/v [B, L, Hkv, Dh]."""
        B, L, _ = x.shape
        h = self.ln_attn(x)
        qkv = self.qkv(h.to(self.dtype))
        # this rank's heads under a tensor-parallel context (QDense, the
        # served int8 layer, has no role)
        role = getattr(self.qkv, "parallel", None)
        heads, hkv = tp_heads(self.heads, role), tp_heads(self.hkv, role)
        hd, kd = heads * self.dh, hkv * self.dh
        q = qkv[..., :hd].reshape(B, L, heads, self.dh)
        k = qkv[..., hd:hd + kd].reshape(B, L, hkv, self.dh)
        v = qkv[..., hd + kd:].reshape(B, L, hkv, self.dh)
        return q, k, v

    def _mlp(self, x):
        with _trace.span("lm.mlp"):
            h = self.ln_mlp(x)
            h = self.mlp_up(h.to(self.dtype))
            h = F.gelu(h, approximate="tanh")
            h = self.mlp_down(h)
            return x + h.to(torch.float32)

    def _attn_full(self, x, mask, rope):
        with _trace.span("lm.attn"):
            B, L, _ = x.shape
            q, k, v = self._project_qkv(x)
            if self.rope:
                # k rotated BEFORE caching
                q, k = _rotate(q, *rope), _rotate(k, *rope)
            if self.attn_impl == "reference":
                att = attention_reference(q, k, v, causal=True,
                                          key_mask=mask,
                                          window=self.attn_window)
            else:
                att = attention(q, k, v, causal=True, key_mask=mask,
                                impl=self.attn_impl, window=self.attn_window)
            att = att.reshape(B, L, -1)
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
        kp = torch.arange(L, device=x.device)[None, None, :]
        qp = (positions[:, None] + torch.arange(T, device=x.device)[None, :]
              )[:, :, None]
        valid = kp <= qp                      # per-row causal; unwritten
        if self.attn_window is not None:      # slots (kp > qp) masked too
            valid = valid & (qp - kp < self.attn_window)
        return self._cached_attention(x, q, k_seq, v_seq, valid), \
            k_pool, v_pool

    def _cached_attention(self, x, q, k_seq, v_seq, valid):
        """Attention of ``q [B, T, H, Dh]`` over cached ``k_seq``/``v_seq``
        ``[B, L, Hkv, Dh]`` where ``valid`` ``[B or 1, T, L]`` holds, then
        the residual and the MLP: q·k in the model dtype, f32 scale and
        softmax (masked at -1e30), probabilities cast to v's dtype; the
        ``[H]`` head axis factors as ``[Hkv, group]``."""
        B, T = q.shape[:2]
        group = self.heads // self.hkv
        qg = q.reshape(B, T, self.hkv, group, self.dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_seq) \
            .to(torch.float32) * (self.dh ** -0.5)
        s = s.masked_fill(~valid[:, None, None, :, :], -1e30)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_seq.dtype), v_seq)
        att = att.reshape(B, T, self.dim)
        x = x + self.attn_out(att.to(self.dtype)).to(torch.float32)
        return self._mlp(x)

    def step(self, x_t, k_cache, v_cache, pos: int, rope=None):
        """One decode position: ``x_t`` [B, 1, dim] at absolute position
        ``pos`` against ``k_cache``/``v_cache`` [B, cache_len, Hkv, Dh],
        written in place. ``cache_len`` is ``maxlen``, or the window of a
        sliding-window model: then the cache is a ring, position ``p`` in
        slot ``p % window``, and only never-written slots are masked (a
        slot's position is causal and in the band by construction). The
        non-ring step is :meth:`extend` at T=1: cached decode and the
        speculative verify forward share one body."""
        cache_len = k_cache.shape[1]
        if cache_len >= self.maxlen:
            return self.extend(x_t, k_cache, v_cache, pos, rope)
        q, k, v = self._project_qkv(x_t)
        if self.rope:
            # the cache holds rotated keys
            q, k = _rotate(q, *rope), _rotate(k, *rope)
        slot = int(pos) % cache_len
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        kp = torch.arange(cache_len, device=x_t.device)
        # slot s holds absolute position pos - ((pos - s) % window)
        valid = (int(pos) - ((int(pos) - kp) % cache_len) >= 0)[None, None]
        return self._cached_attention(x_t, q, k_cache, v_cache, valid), \
            k_cache, v_cache

    def extend(self, x, k_cache, v_cache, pos0: int, rope=None):
        """``T`` consecutive decode positions in one pass: ``x`` [B, T, dim]
        at absolute positions ``pos0 .. pos0+T-1``; their K/V are written
        into the dense cache in place and each query attends causally to
        every cached position up to its own (speculative decoding's verify
        forward). A ring cache cannot take a contiguous span write."""
        T = x.shape[1]
        cache_len = k_cache.shape[1]
        if cache_len < self.maxlen:
            raise ValueError(
                "extend() needs a full-length cache; sliding-window models "
                "use a ring cache that cannot take a contiguous span write")
        q, k, v = self._project_qkv(x)
        if self.rope:
            q, k = _rotate(q, *rope), _rotate(k, *rope)
        pos0 = int(pos0)
        k_cache[:, pos0:pos0 + T] = k.to(k_cache.dtype)
        v_cache[:, pos0:pos0 + T] = v.to(v_cache.dtype)
        kp = torch.arange(cache_len, device=x.device)[None, :]
        qp = pos0 + torch.arange(T, device=x.device)[:, None]
        valid = kp <= qp                          # causal: cache <= own pos
        if self.attn_window is not None:
            valid = valid & (qp - kp < self.attn_window)
        return self._cached_attention(x, q, k_cache, v_cache, valid[None]), \
            k_cache, v_cache


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
                 device="cuda", param_dtype=None, remat: bool = False):
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
            remat=remat,
        )
        # the full forward (training, and the fused loss's hiddens) runs
        # each block through remat_block; the serving methods never do
        self.remat = bool(remat)
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
                         device=device, param_dtype=param_dtype,
                         maxlen=maxlen)
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
        return embed_lookup(self.embed.weight, tokens).to(self.dtype) \
            .to(torch.float32)

    def _embed_at(self, tokens, pos0: int = 0):
        """Embed ``tokens`` occupying positions ``pos0 .. pos0+L``."""
        with _trace.span("lm.embed"):
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
        return x + self.pos_table[self._row_positions(positions, tokens)]

    def _row_positions(self, positions, tokens):
        """Positions ``[B, T]`` of a row-offset block, clamped to
        ``maxlen - 1``: a padded chunk's trailing pad tokens may run past
        the table (as the JAX package's clamped gather); their outputs
        are never read."""
        T = tokens.shape[1]
        idx = positions[:, None] + torch.arange(T, device=tokens.device)
        return idx.clamp_(max=self.maxlen - 1)

    def _head(self, h):
        """Output projection over post-``ln_head`` hiddens: model-dtype
        matmul, f32 logits; tied mode contracts against the embedding."""
        h16 = h.to(self.dtype)
        if self.tie_embeddings:
            return torch.matmul(h16, self.embed.weight.to(self.dtype).t()) \
                .to(torch.float32)
        return self.lm_head(h16).to(torch.float32)

    def _logits(self, x):
        with _trace.span("lm.head"):
            return self._head(self.ln_head(x))

    def forward(self, tokens, mask=None, return_hidden: bool = False):
        """Logits ``[B, L, vocab]``, or with ``return_hidden`` the hidden
        states :meth:`hidden` gives (the fused loss's input, reachable
        through ``torch.func.functional_call``)."""
        h = self.hidden(tokens, mask)
        if return_hidden:
            return h
        with _trace.span("lm.head"):
            return self._head(h)

    def hidden(self, tokens, mask=None):
        """Final post-``ln_head`` hidden states ``[B, L, dim]`` (f32)."""
        x = self._embed_at(tokens)
        rope = self._rope_at(0, tokens.shape[1])
        for blk in self.blocks:
            x = (remat_block(blk, x, mask, rope) if self.remat
                 else blk(x, mask, rope))
        with _trace.span("lm.head"):
            return self.ln_head(x)

    def _rope_at(self, pos0: int, T: int):
        if self.pos_embedding != "rope":
            return None
        return self._rope(self.rope_table[pos0:pos0 + T])

    def prefill(self, tokens):
        """Full forward over the prompt: ``(logits, caches)`` with one dense
        ``(k, v)`` buffer pair a block, ``[B, cache_len, Hkv, Dh]`` in the
        model dtype, holding positions ``< L``. ``cache_len`` is
        ``maxlen``, or ``attn_window`` for a sliding-window model: then
        the buffer is a ring (slot ``p % window``) seeded with the last
        ``window`` prompt positions; slots never written hold position 0's
        K/V, which :meth:`DecoderBlock.step` masks."""
        B, L = tokens.shape
        hkv, dh = self.blocks[0].hkv, self.dim // self.heads
        cache_len = self.maxlen
        if self.attn_window is not None:
            cache_len = min(self.maxlen, int(self.attn_window))
        x = self._embed_at(tokens)
        rope = self._rope_at(0, L)
        ring_pos = None
        if cache_len < self.maxlen:
            slots = torch.arange(cache_len, device=tokens.device)
            # the absolute position each slot holds after the prompt;
            # negative: never written
            ring_pos = ((L - 1) - ((L - 1 - slots) % cache_len)).clamp(min=0)
        caches = []
        for blk in self.blocks:
            x, k, v = blk.prefill(x, None, rope)
            if ring_pos is not None:
                caches.append((k.index_select(1, ring_pos).to(self.dtype),
                               v.index_select(1, ring_pos).to(self.dtype)))
                continue
            kc = torch.zeros((B, cache_len, hkv, dh), dtype=self.dtype,
                             device=tokens.device)
            vc = torch.zeros_like(kc)
            kc[:, :L] = k.to(self.dtype)
            vc[:, :L] = v.to(self.dtype)
            caches.append((kc, vc))
        return self._logits(x), tuple(caches)

    def decode_step(self, tok, caches, pos: int):
        """One decode step: ``tok`` [B] at absolute position ``pos`` →
        ``(next-token logits [B, vocab], caches)``, the caches written in
        place."""
        x = self._embed_at(tok[:, None], pos)
        rope = self._rope_at(pos, 1)
        for blk, (kc, vc) in zip(self.blocks, caches):
            x, _, _ = blk.step(x, kc, vc, pos, rope)
        return self._logits(x)[:, 0], caches

    def extend(self, tokens, caches, pos0: int):
        """Multi-token cached decode: ``tokens`` [B, T] at absolute
        positions ``pos0 .. pos0+T-1`` → ``(logits [B, T, vocab],
        caches)``; ``logits[:, t]`` predicts position ``pos0+t+1``.
        Speculative decoding's verify forward."""
        x = self._embed_at(tokens, pos0)
        rope = self._rope_at(pos0, tokens.shape[1])
        for blk, (kc, vc) in zip(self.blocks, caches):
            x, _, _ = blk.extend(x, kc, vc, pos0, rope)
        return self._logits(x), caches

    def prefill_raw(self, tokens):
        """Full forward over the prompt: ``(logits, kvs)`` with per-block
        unpadded K/V ``[B, L, Hkv, Dh]`` (keys rotated under RoPE) — the
        serving engine scatters them into its block pools."""
        x = self._embed_at(tokens)
        rope = self._rope_at(0, tokens.shape[1])
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
            rope = self._rope(
                self.rope_table[self._row_positions(positions, tokens)])
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


def _check_decode_args(fn_name: str, model, prompt, max_new_tokens: int):
    """Shared validation of the decoding functions: ``(model, prompt int32
    [B, Lp] numpy)`` or raises."""
    if not isinstance(model, TransformerLM):
        raise TypeError(f"{fn_name}() needs a TransformerLM, got "
                        f"{type(model)}")
    prompt = np.asarray(prompt, np.int32)
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be [batch, length], got {prompt.shape}")
    if prompt.shape[1] + max_new_tokens > model.maxlen:
        raise ValueError(
            f"prompt length {prompt.shape[1]} + max_new_tokens "
            f"{max_new_tokens} exceeds the model's maxlen {model.maxlen}")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    return model, prompt


def _warp_fn(temperature: float, top_k: int | None,
             top_p: float | None = None):
    """Logit warping for sampling: temperature scale, then top-k, then the
    minimal nucleus (top-p); filtered tokens at -1e30, f32. Every token
    whose warped logit equals a cutoff survives (strict ``scaled <
    cutoff`` filters), so ties at a boundary widen the support. Requires
    temperature > 0."""

    def warp(logits):
        scaled = logits.to(torch.float32) / temperature
        if top_k is not None:
            kth = torch.topk(scaled, int(top_k), dim=-1).values[..., -1:]
            scaled = scaled.masked_fill(scaled < kth, -1e30)
        if top_p is not None and top_p < 1.0:
            desc = torch.sort(scaled, dim=-1, descending=True).values
            probs = torch.softmax(desc, dim=-1)
            # keep a token iff the mass strictly before it is < top_p
            keep = torch.cumsum(probs, dim=-1) - probs < top_p
            cutoff = torch.where(keep, desc, torch.full_like(desc, np.inf)) \
                .amin(dim=-1, keepdim=True)
            scaled = scaled.masked_fill(scaled < cutoff, -1e30)
        return scaled

    return warp


def _categorical(logits, generator):
    """One draw per row from ``softmax(logits)`` (-1e30 and -inf never
    drawn) with ``generator``."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    shape = probs.shape
    tok = torch.multinomial(probs.reshape(-1, shape[-1]), 1,
                            generator=generator)
    return tok.reshape(shape[:-1])


def _sample_fn(temperature: float, top_k: int | None,
               top_p: float | None = None):
    """``sample(logits, generator)``: argmax for temperature 0, else a draw
    from the warped distribution (:func:`_warp_fn`)."""
    if temperature == 0.0:
        def sample(logits, generator):
            return torch.argmax(logits, dim=-1)

        return sample
    warp = _warp_fn(temperature, top_k, top_p)

    def sample(logits, generator):
        return _categorical(warp(logits), generator)

    return sample


def _generator(device, seed: int):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _as_tokens(prompt, device):
    return torch.from_numpy(prompt.astype(np.int64)).to(device)


def _with_prompt(prompt, new) -> np.ndarray:
    return np.concatenate(
        [prompt, new.cpu().numpy().astype(np.int32)], axis=-1)


@torch.inference_mode()
def generate(model, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, seed: int = 0,
             eos_id: int | None = None):
    """Autoregressive decoding over the dense KV cache: ``prompt`` [B, Lp]
    int32 → [B, Lp+new] int32 numpy. One batched prefill writes the caches
    for the whole prompt, then one :meth:`TransformerLM.decode_step` a
    token. ``temperature=0`` is greedy; otherwise a draw per token from the
    temperature/top-k/top-p warped distribution (:func:`_warp_fn`) with a
    ``torch.Generator`` seeded with ``seed`` on the model's device, so a
    stream is deterministic per seed on a given device.

    ``eos_id`` stops a row at its first end-of-sequence token: the row pads
    with ``eos_id`` from there on, and decoding stops once every row has
    finished (one host read a step). Rows draw from the same generator
    with and without ``eos_id``, so a sampled stream equals the eos-free
    one up to its first ``eos_id``. Count real tokens with
    :func:`distkeras_tpu_torch.serving.per_row_new_token_counts`."""
    module, prompt = _check_decode_args("generate", model, prompt,
                                        max_new_tokens)
    if top_k is not None and not 1 <= int(top_k) <= module.vocab:
        raise ValueError(
            f"top_k must be in [1, vocab={module.vocab}], got {top_k}")
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if eos_id is not None and not 0 <= int(eos_id) < module.vocab:
        raise ValueError(f"eos_id {eos_id} outside vocab {module.vocab}")
    sample = _sample_fn(float(temperature), top_k,
                        None if top_p is None else float(top_p))
    dev = module.device
    gen = _generator(dev, seed)
    n_new = int(max_new_tokens)
    lp = prompt.shape[1]
    logits, caches = module.prefill(_as_tokens(prompt, dev))
    tok = sample(logits[:, -1], gen)
    if eos_id is None:
        out = [tok]
        for n in range(1, n_new):
            logits, caches = module.decode_step(tok, caches, lp + n - 1)
            tok = sample(logits, gen)
            out.append(tok)
        return _with_prompt(prompt, torch.stack(out, dim=1))
    eos = int(eos_id)
    out = torch.full((prompt.shape[0], n_new), eos, dtype=torch.int64,
                     device=dev)
    out[:, 0] = tok
    done = tok == eos
    n = 1
    while n < n_new and not bool(done.all()):
        logits, caches = module.decode_step(tok, caches, lp + n - 1)
        tok = sample(logits, gen).masked_fill(done, eos)  # pad after EOS
        out[:, n] = tok
        done = done | (tok == eos)
        n += 1
    return _with_prompt(prompt, out)


def _lockstep_emit(out, n: int, props, cut, a: int):
    """Write one round's ``[B, K+1]`` block at column ``n``: the
    proposals below the batch-minimum accepted length ``a``, each row's
    cut token ``cut`` [B] at ``a``; columns past ``a`` are overwritten by
    the next round or trimmed."""
    B, K = props.shape
    emit = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    emit[:, a] = cut
    out[:, n:n + K + 1] = emit


def _spec_round_stats(a_row, n: int, max_new: int, K: int):
    """(accepted, proposed) of one round summed over rows and clamped to
    the emission budget: a final round's overhang never lands in the
    output, so it does not count."""
    room = max_new - n
    return (int(torch.clamp(a_row, max=room).sum()),
            a_row.shape[0] * min(K, room))


def _draft_close(dm, tok, d_caches, pos: int):
    """The round's (K+1)-th draft step: write the last proposal ``tok``
    into the draft's cache at ``pos`` (its logits are not used). The
    verify writes the target's cache through ``pos``; without this step a
    fully accepted round would leave the draft's cache unwritten there for
    the rest of the stream, as the engine's extra step also prevents."""
    _, d_caches = dm.decode_step(tok, d_caches, pos)
    return d_caches


def _speculative_greedy(tm, dm, p, max_new: int, K: int):
    B, lp = p.shape
    t_logits, t_caches = tm.prefill(p)
    _, d_caches = dm.prefill(p)
    last = torch.argmax(t_logits[:, -1], dim=-1)
    # the emission block of the last round may overhang the budget
    out = torch.zeros((B, max_new + K + 1), dtype=torch.int64,
                      device=p.device)
    out[:, 0] = last
    n, rounds, accepted, proposed = 1, 0, 0, 0
    while n < max_new:
        cur = lp + n - 1   # absolute position of `last`, not yet cached
        tok, props = last, []
        for i in range(K):
            lg, d_caches = dm.decode_step(tok, d_caches, cur + i)
            tok = torch.argmax(lg, dim=-1)
            props.append(tok)
        d_caches = _draft_close(dm, tok, d_caches, cur + K)
        props = torch.stack(props, dim=1)          # [B, K]
        # verify: logits[:, t] is the target's pick for position cur+t+1
        t_logits, t_caches = tm.extend(
            torch.cat([last[:, None], props], dim=1), t_caches, cur)
        g = torch.argmax(t_logits, dim=-1)         # [B, K+1]
        match = (props == g[:, :K]).to(torch.int64)
        a_row = torch.cumprod(match, dim=1).sum(dim=1)
        # lockstep on the batch minimum: every row's first `a` proposals
        # are its own greedy tokens, so props[:, :a] + g[:, a] is exact
        a = int(a_row.min())
        last = g[:, a]
        _lockstep_emit(out, n, props, last, a)
        acc, prop = _spec_round_stats(a_row, n, max_new, K)
        rounds, accepted, proposed = rounds + 1, accepted + acc, \
            proposed + prop
        n += a + 1
    return out[:, :max_new], rounds, accepted, proposed


def _speculative_sampled(tm, dm, p, max_new: int, K: int, warp, gen):
    B, lp = p.shape
    t_logits, t_caches = tm.prefill(p)
    _, d_caches = dm.prefill(p)
    last = _categorical(warp(t_logits[:, -1]), gen)
    out = torch.zeros((B, max_new + K + 1), dtype=torch.int64,
                      device=p.device)
    out[:, 0] = last
    rows = torch.arange(B, device=p.device)
    n, rounds, accepted, proposed = 1, 0, 0, 0
    while n < max_new:
        cur = lp + n - 1
        tok, props, q_lp = last, [], []
        for i in range(K):
            lg, d_caches = dm.decode_step(tok, d_caches, cur + i)
            wl = warp(lg)
            tok = _categorical(wl, gen)
            props.append(tok)
            q_lp.append(torch.log_softmax(wl, dim=-1))
        d_caches = _draft_close(dm, tok, d_caches, cur + K)
        props = torch.stack(props, dim=1)          # [B, K]
        q_lp = torch.stack(q_lp, dim=1)            # [B, K, V]
        t_logits, t_caches = tm.extend(
            torch.cat([last[:, None], props], dim=1), t_caches, cur)
        p_lp = torch.log_softmax(warp(t_logits), dim=-1)   # [B, K+1, V]
        # accept x_i iff log u < log p(x_i) - log q(x_i)
        idx = props[..., None]
        p_at = torch.gather(p_lp[:, :K], 2, idx)[..., 0]
        q_at = torch.gather(q_lp, 2, idx)[..., 0]
        u = torch.rand((B, K), generator=gen, device=p.device)
        accept = (torch.log(u.clamp(min=1e-37)) < p_at - q_at) \
            .to(torch.int64)
        a_row = torch.cumprod(accept, dim=1).sum(dim=1)
        a = int(a_row.min())
        # the cut position's token per row: a fresh p_K draw when every
        # proposal stood (a == K); else the row's own proposal where it
        # accepted position a, or a draw from the residual
        # norm(max(p - q, 0)), falling back to p where it has no mass
        a_k = min(a, K - 1)
        p_cut, q_cut = p_lp[:, a_k], q_lp[:, a_k]
        residual = torch.clamp(torch.exp(p_cut) - torch.exp(q_cut), min=0.0)
        has_mass = residual.sum(dim=-1, keepdim=True) > 0
        res_logits = torch.where(
            has_mass,
            torch.where(residual > 0, torch.log(residual),
                        torch.full_like(residual, -np.inf)),
            p_cut)
        res_tok = _categorical(res_logits, gen)
        p_k_tok = _categorical(p_lp[:, K], gen)
        if a == K:
            cut = p_k_tok
        else:
            cut = torch.where(accept[rows, a_k].bool(), props[rows, a_k],
                              res_tok)
        _lockstep_emit(out, n, props, cut, a)
        last = cut
        acc, prop = _spec_round_stats(a_row, n, max_new, K)
        rounds, accepted, proposed = rounds + 1, accepted + acc, \
            proposed + prop
        n += a + 1
    return out[:, :max_new], rounds, accepted, proposed


@torch.inference_mode()
def speculative_generate(target, draft, prompt, max_new_tokens: int, *,
                         spec_tokens: int = 4, temperature: float = 0.0,
                         top_k: int | None = None,
                         top_p: float | None = None, seed: int = 0):
    """Speculative decoding (Leviathan et al. 2023): the ``draft`` model
    proposes ``spec_tokens`` tokens one cached step at a time, and the
    ``target`` scores all of them in one :meth:`TransformerLM.extend` and
    keeps an accepted prefix plus a correction token. The draft takes one
    more step a round, which writes its last proposal into its own cache,
    as the serving engine's draft does; the JAX package's dense path
    skips it, so after a fully accepted round its draft attends to an
    unwritten position and its ``rounds``/``accepted`` can differ from
    these (never its tokens).

    ``temperature=0`` is the greedy scheme: proposals stand while they
    equal the target's own argmax, so the output is the target's greedy
    :func:`generate` stream (the verify forward and plain decode share one
    block body; in f32 they agree except at exact ties, in bf16 a tie may
    round one ulp apart). ``temperature>0`` is rejection sampling: the
    draft samples each proposal from its warped distribution ``q``, a
    proposal ``x`` stands with probability ``min(1, p(x)/q(x))`` under the
    target's warped ``p``, and the first rejection is replaced by a draw
    from ``norm(max(p - q, 0))``; each emitted token is then distributed
    as ``p``, the distribution plain sampled :func:`generate` draws from.
    Deterministic for a fixed ``seed`` on a given device.

    Batched prompts run in lockstep: each round every row advances by the
    batch-minimum accepted length. Returns ``(tokens [B, Lp+new] int32,
    stats)``: ``rounds`` (verify passes), ``proposed`` and ``accepted``
    summed per row and clamped to the budget (a row past the batch
    minimum re-proposes, and recounts, its overhang next round), and
    ``acceptance = accepted / proposed``. Sliding-window models are
    refused: a ring cache cannot take the verify block's span write."""
    tm, prompt = _check_decode_args("speculative_generate", target, prompt,
                                    max_new_tokens)
    dm = draft
    if not isinstance(dm, TransformerLM):
        raise TypeError(f"speculative_generate() needs a TransformerLM "
                        f"draft, got {type(dm)}")
    if dm.vocab != tm.vocab:
        raise ValueError(f"draft vocab {dm.vocab} != target vocab "
                         f"{tm.vocab}")
    if tm.attn_window is not None or dm.attn_window is not None:
        raise ValueError(
            "speculative_generate does not support sliding-window models "
            "(ring caches cannot take the verify block's span write)")
    K = int(spec_tokens)
    if K < 1:
        raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
    need = prompt.shape[1] + int(max_new_tokens) + K - 1
    for name, m in (("target", tm), ("draft", dm)):
        if need > m.maxlen:
            raise ValueError(
                f"prompt {prompt.shape[1]} + max_new_tokens "
                f"{max_new_tokens} + spec_tokens {K} - 1 = {need} exceeds "
                f"the {name}'s maxlen {m.maxlen} (the verify block probes "
                f"spec_tokens positions past the emitted stream)")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and not 1 <= int(top_k) <= tm.vocab:
        raise ValueError(
            f"top_k must be in [1, vocab={tm.vocab}], got {top_k}")
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if dm.device != tm.device:
        raise ValueError(f"the draft lives on {dm.device}, the target on "
                         f"{tm.device}")
    p = _as_tokens(prompt, tm.device)
    if temperature == 0.0:
        new, rounds, accepted, proposed = _speculative_greedy(
            tm, dm, p, int(max_new_tokens), K)
    else:
        warp = _warp_fn(float(temperature), top_k,
                        None if top_p is None else float(top_p))
        new, rounds, accepted, proposed = _speculative_sampled(
            tm, dm, p, int(max_new_tokens), K, warp,
            _generator(tm.device, seed))
    stats = {
        "rounds": rounds,
        "proposed": proposed,
        "accepted": accepted,
        "acceptance": accepted / proposed if proposed else 0.0,
    }
    return _with_prompt(prompt, new), stats


@torch.inference_mode()
def beam_search(model, prompt, max_new_tokens: int, *, beams: int = 4,
                length_penalty: float = 0.0, eos_id: int | None = None):
    """KV-cached beam search: ``prompt`` [B, Lp] int32 → ``(tokens [B,
    beams, Lp+new] int32, scores [B, beams] f32)``, best beam first.

    The dense caches are tiled to ``B·beams`` rows after the prefill and
    gathered by surviving parent every step. ``scores`` are summed token
    log-probabilities; with ``length_penalty`` α > 0 they are
    GNMT-normalised (``score / ((5+len)/6)^α``, ``len`` up to and
    including the first ``eos_id``). ``eos_id`` finishes a beam: its score
    freezes and it pads with ``eos_id`` while staying a candidate.
    ``beams=1`` is greedy :func:`generate`."""
    module, prompt = _check_decode_args("beam_search", model, prompt,
                                        max_new_tokens)
    if not 1 <= int(beams) <= module.vocab:
        raise ValueError(
            f"beams must be in [1, vocab={module.vocab}], got {beams}")
    if eos_id is not None and not 0 <= int(eos_id) < module.vocab:
        raise ValueError(f"eos_id {eos_id} outside vocab {module.vocab}")
    K, V = int(beams), module.vocab
    n_new = int(max_new_tokens)
    dev = module.device
    B, lp = prompt.shape
    logits, caches = module.prefill(_as_tokens(prompt, dev))
    logp0 = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
    # eos stays a legal first pick: it finishes that beam at once
    scores, tok0 = torch.topk(logp0, K, dim=-1)            # [B, K]
    caches = tuple((kc.repeat_interleave(K, dim=0),
                    vc.repeat_interleave(K, dim=0)) for kc, vc in caches)
    toks = torch.zeros((B, K, n_new), dtype=torch.int64, device=dev)
    toks[:, :, 0] = tok0
    if eos_id is not None:
        finished = tok0 == int(eos_id)
        # a finished beam emits only eos, at zero cost: its score freezes
        only_eos = torch.full((V,), -1e30, device=dev)
        only_eos[int(eos_id)] = 0.0
    else:
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    row0 = torch.arange(B, device=dev)[:, None] * K
    for i in range(1, n_new):
        logits, caches = module.decode_step(toks[:, :, i - 1].reshape(B * K),
                                            caches, lp + i - 1)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1) \
            .reshape(B, K, V)
        if eos_id is not None:
            logp = torch.where(finished[:, :, None], only_eos, logp)
        cand = scores[:, :, None] + logp                     # [B, K, V]
        scores, flat = torch.topk(cand.reshape(B, K * V), K, dim=-1)
        parent, tok_new = flat // V, flat % V                # [B, K]
        # beam-major state follows the surviving parents
        rows = (row0 + parent).reshape(-1)
        caches = tuple((kc.index_select(0, rows), vc.index_select(0, rows))
                       for kc, vc in caches)
        toks = torch.gather(toks, 1, parent[:, :, None].expand(-1, -1, n_new))
        toks[:, :, i] = tok_new
        finished = torch.gather(finished, 1, parent)
        if eos_id is not None:
            finished = finished | (tok_new == int(eos_id))
    ranked = scores
    if length_penalty:
        if eos_id is not None:
            hit = toks == int(eos_id)
            first = torch.argmax(hit.to(torch.int64), dim=2)
            length = torch.where(hit.any(dim=2), first + 1,
                                 torch.full_like(first, n_new))
        else:
            length = torch.full((B, K), n_new, device=dev)
        norm = ((5.0 + length.to(torch.float32)) / 6.0) \
            ** float(length_penalty)
        ranked = scores / norm
    order = torch.argsort(-ranked, dim=1, stable=True)
    ranked = torch.gather(ranked, 1, order)
    toks = torch.gather(toks, 1, order[:, :, None].expand(-1, -1, n_new))
    full = np.concatenate(
        [np.broadcast_to(prompt[:, None], (B, K, lp)),
         toks.cpu().numpy().astype(np.int32)], axis=2)
    return full, ranked.cpu().numpy()


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
    at a time, so the ``[B, L, vocab]`` logits never exist. ``remat=True``
    recomputes each block's activations in the backward pass of the
    training forward and the fused loss (flax's ``nn.remat`` on
    ``__call__``); parameter names are unchanged. The template module
    lives on the CPU; the trainer places params and state on its
    device."""
    module = TransformerLM(
        vocab=vocab, maxlen=maxlen, dim=dim, heads=heads, depth=depth,
        dtype=dtype, attn_impl=attn_impl, attn_window=attn_window,
        kv_heads=kv_heads, pos_embedding=pos_embedding,
        tie_embeddings=tie_embeddings, device="cpu",
        param_dtype=torch.float32, remat=remat)
    spec = from_module(module, name="transformer_lm",
                       example=torch.zeros((1, maxlen), dtype=torch.int64))
    if not fused_ce:
        return spec
    if tie_embeddings:
        # the head IS the embedding: contract against its transpose
        def head(params):
            return params["embed.weight"].to(dtype).t(), None
    else:
        def head(params):
            return (params["lm_head.weight"].to(dtype).t(),
                    params["lm_head.bias"])
    fused = fused_ce_loss(per_thread(module), dtype, head, ce_chunk)
    return dataclasses.replace(
        spec, fused_losses={"sparse_softmax_cross_entropy": fused})


def fused_ce_loss(module_here, dtype, head, chunk: int):
    """A spec's fused loss ``fused(params, state, x, y, training,
    mask=None) -> (loss, state)``: the chunked cross-entropy of
    ``ops/fused_ce.py`` over the module's hidden states (its forward with
    ``return_hidden=True``, through ``functional_call`` on
    ``module_here()``) in ``dtype`` and the head ``head(params) ->
    (kernel [D, V] in dtype, bias [V] or None)``, ``chunk`` rows of logits
    at a time. ``mask``: per-row validity ``[B]`` covers every token of
    its row; ``[B, L]`` passes through."""
    chunk = int(chunk)

    def fused(params, state, x, y, training, mask=None):
        h = torch.func.functional_call(module_here(), {**params, **state},
                                       (x,), {"return_hidden": True})
        b_, l_, d_ = h.shape
        token_mask = None
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32,
                                   device=h.device)
            token_mask = (mask.repeat_interleave(l_) if mask.dim() == 1
                          else mask.reshape(b_ * l_))
        kernel, bias = head(params)
        loss = chunked_softmax_cross_entropy(
            h.to(dtype).reshape(b_ * l_, d_), y.reshape(b_ * l_), kernel,
            bias, mask=token_mask, chunk=chunk)
        return loss, state

    return fused


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


def quantize_state_dict(qmodel: TransformerLM, tree: dict) -> dict:
    """The state dict of the int8 ``qmodel`` (``quant=True``) that carries
    the float LM weights ``tree`` (a float model's names, numpy arrays or
    tensors): each QDense's ``weight`` is cast to its float dtype on
    ``qmodel``'s device and quantized as :func:`quantize_lm` does;
    embeddings, LayerNorms and biases pass through. Bit-equal to
    ``quantize_lm`` of a float model loaded from ``tree``."""
    if not getattr(qmodel, "quant", False):
        raise ValueError("quantize_state_dict() needs an int8 model "
                         "(quant=True)")
    out = {k: torch.as_tensor(v) for k, v in tree.items()}
    with torch.no_grad():
        for name, mod in qmodel.named_modules():
            if isinstance(mod, QDense):
                w = out.pop(f"{name}.weight").to(
                    device=mod.kernel_q.device, dtype=mod.bias.dtype)
                qt = quantize(w, axis=1)
                out[f"{name}.kernel_q"], out[f"{name}.scale"] = qt.q, qt.scale
    return out



def next_token_dataset(tokens: np.ndarray):
    """``[N, L+1]`` token rows → a Dataset with ``features`` ``[N, L]`` and
    the next-token ``label`` ``[N, L]``: the LM's training columns, where
    the JAX package's LM examples find them
    (:func:`distkeras_tpu_torch.data.next_token_dataset`)."""
    from distkeras_tpu_torch.data import next_token_dataset as columns

    return columns(tokens)
