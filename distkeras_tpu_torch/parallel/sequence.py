"""Sequence parallelism: ring attention over a mesh axis. Port of
``distkeras_tpu/parallel/sequence.py``.

Sequences are split along their length over the ``sp`` ranks; each rank
holds one Q/K/V block and computes exact attention by rotating the K/V
blocks (and the key mask) around the ring with ``batch_isend_irecv``,
folding each into an online softmax in f32 with the shared
``band_predicate`` (Liu et al. 2023). Under a sliding window only the hops
the band needs are made (:func:`ring_window_steps`): a window of one
block makes none. The JAX ring is plain ``jnp`` (no Pallas kernel), and
so is this fold.

JAX differentiates the ring by transposing ``ppermute``. Here the
backward is written: :class:`_RingAttention` rotates the K/V blocks again
in the forward's order, recomputes each block's probabilities from the
saved log-sum-exp, and carries each block's dK/dV with it, handing the
sums back to their owners at the end of each chain.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.ops.flash_attention import (
    attention_reference,
    band_predicate,
)
from distkeras_tpu_torch.parallel import mesh as mesh_mod

_NEG = -1e9  # finite "masked" score: keeps the online softmax NaN-free


def ring_window_steps(axis_size: int, block_len: int, causal: bool,
                      window: int | None) -> tuple[int, int]:
    """Ring trip counts under a sliding window, ``(fwd, bwd)``: ``fwd``
    counts the self block plus the lower-position blocks reached by
    rotating forward, ``bwd`` the higher-position blocks of the reverse
    chain (0 when causal). Unwindowed: ``(axis_size, 0)``. A window needs
    ``1 + ceil((window-1)/block_len)`` blocks a side; ``fwd + bwd <=
    axis_size`` always."""
    if window is None:
        return axis_size, 0
    side_hops = -(-(window - 1) // block_len)  # ceil; 0 when window == 1
    fwd = min(axis_size, 1 + side_hops)
    if causal:
        return fwd, 0
    return fwd, min(axis_size - fwd, side_hops)


def _valid(q_pos, src, Lk, km_blk, causal, window, shape):
    k_pos = src * Lk + torch.arange(Lk, device=q_pos.device)
    valid = band_predicate(q_pos[:, None], k_pos[None, :], causal, window)
    if valid is not None:
        valid = valid[None, None].expand(shape)
    if km_blk is not None:
        km = km_blk.to(torch.bool)[:, None, None, :]
        valid = km.expand(shape) if valid is None else (valid & km)
    return valid


def _chains(idx, N, n_fwd, n_bwd):
    """``[(shift, [src of each hop])]`` of the forward and reverse chains."""
    return [(1, [(idx - i - 1) % N for i in range(n_fwd - 1)]),
            (-1, [(idx + i + 1) % N for i in range(n_bwd)])]


def _ring_forward(q, k, v, km, group, causal, scale, window):
    N = mesh_mod._gsize(group)
    idx = torch.distributed.get_rank(group) if group is not None else 0
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    qf = q.to(torch.float32) * scale
    q_pos = idx * Lq + torch.arange(Lq, device=q.device)
    n_fwd, n_bwd = ring_window_steps(N, Lk, causal, window)
    m = torch.full((B, H, Lq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)

    def fold(src, kb, vb, kmb, m, l, o):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(torch.float32))
        valid = _valid(q_pos, src, Lk, kmb, causal, window, s.shape)
        if valid is not None:
            s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vb.to(torch.float32))
        return m_new, l, o

    m, l, o = fold(idx, k, v, km, m, l, o)
    for step, srcs in _chains(idx, N, n_fwd, n_bwd):
        blk = [k, v] + ([km] if km is not None else [])
        for src in srcs:
            blk = mesh_mod.shift(blk, group, step)
            m, l, o = fold(src, blk[0], blk[1],
                           blk[2] if km is not None else None, m, l, o)
    l = torch.clamp(l, min=1e-30)
    out = (o / l[..., None]).movedim(1, 2).to(q.dtype)      # [B, Lq, H, D]
    return out, m + torch.log(l)                            # lse [B, H, Lq]


def _ring_backward(q, k, v, km, out, lse, dout, group, causal, scale,
                   window):
    N = mesh_mod._gsize(group)
    idx = torch.distributed.get_rank(group) if group is not None else 0
    Lq, Lk = q.shape[1], k.shape[1]
    qs = q.to(torch.float32) * scale
    do = dout.to(torch.float32)
    delta = torch.einsum("bqhd,bqhd->bhq", do, out.to(torch.float32))
    q_pos = idx * Lq + torch.arange(Lq, device=q.device)
    n_fwd, n_bwd = ring_window_steps(N, Lk, causal, window)
    dqs = torch.zeros_like(qs)

    def grads(src, kb, vb, kmb):
        """dK, dV of block ``src`` from my queries; dq accumulates."""
        nonlocal dqs
        kf, vf = kb.to(torch.float32), vb.to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
        p = torch.exp(s - lse[..., None])
        valid = _valid(q_pos, src, Lk, kmb, causal, window, s.shape)
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
        ds = p * (dp - delta[..., None])
        dqs = dqs + torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
        return dk, dv

    dk, dv = grads(idx, k, v, km)
    for step, srcs in _chains(idx, N, n_fwd, n_bwd):
        if not srcs:
            continue
        blk = [k, v] + ([km] if km is not None else [])
        acc = [torch.zeros_like(dk), torch.zeros_like(dv)]
        for src in srcs:
            moved = mesh_mod.shift(blk + acc, group, step)
            blk, acc = moved[:len(blk)], moved[len(blk):]
            gk, gv = grads(src, blk[0], blk[1],
                           blk[2] if km is not None else None)
            acc = [acc[0] + gk, acc[1] + gv]
        # the sums travelled with their block: hand them back to its owner
        back = mesh_mod.shift(acc, group, -step * len(srcs))
        dk, dv = dk + back[0], dv + back[1]
    return (dqs * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, key_mask, group, causal, scale, window):
        km = None if key_mask is None else key_mask.to(torch.float32)
        return _ring_forward(q, k, v, km, group, causal, scale, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_mask, group, causal, scale, window = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        km = None if key_mask is None else key_mask.to(torch.float32)
        ctx.has_mask = km is not None
        ctx.save_for_backward(q, k, v, out, lse,
                              *([km] if km is not None else []))
        ctx.args = (group, causal, scale, window)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, *rest = ctx.saved_tensors
        km = rest[0] if ctx.has_mask else None
        dq, dk, dv = _ring_backward(q, k, v, km, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def ring_attention_shard(q, k, v, key_mask=None, *, group, causal=False,
                         scale=None, window=None):
    """The per-rank ring body: my Q block ``[B, Lq, H, D]`` against the
    K/V blocks of every rank of ``group`` (only the band's blocks under a
    window), my queries at positions ``rank·Lq …``. ``key_mask [B, Lk]``
    is this rank's block of the key mask, rotated with K/V. Rows whose
    keys are all masked give zeros. Differentiable in q, k and v."""
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out, _ = _RingAttention.apply(q, k, v, key_mask, group, bool(causal),
                                  float(scale),
                                  None if window is None else int(window))
    return out


def ring_attention(q, k, v, mesh, axis: str | None = None,
                   causal: bool = False, scale=None, key_mask=None,
                   window: int | None = None):
    """Exact attention with Q/K/V split along the sequence over ``axis``:
    every rank passes the whole ``[B, L, H, D]`` (``L`` divisible by the
    axis size), computes its block through the ring and returns the whole
    output, the same on every rank; the gradients of q, k and v come back
    whole on every rank too. Matches :func:`attention_reference`."""
    axis = axis or mesh.axis_names[0]
    n = mesh.size(axis)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by "
                         f"mesh axis '{axis}' of size {n}")
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window >= q.shape[1]:
            window = None  # the band covers everything: the full ring
    g = mesh.group(axis)
    if key_mask is not None:
        km = torch.as_tensor(key_mask)
        L = km.shape[1] // n
        key_mask = km[:, mesh.index(axis) * L:(mesh.index(axis) + 1) * L]
    q, k, v = (mesh_mod.split_to(t, g, 1) for t in (q, k, v))
    out = ring_attention_shard(q, k, v, key_mask, group=g, causal=causal,
                               scale=scale, window=window)
    return mesh_mod.gather_from(out, g, 1)


__all__ = ["attention_reference", "ring_attention", "ring_attention_shard",
           "ring_window_steps"]
