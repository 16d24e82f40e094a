"""Flash-attention forward on PyTorch + CUDA.

Port of ``distkeras_tpu/ops/flash_attention.py`` (forward only) and of
``parallel/sequence.py::attention_reference``. The kernel
(``csrc/flash_attention.cu``) keeps the TPU kernel's contract — causal,
sliding ``window`` via :func:`band_predicate` with out-of-band tiles
skipped, optional ``key_mask``, grouped-query attention read through the
``h // group`` head map, masked scores at ``-1e9``, fully masked rows
giving 0 — and emits the output and the per-row log-sum-exp. It takes any
sequence length, so serving prefill (prompts padded to a block multiple,
not a 128 multiple) runs the kernel too.

Layouts follow the JAX package: q ``[B, L, H, D]``, k/v ``[B, L, Hkv, D]``,
lse ``[B·H, L]``.
"""

from __future__ import annotations

import ctypes

import torch

from distkeras_tpu_torch.ops import _build

_NEG = -1e9  # finite mask value: keeps the softmax NaN-free


def band_predicate(q_pos, k_pos, causal, window):
    """Query ``i`` sees key ``j`` iff ``j <= i`` when causal, ``i - j <
    window`` (and ``j - i < window`` when bidirectional) under a window.
    ``q_pos``/``k_pos`` broadcast; None when everything is valid."""
    if not causal and window is None:
        return None
    valid = None
    if causal:
        valid = q_pos >= k_pos
    if window is not None:
        band = q_pos - k_pos < window
        if not causal:
            band &= k_pos - q_pos < window
        valid = band if valid is None else (valid & band)
    return valid


def _gqa_groups(q, k):
    """Validated GQA group size: q heads per shared k/v head (1 = MHA)."""
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {Hkv}")
    return H // Hkv


def _kv_row(b, H, Hkv):
    """Row over B·H → k/v row over B·Hkv: query head h reads shared head
    h // group (the [Hkv, group] factoring of the LM's decode)."""
    if H == Hkv:
        return b
    return (b // H) * Hkv + (b % H) // (H // Hkv)


def _canonical_window(window, L):
    """Validate ``window``; a band covering the whole sequence is None."""
    if window is None:
        return None
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return None if window >= L else window


def attention_reference(q, k, v, causal: bool = False, scale=None,
                        key_mask=None, window: int | None = None,
                        return_lse: bool = False):
    """Plain softmax attention: q/k/v ``[B, L, H, D]`` (k/v may hold fewer
    GQA heads) → ``[B, L, H, D]``; ``key_mask`` ``[B, Lk]`` (1 = attend).
    Same dtype path as the JAX reference: scores in the input dtype, then
    f32 scale and softmax, probabilities cast back to v's dtype. Rows whose
    whole band is masked give zeros. ``return_lse`` also returns the
    per-row log-sum-exp ``[B·H, L]`` the flash kernel emits (masked scores
    at -1e9 in the max, l floored at 1e-30)."""
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    rep = _gqa_groups(q, k)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    Lq, Lk = s.shape[-2], s.shape[-1]
    band = band_predicate(torch.arange(Lq, device=q.device)[:, None],
                          torch.arange(Lk, device=q.device)[None, :],
                          causal, window)
    valid = None if band is None else band[None, None]
    if key_mask is not None:
        km = key_mask[:, None, None, :].to(torch.bool)
        valid = km if valid is None else (valid & km)
    if valid is not None:
        s = s.masked_fill(~valid, _NEG)
    p = torch.softmax(s, dim=-1)
    if key_mask is not None:
        p = p * valid
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    if valid is not None:
        e = e * valid
    lse = m + torch.log(torch.clamp(e.sum(dim=-1), min=1e-30))
    B, H = q.shape[0], q.shape[2]
    return out, lse.reshape(B * H, Lq)


def _fa_forward_plain(q, k, v, key_mask, *, scale, causal, window):
    """Plain version of the kernel: the reference in f32 (the kernel widens
    every tile to f32), output cast back to q's dtype."""
    out, lse = attention_reference(
        q.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
        causal=causal, scale=scale, key_mask=key_mask, window=window,
        return_lse=True)
    return out.to(q.dtype), lse


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dk_flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, i, i, i, vp]
    lib.dk_flash_attention_fwd.restype = i
    lib.dk_flash_attention_max_head_dim.argtypes = []
    lib.dk_flash_attention_max_head_dim.restype = i


def _fa_forward_cuda(q, k, v, key_mask, *, scale, causal, window):
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, L, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, L, Hkv, D] = {(B, L, Hkv, D)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if not all(t.is_cuda and t.device == q.device for t in (k, v)):
        raise ValueError("q, k and v must lie on the same CUDA device")
    lib = _build.load("flash_attention", _bind)
    if D > lib.dk_flash_attention_max_head_dim():
        raise ValueError(f"flash kernel takes head dim <= "
                         f"{lib.dk_flash_attention_max_head_dim()}, got {D}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    km = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (B, L):
            raise ValueError(f"key_mask must be [B, L] = {(B, L)}, got "
                             f"{tuple(key_mask.shape)}")
        km = key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B * H, L), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dk_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if km is None else km.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, L, H, Hkv, D, float(scale), int(bool(causal)),
        0 if window is None else int(window), _DTYPE_CODE[q.dtype], stream,
    )
    _build.check(err, "flash_attention")
    _fa_forward.launches += 1
    return out, lse


def _fa_forward(q, k, v, key_mask, *, scale, causal, window=None):
    """(out ``[B, L, H, D]``, lse ``[B·H, L]``): the kernel on a CUDA
    tensor (or raise), the plain version on a CPU tensor. ``launches``
    counts kernel launches."""
    _gqa_groups(q, k)
    if q.device.type == "cpu":
        return _fa_forward_plain(q, k, v, key_mask, scale=scale,
                                 causal=causal, window=window)
    if q.device.type == "cuda":
        return _fa_forward_cuda(q, k, v, key_mask, scale=scale,
                                causal=causal, window=window)
    raise ValueError(f"flash attention runs on cpu or cuda tensors, got "
                     f"{q.device}")


_fa_forward.launches = 0


def flash_attention(q, k, v, causal: bool = False, scale=None, key_mask=None,
                    window: int | None = None):
    """Flash attention with the contract of :func:`attention_reference`:
    ``[B, L, H, D]`` in and out, optional ``key_mask`` ``[B, L]``,
    sliding ``window``."""
    out, _ = _fa_forward(
        q, k, v, key_mask,
        scale=float(scale if scale is not None else q.shape[-1] ** -0.5),
        causal=bool(causal), window=_canonical_window(window, q.shape[1]),
    )
    return out


def attention(q, k, v, causal: bool = False, scale=None, key_mask=None,
              impl: str = "auto", window: int | None = None):
    """``impl="reference"`` runs :func:`attention_reference`; ``"flash"``
    and ``"auto"`` run :func:`flash_attention` — the kernel on a CUDA
    tensor at any length, its plain version on a CPU tensor."""
    if impl not in ("flash", "reference", "auto"):
        raise ValueError(f"unknown attention impl {impl!r}; use 'flash', "
                         f"'reference', or 'auto'")
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   key_mask=key_mask, window=window)
    return flash_attention(q, k, v, causal, scale, key_mask, window=window)
