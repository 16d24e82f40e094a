"""Flash attention on PyTorch + CUDA, forward and backward.

Port of ``distkeras_tpu/ops/flash_attention.py`` and of
``parallel/sequence.py::attention_reference``. Three hand-written kernels
keep the TPU kernels' contract — causal, sliding ``window`` via
:func:`band_predicate` with out-of-band tiles skipped, optional
``key_mask``, grouped-query attention read through the ``h // group`` head
map, masked scores at ``-1e9``, fully masked rows giving 0 (and zero
gradients) — and take any sequence length, so serving prefill (prompts
padded to a block multiple, not a 128 multiple) runs them too:

- K2, the forward (``csrc/flash_attention.cu``): the output and the per-row
  log-sum-exp;
- K3, the dq backward, and K4, the dk/dv backward
  (``csrc/flash_attention_bwd.cu``): each rebuilds its probability tiles
  from the saved lse; K4 sums dk/dv over each GQA group inside one block.
  ``delta = rowsum(dO · O)`` is computed here in f32 beforehand.

Which kernel runs is :func:`flash_route`'s choice from the dtype, the head
dim and the inputs' 16-byte alignment: ``"wgmma"`` (bf16 at D = 64 or 128:
K2, K3 and K4 on the tensor cores), ``"small"`` (bf16 at D = 16 or 32: the
small-D forward and one fused backward launch for dq, dk and dv, also on
the tensor cores) or ``"fma"`` (f32, and bf16 at any other head dim: f32
FMA kernels). The route is taken, never fallen back from: a kernel that
does not build or launch raises.

:func:`flash_attention` goes through a ``torch.autograd.Function`` whose
``vmap`` rule folds a vmapped worker axis into B, so the training engine's
``torch.func.vmap(grad)`` over W stacked workers launches each kernel once
for all workers (inside ``vmap`` the tensors are batched wrappers with no
``data_ptr``: the rule, not the body, meets the kernel). On CPU tensors the
same Function runs the kernels' plain versions.

Layouts follow the JAX package: q ``[B, L, H, D]``, k/v ``[B, L, Hkv, D]``,
lse and delta ``[B·H, L]``.
"""

from __future__ import annotations

import ctypes

import torch

from distkeras_tpu_torch.ops import _build
from distkeras_tpu_torch.utils import fold_vmapped as _fold
from distkeras_tpu_torch.utils import unfold_vmapped as _unfold

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


def _valid_mask(B, L, key_mask, causal, window, device):
    """[B or 1, 1, L, L] validity of (query, key) pairs, or None."""
    band = band_predicate(torch.arange(L, device=device)[:, None],
                          torch.arange(L, device=device)[None, :],
                          causal, window)
    valid = None if band is None else band[None, None]
    if key_mask is not None:
        km = key_mask[:, None, None, :].to(torch.bool)
        valid = km if valid is None else (valid & km)
    return valid


def _fa_bwd_plain(q, k, v, key_mask, lse, delta, g, *, scale, causal,
                  window, parts=("dq", "dkv")):
    """Plain version of K3 and K4: ``_attention_bwd_math`` in f32 on the
    saved lse, with ``delta`` (``rowsum(dO · O)`` ``[B·H, L]``) where the
    JAX math recomputes ``rowsum(dP · P)`` — the two are equal, and delta
    is what the kernels read. GQA heads are repeated, and dk/dv summed back
    over each group. ``parts`` picks K3's ``dq`` and/or K4's ``(dk, dv)``;
    returns ``(dq, dk, dv)`` with None for what was not asked."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    groups = _gqa_groups(q, k)
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    if groups > 1:
        kf = kf.repeat_interleave(groups, dim=2)
        vf = vf.repeat_interleave(groups, dim=2)
    qf = q.to(f32) * scale
    gf = g.to(f32)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    valid = _valid_mask(B, L, key_mask, causal, window, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, _NEG)
    p = torch.exp(s - lse.reshape(B, H, L)[..., None])
    del s
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta.reshape(B, H, L)[..., None])
    del dp
    dq = dk = dv = None
    if "dq" in parts:
        dq = (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)
    if "dkv" in parts:
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
        if groups > 1:   # sum the group's q heads back onto the shared head
            dk = dk.reshape(B, L, Hkv, groups, D).sum(dim=3)
            dv = dv.reshape(B, L, Hkv, groups, D).sum(dim=3)
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_DIMS, _SMALL_DIMS = (64, 128), (16, 32)
_SMALL_KEY_TILE = 128   # keys a block of the fused small-D backward


def flash_route(dtype, head_dim: int, aligned: bool) -> str:
    """The flash kernels' path for ``dtype`` at ``head_dim``: ``"wgmma"``
    (bf16, D = 64 or 128), ``"small"`` (bf16, D = 16 or 32) or ``"fma"``
    (everything else). The two tensor-core paths read q/k/v (and dO) by
    TMA, so they need every input 16-byte aligned (``aligned``); unaligned
    inputs take the FMA kernels."""
    if dtype == torch.bfloat16 and aligned:
        if head_dim in _WGMMA_DIMS:
            return "wgmma"
        if head_dim in _SMALL_DIMS:
            return "small"
    return "fma"


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dk_flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, i, i, i, vp]
    lib.dk_flash_attention_fwd.restype = i
    lib.dk_flash_attention_max_head_dim.argtypes = []
    lib.dk_flash_attention_max_head_dim.restype = i
    lib.dk_flash_attention_fwd_small.argtypes = [
        vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, i, i, vp]
    lib.dk_flash_attention_fwd_small.restype = i
    lib.dk_flash_attention_fwd_small_occupancy.argtypes = [
        i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.dk_flash_attention_fwd_small_occupancy.restype = i


def _bind_bwd(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dk_flash_attention_bwd_dq.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, i, i,
        i, vp]
    lib.dk_flash_attention_bwd_dq.restype = i
    lib.dk_flash_attention_bwd_dkv.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, i,
        i, i, vp]
    lib.dk_flash_attention_bwd_dkv.restype = i
    lib.dk_flash_attention_bwd_max_head_dim.argtypes = []
    lib.dk_flash_attention_bwd_max_head_dim.restype = i
    lib.dk_flash_attention_bwd_small.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i,
        ctypes.c_float, i, i, vp]
    lib.dk_flash_attention_bwd_small.restype = i
    lib.dk_flash_attention_bwd_small_occupancy.argtypes = [
        i, ctypes.POINTER(i)]
    lib.dk_flash_attention_bwd_small_occupancy.restype = i


def _check_cuda(q, k, v, key_mask, *rest):
    """Validate kernel inputs (raise on what the kernels do not take) and
    return them contiguous, the key mask as f32 ``[B, L]``."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, L, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, L, Hkv, D] = {(B, L, Hkv, D)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if not all(t.is_cuda and t.device == q.device for t in (k, v, *rest)):
        raise ValueError("flash kernel inputs must lie on one CUDA device")
    km = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (B, L):
            raise ValueError(f"key_mask must be [B, L] = {(B, L)}, got "
                             f"{tuple(key_mask.shape)}")
        km = key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    return [t.contiguous() for t in (q, k, v, *rest)], km


def _check_head_dim(D, limit):
    if D > limit:
        raise ValueError(f"flash kernels take head dim <= {limit}, got {D}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fa_forward_cuda(q, k, v, key_mask, *, scale, causal, window,
                     route=None):
    """K2 on CUDA tensors along ``route`` (default :func:`flash_route`'s;
    ``"fma"`` forces the FMA kernel, which the bf16 dispatch in C takes at
    any head dim but 64 and 128). The small-D kernel counts its launches
    in ``_fa_forward.small_launches``, the others in ``.launches``."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    (q, k, v), km = _check_cuda(q, k, v, key_mask)
    lib = _build.load("flash_attention", _bind)
    _check_head_dim(D, lib.dk_flash_attention_max_head_dim())
    if route is None:
        route = flash_route(q.dtype, D, _aligned(q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B * H, L), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(km),
            out.data_ptr(), lse.data_ptr(), B, L, H, Hkv, D, float(scale),
            int(bool(causal)), 0 if window is None else int(window))
    if route == "small":
        err = lib.dk_flash_attention_fwd_small(*ptrs, stream)
        _build.check(err, "flash_attention_small")
        _build.count_launch(_fa_forward, "small_launches")
        return out, lse
    err = lib.dk_flash_attention_fwd(*ptrs, _DTYPE_CODE[q.dtype], stream)
    _build.check(err, "flash_attention")
    _build.count_launch(_fa_forward)
    return out, lse


def small_occupancy(head_dim: int) -> dict:
    """Blocks of the small-D forward and backward resident on one SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the SM count
    (the forward's persistent grid is their product). Needs the card."""
    i = ctypes.c_int
    fwd, sms, bwd = i(0), i(0), i(0)
    lib = _build.load("flash_attention", _bind)
    _build.check(lib.dk_flash_attention_fwd_small_occupancy(
        int(head_dim), ctypes.byref(fwd), ctypes.byref(sms)),
        "flash_attention_small occupancy")
    lib = _build.load("flash_attention_bwd", _bind_bwd)
    _build.check(lib.dk_flash_attention_bwd_small_occupancy(
        int(head_dim), ctypes.byref(bwd)),
        "flash_attention_bwd_small occupancy")
    return dict(fwd_blocks_per_sm=fwd.value, bwd_blocks_per_sm=bwd.value,
                sms=sms.value)


def _on_device(q, impl):
    """"plain" or "kernel" for q's device; raise on any other device."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown flash impl {impl!r}; use 'kernel' or "
                         f"'plain'")
    if impl == "plain" or q.device.type == "cpu":
        return "plain"
    if q.device.type == "cuda":
        return "kernel"
    raise ValueError(f"flash attention runs on cpu or cuda tensors, got "
                     f"{q.device}")


def _fa_forward(q, k, v, key_mask, *, scale, causal, window=None,
                impl="kernel"):
    """(out ``[B, L, H, D]``, lse ``[B·H, L]``): K2 on a CUDA tensor (or
    raise), the plain version on a CPU tensor or with ``impl="plain"``.
    ``launches`` counts launches of the wgmma and FMA kernels,
    ``small_launches`` those of the small-D kernel."""
    _gqa_groups(q, k)
    if _on_device(q, impl) == "plain":
        return _fa_forward_plain(q, k, v, key_mask, scale=scale,
                                 causal=causal, window=window)
    return _fa_forward_cuda(q, k, v, key_mask, scale=scale, causal=causal,
                            window=window)


_fa_forward.launches = 0
_fa_forward.small_launches = 0


def _bwd_args(q, k, v, key_mask, lse, delta, g):
    B, L, H, D = q.shape
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"dO must match q: {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * H, L) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B·H, L] = "
                             f"{(B * H, L)}, got {tuple(t.shape)} {t.dtype}")
    (q, k, v, g, lse, delta), km = _check_cuda(q, k, v, key_mask, g, lse,
                                               delta)
    lib = _build.load("flash_attention_bwd", _bind_bwd)
    _check_head_dim(D, lib.dk_flash_attention_bwd_max_head_dim())
    return lib, (q, k, v, g, lse, delta), km


def _fa_bwd_dq(q, k, v, key_mask, lse, delta, g, *, scale, causal,
               window=None):
    """K3: dq ``[B, L, H, D]`` in q's dtype. CUDA tensors only; ``launches``
    counts kernel launches."""
    B, L, H, D = q.shape
    lib, (q, k, v, g, lse, delta), km = _bwd_args(q, k, v, key_mask, lse,
                                                  delta, g)
    dq = torch.empty_like(q)
    err = lib.dk_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(km), dq.data_ptr(), B, L, H,
        k.shape[2], D, float(scale), int(bool(causal)),
        0 if window is None else int(window), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_dq")
    _build.count_launch(_fa_bwd_dq)
    return dq


def _fa_bwd_dkv(q, k, v, key_mask, lse, delta, g, *, scale, causal,
                window=None):
    """K4: (dk, dv) ``[B, L, Hkv, D]`` in k/v's dtype, summed over each GQA
    group inside the kernel. CUDA tensors only; ``launches`` counts kernel
    launches."""
    B, L, H, D = q.shape
    lib, (q, k, v, g, lse, delta), km = _bwd_args(q, k, v, key_mask, lse,
                                                  delta, g)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.dk_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(km), dk.data_ptr(),
        dv.data_ptr(), B, L, H, k.shape[2], D, float(scale),
        int(bool(causal)), 0 if window is None else int(window),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_dkv")
    _build.count_launch(_fa_bwd_dkv)
    return dk, dv


def _fa_bwd_small(q, k, v, key_mask, lse, delta, g, *, scale, causal,
                  window=None):
    """K3 and K4 fused for bf16 at D = 16 or 32: (dq, dk, dv) in one
    launch. Up to L = 128 (one key tile) dq has one writer and the kernel
    stores it; past that the key tiles' blocks add theirs into an f32
    buffer (atomic adds in no fixed order: dq is not bit-reproducible
    there) that is cast to q's dtype. CUDA tensors only; ``launches``
    counts kernel launches."""
    B, L, H, D = q.shape
    lib, (q, k, v, g, lse, delta), km = _bwd_args(q, k, v, key_mask, lse,
                                                  delta, g)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    direct = L <= _SMALL_KEY_TILE
    dq = torch.empty_like(q) if direct else None
    dq_acc = None if direct else torch.zeros(q.shape, dtype=torch.float32,
                                             device=q.device)
    err = lib.dk_flash_attention_bwd_small(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(km), _ptr(dq), _ptr(dq_acc),
        dk.data_ptr(), dv.data_ptr(), B, L, H, k.shape[2], D, float(scale),
        int(bool(causal)), 0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_small")
    _build.count_launch(_fa_bwd_small)
    return (dq if direct else dq_acc.to(q.dtype)), dk, dv


_fa_bwd_dq.launches = 0
_fa_bwd_dkv.launches = 0
_fa_bwd_small.launches = 0


def _delta(out, g):
    """``rowsum(dO · O)`` in f32, ``[B, L, H, D]`` → ``[B·H, L]``."""
    B, L, H, _ = out.shape
    d = torch.sum(g.to(torch.float32) * out.to(torch.float32), dim=-1)
    return d.transpose(1, 2).reshape(B * H, L).contiguous()


def _fa_backward(q, k, v, key_mask, out, lse, g, *, scale, causal,
                 window=None, impl="kernel"):
    """(dq, dk, dv) from the forward's saved ``out`` and ``lse``: on CUDA
    tensors the fused small-D kernel or K3 and K4, as :func:`flash_route`
    says (or raise), the plain version on CPU tensors or with
    ``impl="plain"``."""
    _gqa_groups(q, k)
    delta = _delta(out, g)
    kw = dict(scale=scale, causal=causal, window=window)
    if _on_device(q, impl) == "plain":
        return _fa_bwd_plain(q, k, v, key_mask, lse, delta, g, **kw)
    g = g.to(q.dtype).contiguous()
    q, k, v = (t.contiguous() for t in (q, k, v))
    if flash_route(q.dtype, q.shape[-1], _aligned(q, k, v, g)) == "small":
        return _fa_bwd_small(q, k, v, key_mask, lse, delta, g, **kw)
    dq = _fa_bwd_dq(q, k, v, key_mask, lse, delta, g, **kw)
    dk, dv = _fa_bwd_dkv(q, k, v, key_mask, lse, delta, g, **kw)
    return dq, dk, dv


class _FlashBackward(torch.autograd.Function):
    """The backward kernels (K3 + K4, or the fused small-D kernel) as a
    Function, so ``torch.func`` can batch them (its own backward, a second
    derivative, is not provided)."""

    @staticmethod
    def forward(q, k, v, key_mask, out, lse, g, scale, causal, window, impl):
        return _fa_backward(q, k, v, key_mask, out, lse, g, scale=scale,
                            causal=causal, window=window, impl=impl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ddq, ddk, ddv):
        raise NotImplementedError("flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, key_mask, out, lse, g, scale, causal,
             window, impl):
        n = info.batch_size
        fq, fk, fv, fo, fl, fg = (_fold(x, d, n) for x, d in zip(
            (q, k, v, out, lse, g), in_dims[:3] + in_dims[4:7]))
        km = None if key_mask is None else _fold(key_mask, in_dims[3], n)
        dq, dk, dv = _FlashBackward.apply(fq, fk, fv, km, fo, fl, fg, scale,
                                          causal, window, impl)
        return (_unfold(dq, n), _unfold(dk, n), _unfold(dv, n)), (0, 0, 0)


class _Flash(torch.autograd.Function):
    """K2 as a Function whose backward launches the backward kernels — the
    counterpart of the JAX package's ``_flash_core`` custom VJP. Saves q,
    k, v, the key mask, O and lse; the mask gets no gradient."""

    @staticmethod
    def forward(q, k, v, key_mask, scale, causal, window, impl):
        return _fa_forward(q, k, v, key_mask, scale=scale, causal=causal,
                           window=window, impl=impl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_mask, scale, causal, window, impl = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.args = (scale, causal, window, impl)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashBackward.apply(q, k, v, key_mask, out, lse, dout,
                                          *ctx.args)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, key_mask, scale, causal, window, impl):
        n = info.batch_size
        fq, fk, fv = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims[:3]))
        km = None if key_mask is None else _fold(key_mask, in_dims[3], n)
        out, lse = _Flash.apply(fq, fk, fv, km, scale, causal, window, impl)
        return (_unfold(out, n), lse.reshape(n, -1, lse.shape[-1])), (0, 0)


def flash_attention(q, k, v, causal: bool = False, scale=None, key_mask=None,
                    window: int | None = None, impl: str = "kernel"):
    """Flash attention with the contract of :func:`attention_reference`:
    ``[B, L, H, D]`` in and out, optional ``key_mask`` ``[B, L]``,
    sliding ``window``; differentiable in q, k and v, and batchable by
    ``torch.func.vmap``. ``impl="kernel"`` runs K2–K4 on CUDA tensors and
    their plain versions on CPU tensors; ``"plain"`` the plain versions on
    any device."""
    out, _ = _Flash.apply(
        q, k, v, key_mask,
        float(scale if scale is not None else q.shape[-1] ** -0.5),
        bool(causal), _canonical_window(window, q.shape[1]), impl)
    return out


def attention(q, k, v, causal: bool = False, scale=None, key_mask=None,
              impl: str = "auto", window: int | None = None):
    """``impl="reference"`` runs :func:`attention_reference`; ``"flash"``
    and ``"auto"`` run :func:`flash_attention` — the kernels on a CUDA
    tensor at any length, their plain versions on a CPU tensor; ``"plain"``
    runs :func:`flash_attention` over the plain versions on any device."""
    if impl not in ("flash", "reference", "auto", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}; use 'flash', "
                         f"'reference', 'auto' or 'plain'")
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   key_mask=key_mask, window=window)
    return flash_attention(q, k, v, causal, scale, key_mask, window=window,
                           impl="plain" if impl == "plain" else "kernel")
