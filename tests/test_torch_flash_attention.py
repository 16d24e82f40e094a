"""The port's flash-attention forward (distkeras_tpu_torch/ops/
flash_attention.py) held against the JAX package on the same numpy inputs:
the plain version against the Pallas kernel in interpret mode at L = 128
(output and log-sum-exp), and against ``attention_reference`` at ragged
lengths, which the Pallas kernel does not take, each at the head dims of
the small-D kernels (16 and 32). f32 throughout; 1e-5 absolute is f32
summation-order noise at these magnitudes. Also pins which kernel path
(dtype, head dim, alignment) takes, and that CPU tensors never reach a
kernel wrapper.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.ops.flash_attention as jfa
from distkeras_tpu.parallel.sequence import attention_reference as jref
from distkeras_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 4, 16


def _qkv(L, hkv, seed=0, d=D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, d)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, d)).astype(np.float32)
    return q, k, v


def _mask(L):
    """Row 0 attends a ragged prefix; row 1 masks everything, so every
    query of row 1 is fully masked."""
    m = np.zeros((B, L), np.float32)
    m[0, : L - L // 3] = 1.0
    return m


CASES = [
    # (hkv, causal, window, masked)
    (4, True, None, False),
    (2, True, None, False),
    (1, True, None, False),
    (4, False, None, False),
    (2, True, 24, False),
    (4, False, 24, False),
    (1, False, None, True),
    (2, True, 40, True),
]


def with_head_dims(cases):
    """Each case at D = 16 (under the case's own id) and at D = 32."""
    out = []
    for case in cases:
        name = "-".join(str(x) for x in case)
        out += [pytest.param(16, *case, id=name),
                pytest.param(32, *case, id=f"{name}-D32")]
    return out


def _torch(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("d,hkv,causal,window,masked", with_head_dims(CASES))
def test_plain_vs_jax_flash_interpret(d, hkv, causal, window, masked):
    L = 128
    q, k, v = _qkv(L, hkv, d=d)
    km = _mask(L) if masked else None
    scale = d ** -0.5
    ref_o, ref_lse = jfa._fa_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if km is None else jnp.asarray(km), scale=scale, causal=causal,
        interpret=True, window=window)
    tq_, tk, tv, tkm = _torch(q, k, v, km)
    out, lse = tfa._fa_forward(tq_, tk, tv, tkm, scale=scale, causal=causal,
                               window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-6,
                               atol=1e-5)
    if masked:
        assert np.all(out.numpy()[1] == 0.0)   # fully masked rows give 0


@pytest.mark.parametrize("L", [40, 77])
@pytest.mark.parametrize("d,hkv,causal,window,masked", with_head_dims(CASES))
def test_plain_vs_jax_reference_ragged(L, d, hkv, causal, window, masked):
    q, k, v = _qkv(L, hkv, seed=L, d=d)
    km = _mask(L) if masked else None
    ref = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
               key_mask=None if km is None else jnp.asarray(km),
               window=window)
    tq_, tk, tv, tkm = _torch(q, k, v, km)
    for impl in ("flash", "reference"):
        got = tfa.attention(tq_, tk, tv, causal=causal, key_mask=tkm,
                            impl=impl, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


def test_band_predicate_and_helpers_match_jax():
    qp = np.arange(12)[:, None]
    kp = np.arange(12)[None, :]
    for causal in (False, True):
        for window in (None, 1, 3):
            ref = jfa.band_predicate(jnp.asarray(qp), jnp.asarray(kp),
                                     causal, window)
            got = tfa.band_predicate(torch.from_numpy(qp),
                                     torch.from_numpy(kp), causal, window)
            assert (ref is None) == (got is None)
            if ref is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for H_, Hkv in ((4, 4), (4, 2), (8, 1)):
        for b in range(2 * H_):
            assert tfa._kv_row(b, H_, Hkv) == jfa._kv_row(b, H_, Hkv)
    assert tfa._canonical_window(None, 8) is None
    assert tfa._canonical_window(8, 8) is None
    assert tfa._canonical_window(3, 8) == 3
    with pytest.raises(ValueError, match="window"):
        tfa._canonical_window(0, 8)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8),
                            torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="impl"):
        tfa.attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                      torch.zeros(1, 4, 2, 8), impl="xla")


def test_cpu_runs_plain_version_without_launching():
    q, k, v = _qkv(32, 2)
    launches = tfa._fa_forward.launches
    out = tfa.flash_attention(*_torch(q, k, v), causal=True)
    assert out.shape == (B, 32, H, D)
    assert tfa._fa_forward.launches == launches


ROUTES = [
    # (dtype, head dim, 16-byte aligned, path)
    (torch.bfloat16, 16, True, "small"),
    (torch.bfloat16, 32, True, "small"),
    (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 128, True, "wgmma"),
    (torch.float32, 16, True, "fma"),
    (torch.float32, 32, True, "fma"),
    (torch.float32, 64, True, "fma"),
    (torch.float32, 128, True, "fma"),
    (torch.bfloat16, 24, True, "fma"),
    (torch.bfloat16, 8, True, "fma"),
    (torch.bfloat16, 16, False, "fma"),
    (torch.bfloat16, 32, False, "fma"),
    (torch.bfloat16, 64, False, "fma"),
    (torch.bfloat16, 128, False, "fma"),
]


@pytest.mark.parametrize("dtype,d,aligned,path", ROUTES)
def test_flash_route_pins_the_kernel_paths(dtype, d, aligned, path):
    """bf16 at D = 16 and 32 takes the small-D kernels, at 64 and 128 the
    wgmma kernels; f32, other head dims and unaligned inputs (which TMA
    cannot read) the FMA kernels."""
    assert tfa.flash_route(dtype, d, aligned) == path


def test_alignment_is_read_from_the_pointers():
    whole = torch.zeros(64, dtype=torch.bfloat16)
    assert tfa._aligned(whole, whole[8:])      # 16 bytes in: still aligned
    assert not tfa._aligned(whole, whole[1:])  # 2 bytes in
    assert tfa.flash_route(torch.bfloat16, 16,
                           tfa._aligned(whole[1:])) == "fma"


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel wrapper was reached with CPU tensors")


@pytest.mark.parametrize("d", [16, 32])
def test_cpu_small_dims_never_reach_the_kernel_wrappers(d, monkeypatch):
    """bf16 at the small-D kernels' head dims on CPU tensors: forward and
    backward run the plain versions (equal to ``impl="plain"``), no
    wrapper is called and no counter moves."""
    counters = ((tfa._fa_forward, "launches"),
                (tfa._fa_forward, "small_launches"),
                (tfa._fa_bwd_small, "launches"), (tfa._fa_bwd_dq, "launches"),
                (tfa._fa_bwd_dkv, "launches"))
    counts = [getattr(fn, attr) for fn, attr in counters]
    for name in ("_fa_forward_cuda", "_fa_bwd_small", "_fa_bwd_dq",
                 "_fa_bwd_dkv"):
        monkeypatch.setattr(tfa, name, _refuse)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(48, 2, seed=d, d=d))
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = tfa.flash_attention(*leaves, causal=True, impl=impl)
        o.float().sum().backward()
        grads[impl] = [o] + [t.grad for t in leaves]
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [getattr(fn, attr) for fn, attr in counters] == counts
