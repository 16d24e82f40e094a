"""The port's flash-attention forward (distkeras_tpu_torch/ops/
flash_attention.py) held against the JAX package on the same numpy inputs:
the plain version against the Pallas kernel in interpret mode at L = 128
(output and log-sum-exp), and against ``attention_reference`` at ragged
lengths, which the Pallas kernel does not take. f32 throughout; 1e-5
absolute is f32 summation-order noise at these magnitudes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.ops.flash_attention as jfa
from distkeras_tpu.parallel.sequence import attention_reference as jref
from distkeras_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 4, 16


def _qkv(L, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
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


def _torch(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("hkv,causal,window,masked", CASES)
def test_plain_vs_jax_flash_interpret(hkv, causal, window, masked):
    L = 128
    q, k, v = _qkv(L, hkv)
    km = _mask(L) if masked else None
    scale = D ** -0.5
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
@pytest.mark.parametrize("hkv,causal,window,masked", CASES)
def test_plain_vs_jax_reference_ragged(L, hkv, causal, window, masked):
    q, k, v = _qkv(L, hkv, seed=L)
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
