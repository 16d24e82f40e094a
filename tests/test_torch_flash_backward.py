"""The port's flash-attention backward (distkeras_tpu_torch/ops/
flash_attention.py: the plain version of K3/K4 and the autograd Function
around K2) held against the JAX package on the same numpy inputs.

f32 throughout. The plain backward against the Pallas backward in
interpret mode at L = 128, and the Function's gradients against
``jax.grad`` of the Pallas ``flash_attention``: 1e-5 absolute, f32
summation-order noise at these magnitudes (measured ≤ 2e-6). Under
``torch.func.vmap`` the same arithmetic runs batched: equal to a loop over
workers within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu.ops.flash_attention as jfa
from distkeras_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 4, 16
ATOL = 1e-5

CASES = [
    # (hkv, causal, window, masked), as tests/test_torch_flash_attention.py
    (4, True, None, False),
    (2, True, None, False),
    (1, True, None, False),
    (4, False, None, False),
    (2, True, 24, False),
    (4, False, 24, False),
    (1, False, None, True),
    (2, True, 40, True),
]


def _inputs(L, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    g = rng.normal(size=(B, L, H, D)).astype(np.float32)
    return q, k, v, g


def _mask(L):
    """Row 0 attends a ragged prefix; row 1 masks everything, so every
    query of row 1 is fully masked."""
    m = np.zeros((B, L), np.float32)
    m[0, : L - L // 3] = 1.0
    return m


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("hkv,causal,window,masked", CASES)
def test_plain_backward_vs_jax_pallas_interpret(hkv, causal, window, masked):
    L = 128
    q, k, v, g = _inputs(L, hkv)
    km = _mask(L) if masked else None
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    jo, jl = jfa._fa_forward(_j(q), _j(k), _j(v), _j(km), interpret=True,
                             **kw)
    ref = jfa._fa_backward(_j(q), _j(k), _j(v), _j(km), jo, jl, _j(g),
                           interpret=True, **kw)
    out, lse = tfa._fa_forward(_t(q), _t(k), _t(v), _t(km), **kw)
    got = tfa._fa_backward(_t(q), _t(k), _t(v), _t(km), out, lse, _t(g),
                           **kw)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("L", [40, 77])
@pytest.mark.parametrize("hkv,causal,window,masked", CASES[1::2])
def test_plain_backward_vs_jax_math_ragged(L, hkv, causal, window, masked):
    """Lengths the Pallas kernels do not take, against the JAX package's
    ``_attention_bwd_math`` oracle."""
    q, k, v, g = _inputs(L, hkv, seed=L)
    km = _mask(L) if masked else None
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    out, lse = tfa._fa_forward(_t(q), _t(k), _t(v), _t(km), **kw)
    ref = jfa._attention_bwd_math(_j(q), _j(k), _j(v), _j(km),
                                  jnp.asarray(lse.numpy()), _j(g), **kw)
    got = tfa._fa_backward(_t(q), _t(k), _t(v), _t(km), out, lse, _t(g),
                           **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


# Semantics the tensor-core dq kernel (K3: 128 q rows a block, 64-key
# tiles, blocks of one head consecutive) must keep, on the plain backward
# it is held to on the card:
# (name, B, L, H, Hkv, D, causal, window, masked keys [lo, hi), oracle)
K3_EDGES = [
    # a whole 64-key tile masked inside rows that stay valid (a tile the
    # kernel skips without loading): non-causal, and causal with a window
    ("masked_key_tile", 2, 256, 4, 2, 16, False, None, (64, 128), "pallas"),
    ("masked_key_tile_causal", 2, 256, 4, 2, 16, True, 96, (128, 192),
     "pallas"),
    # a GQA group of 4: query heads 0-3 read kv head 0, heads 4-7 kv head 1
    ("gqa4", 2, 128, 8, 2, 16, True, None, None, "pallas"),
    # causal at L = 1024: the last q tiles have the longest bands
    ("causal_long", 1, 1024, 2, 2, 64, True, None, None, "math"),
]


@pytest.mark.parametrize("name,b,L,h,hkv,d,causal,window,hole,oracle",
                         K3_EDGES, ids=[c[0] for c in K3_EDGES])
def test_plain_backward_vs_jax_k3_edges(name, b, L, h, hkv, d, causal,
                                        window, hole, oracle):
    """The plain backward against the Pallas backward in interpret mode
    (as ``test_plain_backward_vs_jax_pallas_interpret``) or, at L = 1024,
    against ``_attention_bwd_math`` (as the ragged test, to stay fast on
    the CPU); tolerance as there. Keys of a masked tile get exactly zero
    dk and dv."""
    rng = np.random.default_rng(L + h)
    q, g = (rng.normal(size=(b, L, h, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(b, L, hkv, d)).astype(np.float32)
            for _ in range(2))
    km = None
    if hole is not None:
        km = np.ones((b, L), np.float32)
        km[:, hole[0]:hole[1]] = 0.0
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    out, lse = tfa._fa_forward(_t(q), _t(k), _t(v), _t(km), **kw)
    got = tfa._fa_backward(_t(q), _t(k), _t(v), _t(km), out, lse, _t(g),
                           **kw)
    if oracle == "pallas":
        jo, jl = jfa._fa_forward(_j(q), _j(k), _j(v), _j(km),
                                 interpret=True, **kw)
        ref = jfa._fa_backward(_j(q), _j(k), _j(v), _j(km), jo, jl, _j(g),
                               interpret=True, **kw)
    else:
        ref = jfa._attention_bwd_math(_j(q), _j(k), _j(v), _j(km),
                                      jnp.asarray(lse.numpy()), _j(g), **kw)
    for a, r in zip(got, ref):
        assert tuple(a.shape) == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)
    if hole is not None:
        for grad in got[1:]:
            assert torch.all(grad[:, hole[0]:hole[1]] == 0.0)


@pytest.mark.parametrize("hkv,causal,window,masked",
                         [CASES[1], CASES[5], CASES[7]])
def test_function_grads_vs_jax_grad(hkv, causal, window, masked):
    """``loss.backward()`` through the Function against ``jax.grad`` of
    the Pallas ``flash_attention`` (interpret mode), and the forward."""
    L = 128
    q, k, v, probe = _inputs(L, hkv, seed=3)
    km = _mask(L) if masked else None

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=causal, key_mask=_j(km),
                                interpret=True, window=window)
        return jnp.sum(o * probe)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k),
                                                          _j(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal, key_mask=_t(km),
                            window=window)
    loss = torch.sum(o * _t(probe))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    for a, b in zip(leaves, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("batched_mask", [True, False])
def test_vmap_grad_equals_loop_over_workers(batched_mask):
    """The engine's ``vmap(grad)`` folds the worker axis into B (one
    forward and one backward per step for all workers); it must equal a
    Python loop over workers."""
    Wk, L, hkv = 2, 64, 2
    qs, ks, vs, _ = zip(*(_inputs(L, hkv, seed=10 + w) for w in range(Wk)))
    qs, ks, vs = (torch.from_numpy(np.stack(a)) for a in (qs, ks, vs))
    masks = torch.from_numpy(np.stack([_mask(L), 1.0 - _mask(L)]))
    probe = torch.from_numpy(_inputs(L, hkv, seed=99)[3])

    def loss(q, k, v, m):
        o = tfa.flash_attention(q, k, v, causal=True, key_mask=m, window=24)
        return torch.sum(o * probe)

    grad = torch.func.grad_and_value(loss, argnums=(0, 1, 2))
    m_in = masks if batched_mask else masks[0]
    (dq, dk, dv), vals = torch.func.vmap(
        grad, in_dims=(0, 0, 0, 0 if batched_mask else None))(qs, ks, vs,
                                                              m_in)
    for w in range(Wk):
        (rq, rk, rv), val = grad(qs[w], ks[w], vs[w],
                                 masks[w] if batched_mask else masks[0])
        for a, b in ((dq[w], rq), (dk[w], rk), (dv[w], rv)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(vals[w].item(), val.item(), rtol=1e-6)


def test_fully_masked_rows_give_zero_gradients():
    L, hkv = 48, 2
    q, k, v, g = _inputs(L, hkv, seed=5)
    km = _mask(L)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=False, key_mask=_t(km))
    torch.sum(o * _t(g)).backward()
    assert torch.all(o[1] == 0.0)
    for t in leaves:
        assert torch.all(t.grad[1] == 0.0)        # batch row 1: all masked
        assert torch.isfinite(t.grad).all()
    # masked keys of row 0 get no dk/dv
    dead = km[0] == 0.0
    assert torch.all(leaves[1].grad[0, dead] == 0.0)
    assert torch.all(leaves[2].grad[0, dead] == 0.0)


def test_cpu_backward_runs_plain_versions_without_launching():
    q, k, v, g = _inputs(32, 2)
    counts = (tfa._fa_forward.launches, tfa._fa_bwd_dq.launches,
              tfa._fa_bwd_dkv.launches)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.sum(tfa.flash_attention(*leaves, causal=True) * _t(g)).backward()
    assert all(t.grad is not None for t in leaves)
    assert (tfa._fa_forward.launches, tfa._fa_bwd_dq.launches,
            tfa._fa_bwd_dkv.launches) == counts


def test_plain_impl_and_argument_checks():
    q, k, v, g = _inputs(32, 2)
    got = tfa.attention(_t(q), _t(k), _t(v), causal=True, impl="plain")
    ref = tfa.attention(_t(q), _t(k), _t(v), causal=True, impl="flash")
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    out, lse = tfa._fa_forward(_t(q), _t(k), _t(v), None, scale=0.25,
                               causal=True)
    dq, dk, dv = tfa._fa_backward(_t(q), _t(k), _t(v), None, out, lse,
                                  _t(g), scale=0.25, causal=True)
    only_dq = tfa._fa_bwd_plain(_t(q), _t(k), _t(v), None, lse,
                                tfa._delta(out, _t(g)), _t(g), scale=0.25,
                                causal=True, window=None, parts=("dq",))
    torch.testing.assert_close(only_dq[0], dq, rtol=0, atol=0)
    assert only_dq[1] is None and only_dq[2] is None
    with pytest.raises(ValueError, match="impl"):
        tfa.flash_attention(_t(q), _t(k), _t(v), impl="xla")
    meta = torch.ones(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa._fa_backward(meta, meta, meta, None, meta,
                         torch.ones(2, 4, device="meta"), meta, scale=1.0,
                         causal=False)
