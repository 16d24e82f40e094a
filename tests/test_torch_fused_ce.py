"""The port's chunked fused cross-entropy (distkeras_tpu_torch/ops/
fused_ce.py) held against the JAX package's on the same numpy inputs.

f32 on both sides: the same chunk products and softmax math in another
summation order, so the loss agrees to 1e-6 relative and every gradient
(``dh``, ``dkernel``, ``dbias``, ``dmask``) to 1e-6 absolute at these
magnitudes (measured ≤ 3e-8). Under ``torch.func.vmap`` the batched run
equals a loop over workers within 1e-6.

bf16 on both sides (``test_bf16_matches_jax``): both keep each chunk's
logits in f32 (bf16 operands, f32 products), so the loss agrees to 1e-6
relative. ``dh`` and ``dkernel`` are f32 sums rounded to bf16 from
``dlogits`` rounded to bf16; a last-bit difference in the f32 softmax
(summation order) can flip either rounding by one bf16 ulp; measured,
they agree to 2^-8 of the JAX gradient's largest magnitude (at most one
bf16 ulp there).
Rounding the logits to bf16 first, as a bf16-output product does, moves
the loss by ~1e-4 relative at this size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.fused_ce import (
    chunked_softmax_cross_entropy as jce,
)
from distkeras_tpu_torch.ops.fused_ce import (
    chunked_softmax_cross_entropy as tce,
)
from distkeras_tpu_torch.ops.losses import (
    masked_sparse_softmax_cross_entropy,
    sparse_softmax_cross_entropy,
)

N, D, V = 50, 16, 37
ATOL = 1e-6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    kernel = (rng.normal(size=(D, V)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(V,)).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    mask = (rng.random(N) > 0.3).astype(np.float32)
    return h, kernel, bias, labels, mask


@pytest.mark.parametrize("chunk", [16, 50, 64])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_loss_and_gradients_match_jax(chunk, with_bias, with_mask):
    """chunk 16 does not divide N = 50; 64 exceeds it."""
    h, kernel, bias, labels, mask = _inputs()
    bias = bias if with_bias else None
    mask = mask if with_mask else None

    def jloss(h_, k_, b_, m_):
        return jce(h_, jnp.asarray(labels), k_, b_, mask=m_, chunk=chunk)

    jargs = [jnp.asarray(a) if a is not None else None
             for a in (h, kernel, bias, mask)]
    argnums = tuple(i for i, a in enumerate(jargs) if a is not None)
    jv, jg = jax.value_and_grad(jloss, argnums=argnums)(*jargs)
    targs = [torch.from_numpy(a).requires_grad_() if a is not None else None
             for a in (h, kernel, bias, mask)]
    loss = tce(targs[0], torch.from_numpy(labels), targs[1], targs[2],
               mask=targs[3], chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-6)
    got = [targs[i].grad for i in argnums]
    for a, b in zip(got, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


def test_equals_the_unfused_losses():
    h, kernel, bias, labels, mask = _inputs(1)
    th, tk, tb = (torch.from_numpy(a) for a in (h, kernel, bias))
    logits = th @ tk + tb
    lab = torch.from_numpy(labels)
    torch.testing.assert_close(tce(th, lab, tk, tb, chunk=7),
                               sparse_softmax_cross_entropy(lab, logits),
                               rtol=1e-6, atol=0)
    m = torch.from_numpy(mask)
    torch.testing.assert_close(
        tce(th, lab, tk, tb, mask=m, chunk=7),
        masked_sparse_softmax_cross_entropy(lab, logits, m), rtol=1e-6,
        atol=0)


def test_vmap_grad_equals_loop_over_workers():
    h, kernel, bias, labels, _ = _inputs(2)
    hs = torch.from_numpy(np.stack([h, 0.5 * h]))
    ks = torch.from_numpy(np.stack([kernel, 2.0 * kernel]))
    bs = torch.from_numpy(np.stack([bias, -bias]))
    lab = torch.from_numpy(np.stack([labels, labels[::-1].copy()]))

    def loss(h_, k_, b_, y_):
        return tce(h_, y_, k_, b_, chunk=16)

    grad = torch.func.grad_and_value(loss, argnums=(0, 1, 2))
    (dh, dk, db), vals = torch.func.vmap(grad)(hs, ks, bs, lab)
    for w in range(2):
        (rh, rk, rb), val = grad(hs[w], ks[w], bs[w], lab[w])
        for a, b in ((dh[w], rh), (dk[w], rk), (db[w], rb)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(vals[w].item(), val.item(), rtol=1e-6)


@pytest.mark.parametrize("with_bias", [True, False])
def test_bf16_matches_jax(with_bias):
    """N=64, D=256, V=4096, chunk 16, bf16 hidden and kernel (the LM's
    compute dtype); logits of standard deviation ~16."""
    n, d, v = 64, 256, 4096
    rng = np.random.default_rng(3)
    bf = jnp.bfloat16
    h = jnp.asarray(rng.normal(size=(n, d)), bf)
    kernel = jnp.asarray(rng.normal(size=(d, v)), bf)
    bias = jnp.asarray(rng.normal(size=(v,)), jnp.float32) if with_bias \
        else None
    labels = rng.integers(0, v, n).astype(np.int32)
    jv, (jdh, jdk) = jax.value_and_grad(
        lambda a, b: jce(a, jnp.asarray(labels), b, bias, chunk=16),
        argnums=(0, 1))(h, kernel)

    def bf16_leaf(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16).requires_grad_()

    th, tk = bf16_leaf(h), bf16_leaf(kernel)
    tb = None if bias is None else torch.from_numpy(np.array(bias))
    loss = tce(th, torch.from_numpy(labels), tk, tb, chunk=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-6)
    for got, ref in ((th.grad, jdh), (tk.grad, jdk)):
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=2.0 ** -8 * np.abs(ref).max())


def test_vmap_grad_folds_workers_into_every_product(monkeypatch):
    """Under ``vmap(grad)`` both passes run each chunk product once for all
    workers, on plain tensors with the worker axis folded in: the
    f32-output product has no batching rule, so a product on a batched
    tensor would fall back to a loop over workers."""
    import distkeras_tpu_torch.ops.fused_ce as fce

    seen = []
    real = fce._mm_f32

    def spy(a, b):
        seen.append((torch._C._functorch.is_batchedtensor(a)
                     or torch._C._functorch.is_batchedtensor(b), a.shape[0]))
        return real(a, b)

    monkeypatch.setattr(fce, "_mm_f32", spy)
    h, kernel, bias, labels, _ = _inputs(4)
    W = 3
    hs = torch.from_numpy(np.stack([h * (w + 1) for w in range(W)]))
    ks = torch.from_numpy(np.stack([kernel] * W))
    lab = torch.from_numpy(np.stack([labels] * W))
    grad = torch.func.grad(lambda h_, k_, y_: tce(h_, y_, k_, chunk=16),
                           argnums=(0, 1))
    torch.func.vmap(grad)(hs, ks, lab)
    chunks = -(-N // 16)
    assert len(seen) == chunks * 4        # forward 1, backward 3 a chunk
    assert seen == [(False, W)] * len(seen)


def test_argument_checks():
    h, kernel, _, labels, _ = _inputs()
    th, tk, lab = (torch.from_numpy(a) for a in (h, kernel, labels))
    with pytest.raises(ValueError, match="rows, dim"):
        tce(th[None], lab, tk)
    with pytest.raises(ValueError, match="chunk"):
        tce(th, lab, tk, chunk=0)
