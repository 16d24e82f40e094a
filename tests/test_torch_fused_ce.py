"""The port's chunked fused cross-entropy (distkeras_tpu_torch/ops/
fused_ce.py) held against the JAX package's on the same numpy inputs.

f32 on both sides: the same chunk products and softmax math in another
summation order, so the loss agrees to 1e-6 relative and every gradient
(``dh``, ``dkernel``, ``dbias``, ``dmask``) to 1e-6 absolute at these
magnitudes (measured ≤ 3e-8). Under ``torch.func.vmap`` the batched run
equals a loop over workers within 1e-6.
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


def test_argument_checks():
    h, kernel, _, labels, _ = _inputs()
    th, tk, lab = (torch.from_numpy(a) for a in (h, kernel, labels))
    with pytest.raises(ValueError, match="rows, dim"):
        tce(th[None], lab, tk)
    with pytest.raises(ValueError, match="chunk"):
        tce(th, lab, tk, chunk=0)
