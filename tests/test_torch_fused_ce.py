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

The chunk's row work (``ce_fwd_rows`` / ``ce_bwd_rows``: hand-written
kernels on the card, their plain versions here) is held to the unfused
definitions directly: the forward's per-row lse and nll to
``torch.logsumexp`` and the gather, the backward's dlogits from the saved
lse to ``(softmax − one_hot) · mask · scale`` and its column sums to
dbias, within 1e-6; ``dmask`` from the saved nll to ``jax.grad`` of the
JAX op at non-binary weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.fused_ce import (
    chunked_softmax_cross_entropy as jce,
)
from distkeras_tpu_torch.ops import fused_ce as fce
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
    """Under ``vmap(grad)`` both passes run each chunk product and each
    chunk's row kernel once for all workers, on plain tensors with the
    worker axis folded in: the f32-output product has no batching rule, so
    a product on a batched tensor would fall back to a loop over workers.
    The forward's non-differentiable per-row lse and nll unfold to ``[W,
    1, N]`` and equal each worker's own."""
    import distkeras_tpu_torch.ops.fused_ce as fce

    seen = []

    def spy(name, real):
        def run(*args):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            seen.append((name, any(torch._C._functorch.is_batchedtensor(t)
                                   for t in ts), ts[0].shape[0]))
            return real(*args)
        return run

    for name in ("_mm_f32", "_mm_f32_acc", "ce_fwd_rows", "ce_bwd_rows"):
        monkeypatch.setattr(fce, name, spy(name, getattr(fce, name)))
    h, kernel, bias, labels, _ = _inputs(4)
    W = 3
    hs = torch.from_numpy(np.stack([h * (w + 1) for w in range(W)]))
    ks = torch.from_numpy(np.stack([kernel] * W))
    bs = torch.from_numpy(np.stack([bias * (w - 1) for w in range(W)]))
    lab = torch.from_numpy(np.stack([labels] * W))
    grad = torch.func.grad(
        lambda h_, k_, b_, y_: tce(h_, y_, k_, b_, chunk=16),
        argnums=(0, 1, 2))
    torch.func.vmap(grad)(hs, ks, bs, lab)
    chunks = -(-N // 16)
    pairs = -(-N // (fce._PAIR * 16))
    names = [s[0] for s in seen]
    # forward: a product and a row kernel a chunk; backward: the same a
    # chunk, then dh's and dk's products a pair of chunks
    assert names.count("ce_fwd_rows") == chunks
    assert names.count("ce_bwd_rows") == chunks
    assert names.count("_mm_f32") == 2 * chunks + pairs
    assert names.count("_mm_f32_acc") == pairs
    assert [s[1:] for s in seen] == [(False, W)] * len(seen)

    ones = torch.ones((N,))
    outs = torch.func.vmap(lambda h_, k_, b_, y_: fce._FusedCE.apply(
        h_[None], k_[None], b_[None], y_[None], ones[None], 16))(
            hs, ks, bs, lab)
    assert [tuple(o.shape) for o in outs] == [(W, 1)] * 3 + [(W, 1, N)] * 2
    for w in range(W):
        x = hs[w] @ ks[w] + bs[w]
        lse = torch.logsumexp(x, dim=-1)
        np.testing.assert_allclose(outs[3][w, 0].numpy(), lse.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            outs[4][w, 0].numpy(),
            (lse - x[torch.arange(N), lab[w]]).numpy(), rtol=1e-6,
            atol=1e-6)


def test_argument_checks():
    h, kernel, _, labels, _ = _inputs()
    th, tk, lab = (torch.from_numpy(a) for a in (h, kernel, labels))
    with pytest.raises(ValueError, match="rows, dim"):
        tce(th[None], lab, tk)
    with pytest.raises(ValueError, match="chunk"):
        tce(th, lab, tk, chunk=0)


def _unfused(h, kernel, bias):
    x = torch.from_numpy(h) @ torch.from_numpy(kernel)
    return x if bias is None else x + torch.from_numpy(bias)


@pytest.mark.parametrize("with_bias", [True, False])
def test_rows_forward_plain_matches_logsumexp_and_gather(with_bias):
    """The row pass of the forward (the plain version of ``ce_fwd_rows``,
    which the CPU runs) writes each chunk's per-row lse and nll into its
    slice of the ``[G, N]`` outputs: equal to ``torch.logsumexp`` and the
    gather of one unfused f32 logits tensor."""
    h, kernel, bias, labels, _ = _inputs(5)
    bias = bias if with_bias else None
    x = _unfused(h, kernel, bias)
    lab = torch.from_numpy(labels).to(torch.int64)
    lse = torch.full((1, N), np.nan)
    nll = torch.full((1, N), np.nan)
    logits = torch.from_numpy(h @ kernel)[None]
    b = None if bias is None else torch.from_numpy(bias)[None]
    for i in range(0, N, 16):
        fce.ce_fwd_rows(logits[:, i:i + 16], b, lab[None, i:i + 16],
                        lse[:, i:i + 16], nll[:, i:i + 16])
    want = torch.logsumexp(x, dim=-1)
    np.testing.assert_allclose(lse[0].numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(nll[0].numpy(),
                               (want - x[torch.arange(N), lab]).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert fce.ce_fwd_rows.launches == 0      # the CPU runs no kernel


@pytest.mark.parametrize("chunk", [16, 25, 50, 64])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_rows_backward_plain_from_saved_lse(chunk, with_bias, with_mask):
    """The row pass of the backward (the plain version of ``ce_bwd_rows``)
    from the forward's saved lse, with the label's −1 put in by index,
    against ``(softmax − one_hot) · mask · scale`` of the unfused f32
    logits, and its column sums (dbias) against that tensor's; chunk 16
    and 25 leave a ragged last chunk of N = 50, 64 exceeds it; the mask
    carries weights other than 0 and 1."""
    h, kernel, bias, labels, _ = _inputs(6)
    bias = bias if with_bias else None
    rng = np.random.default_rng(60)
    mask = (rng.random(N) * 2.0 * (rng.random(N) > 0.2)).astype(np.float32)
    mask = torch.from_numpy(mask if with_mask else np.ones(N, np.float32))
    x = _unfused(h, kernel, bias)
    lab = torch.from_numpy(labels).to(torch.int64)
    scale = torch.tensor([0.37])
    want = ((torch.softmax(x, dim=-1)
             - torch.nn.functional.one_hot(lab, kernel.shape[1]).float())
            * (mask * scale)[:, None])
    logits = torch.from_numpy(h @ kernel)[None]
    b = None if bias is None else torch.from_numpy(bias)[None]
    lse = torch.logsumexp(x, dim=-1)[None]
    dl = torch.full((1, N, kernel.shape[1]), np.nan)
    db = torch.zeros((1, kernel.shape[1]))
    for i in range(0, N, chunk):
        fce.ce_bwd_rows(logits[:, i:i + chunk], b, lab[None, i:i + chunk],
                        lse[:, i:i + chunk], mask[None, i:i + chunk], scale,
                        dl[:, i:i + chunk], db, fce.bwd_tickets(
                            1, kernel.shape[1], dl.device))
    np.testing.assert_allclose(dl[0].numpy(), want.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(db[0].numpy(), want.sum(0).numpy(), rtol=0,
                               atol=ATOL)
    assert fce.ce_bwd_rows.launches == 0


@pytest.mark.parametrize("chunk", [16, 64])
def test_dmask_from_saved_nll_matches_jax_grad(chunk):
    """``dmask`` comes from the forward's saved nll: against ``jax.grad``
    of the JAX op with respect to non-binary mask weights (and the other
    gradients with it), with and without the mask sum below 1, where the
    denominator is clamped."""
    h, kernel, bias, labels, _ = _inputs(7)
    rng = np.random.default_rng(70)
    for weights in (rng.random(N) * 3.0 * (rng.random(N) > 0.3),
                    np.full(N, 0.5 / N)):
        mask = weights.astype(np.float32)
        jargs = [jnp.asarray(a) for a in (h, kernel, bias, mask)]
        jv, jg = jax.value_and_grad(
            lambda h_, k_, b_, m_: jce(h_, jnp.asarray(labels), k_, b_,
                                       mask=m_, chunk=chunk),
            argnums=(0, 1, 2, 3))(*jargs)
        targs = [torch.from_numpy(a).requires_grad_()
                 for a in (h, kernel, bias, mask)]
        loss = tce(targs[0], torch.from_numpy(labels), targs[1], targs[2],
                   mask=targs[3], chunk=chunk)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-6)
        for t, j in zip(targs, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       rtol=1e-6, atol=ATOL)


def test_row_kernels_refuse_other_devices():
    """No fallback: a tensor on neither the CPU nor a CUDA card raises."""
    logits = torch.empty((1, 4, 8), device="meta")
    rows = torch.empty((1, 4), device="meta")
    lab = torch.empty((1, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fce.ce_fwd_rows(logits, None, lab, rows, rows)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fce.ce_bwd_rows(logits, None, lab, rows, rows,
                        torch.empty((1,), device="meta"), logits,
                        torch.empty((1, 8), device="meta"), None)


@pytest.mark.parametrize("groups, vocab, rows, sms, want", [
    (2, 16384, 512, 132, 3),     # config 9's head, two workers
    (1, 16384, 512, 132, 5),     # one worker: more splits fill the card
    (2, 16384, 100, 132, 1),     # short ragged chunk: one split
    (2, 64, 512, 132, 8),        # tiny vocabulary: capped at rows / 64
    (8, 16384, 512, 132, 1),     # enough tiles already
])
def test_bwd_splits(groups, vocab, rows, sms, want):
    assert fce.bwd_splits(groups, vocab, rows, sms, 128) == want
