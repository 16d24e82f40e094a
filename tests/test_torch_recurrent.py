"""The port's LSTM scan (distkeras_tpu_torch/ops/recurrent.py) held against
the JAX package's fused scan in Pallas interpret mode and its lax.scan
reference, values and gradients, on the same numpy inputs.

On the CPU the autograd Functions run the kernels' plain versions; the
CUDA kernels K6/K7 are held against those plain versions on the card by
``chip_smoke.py``. Tolerances, in f32: the forward agrees to 1e-5 (the
port adds gx in f32 as the TPU kernel does; the reference's extra
rounding vanishes in f32, summation order differs); gradients to 2e-4
relative and 2e-5 absolute, the bound tests/test_recurrent.py holds the
TPU kernel's own gradients to (errors compound over 16 reverse steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops import recurrent as jrec
from distkeras_tpu_torch.ops import recurrent as trec

B, T, H = 8, 16, 32
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-4, atol=2e-5)


def make_inputs(seed, b=B, t=T, h=H):
    rng = np.random.default_rng(seed)
    gx = rng.normal(0, 0.5, size=(b, t, 4 * h)).astype(np.float32)
    wh = (rng.normal(0, 1.0, size=(h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    probe = rng.normal(size=(b, t, h)).astype(np.float32)
    return gx, wh, probe


def jax_pallas(gx, wh):
    return jrec.lstm_scan(gx, wh, impl="pallas", interpret=True)


@pytest.mark.parametrize("oracle", ["pallas", "reference"])
def test_forward_matches_jax(oracle):
    gx, wh, _ = make_inputs(0)
    fn = jax_pallas if oracle == "pallas" else jrec.lstm_scan_reference
    ref = np.asarray(fn(jnp.asarray(gx), jnp.asarray(wh)))
    got = trec.lstm_scan(torch.from_numpy(gx), torch.from_numpy(wh))
    assert got.dtype == torch.float32 and got.shape == (B, T, H)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize("oracle", ["pallas", "reference"])
def test_gradients_match_jax(oracle):
    gx, wh, probe = make_inputs(1)
    fn = jax_pallas if oracle == "pallas" else jrec.lstm_scan_reference
    jg = jax.grad(lambda a, b: jnp.sum(fn(a, b) * probe), argnums=(0, 1))(
        jnp.asarray(gx), jnp.asarray(wh))
    p = torch.from_numpy(probe)
    tg = torch.func.grad(
        lambda a, b: torch.sum(trec.lstm_scan(a, b) * p), argnums=(0, 1))(
        torch.from_numpy(gx), torch.from_numpy(wh))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL)


@pytest.mark.parametrize("b,t", [(8, 1), (8, 2), (17, 16)],
                         ids=["T1", "T2", "B17"])
@pytest.mark.parametrize("oracle", ["pallas", "reference"])
def test_gradients_match_jax_at_scan_edges(oracle, b, t):
    """The edges of the backward kernel's one-step-ahead prefetch (T = 1:
    no step to prefetch; T = 2: one) and a batch that leaves a ragged
    16-row tile (B = 17), against JAX's gradients at the tolerance of
    ``test_gradients_match_jax``."""
    gx, wh, probe = make_inputs(20 + t, b=b, t=t)
    fn = jax_pallas if oracle == "pallas" else jrec.lstm_scan_reference
    jg = jax.grad(lambda a, w: jnp.sum(fn(a, w) * probe), argnums=(0, 1))(
        jnp.asarray(gx), jnp.asarray(wh))
    p = torch.from_numpy(probe)
    tg = torch.func.grad(
        lambda a, w: torch.sum(trec.lstm_scan(a, w) * p), argnums=(0, 1))(
        torch.from_numpy(gx), torch.from_numpy(wh))
    for a, r in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GTOL)


def test_autograd_backward_matches_func_grad():
    """``loss.backward()`` through the Functions equals ``torch.func.grad``
    and the plain-torch reference's autograd (f32 products of the same
    values: 1e-6)."""
    gx, wh, probe = make_inputs(2)
    p = torch.from_numpy(probe)
    grads = []
    for impl in ("kernel", "plain", "reference"):
        a = torch.from_numpy(gx).requires_grad_()
        b = torch.from_numpy(wh).requires_grad_()
        torch.sum(trec.lstm_scan(a, b, impl=impl) * p).backward()
        grads.append((a.grad.numpy(), b.grad.numpy()))
    for other in grads[1:]:
        for x, y in zip(grads[0], other):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batched_wh", [True, False])
def test_vmap_grad_equals_loop_over_workers(batched_wh):
    """The engine's ``vmap(grad)`` folds the worker axis into the kernels'
    G axis; it must equal a Python loop over workers (the same f32
    arithmetic in another batching: 1e-6)."""
    Wk = 3
    gxs, whs, probes = zip(*(make_inputs(10 + w, b=4, t=6) for w in range(Wk)))
    gxs = torch.from_numpy(np.stack(gxs))
    whs = torch.from_numpy(np.stack(whs))
    probes = torch.from_numpy(np.stack(probes))

    def loss(g, w, pr):
        return torch.sum(trec.lstm_scan(g, w) * pr)

    grad = torch.func.grad_and_value(loss, argnums=(0, 1))
    wh_in = whs if batched_wh else whs[0]
    (dg, dw), vals = torch.func.vmap(
        grad, in_dims=(0, 0 if batched_wh else None, 0))(gxs, wh_in, probes)
    for w in range(Wk):
        (rg, rw), rv = grad(gxs[w], whs[w] if batched_wh else whs[0],
                            probes[w])
        np.testing.assert_allclose(dg[w].numpy(), rg.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(dw[w].numpy(), rw.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(vals[w].item(), rv.item(), rtol=1e-6)


def test_plain_versions_batch_along_g():
    """K6/K7's plain versions over a G axis equal G separate calls, and
    the forward without the saved cell states returns the same hs."""
    gx, wh, probe = make_inputs(3, b=4, t=5)
    g2 = torch.from_numpy(np.stack([gx, gx[::-1].copy()]))
    w2 = torch.from_numpy(np.stack([wh, wh * 0.5]))
    hs, cs = trec._lstm_fwd_plain(g2, w2, True)
    hs_only, empty = trec._lstm_fwd_plain(g2, w2, False)
    assert empty.numel() == 0
    torch.testing.assert_close(hs, hs_only, rtol=0, atol=0)
    dgx, dwh = trec._lstm_bwd_plain(g2, w2, hs, cs, torch.ones_like(hs))
    for g in range(2):
        h1, c1 = trec._lstm_fwd_plain(g2[g:g + 1], w2[g:g + 1], True)
        torch.testing.assert_close(h1[0], hs[g], rtol=0, atol=0)
        d1, w1 = trec._lstm_bwd_plain(g2[g:g + 1], w2[g:g + 1], h1, c1,
                                      torch.ones_like(h1))
        torch.testing.assert_close(d1[0], dgx[g], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(w1[0], dwh[g], rtol=1e-6, atol=1e-6)


def test_bf16_forward_near_jax_pallas():
    """bf16 gates: the port rounds where the TPU kernel rounds (h, hs and
    cs in bf16, c and z in f32), so the two agree to the bf16 floor
    (2e-2: one bf16 ulp of |h| < 1 plus compounding over 16 steps)."""
    gx, wh, _ = make_inputs(4)
    ref = jax_pallas(jnp.asarray(gx).astype(jnp.bfloat16), jnp.asarray(wh))
    got = trec.lstm_scan(torch.from_numpy(gx).to(torch.bfloat16),
                         torch.from_numpy(wh))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("save_c", [False, True])
@pytest.mark.parametrize("b,t,h", [(8, 16, 32), (17, 5, 64)],
                         ids=["B8H32", "B17H64"])
def test_forward_with_and_without_cells_matches_jax_pallas(b, t, h, save_c):
    """K6's entry without the saved cell states (the eval path's launch)
    and with them, against the JAX package's Pallas forward ``_fwd`` in
    interpret mode with the same ``save_c``: hs (and cs) to the forward
    tolerance of ``test_forward_matches_jax``; without cells no cs is
    made. H 32 and 64 and a ragged 16-row tile (B=17) are shapes the
    card's cluster scan takes."""
    gx, wh, _ = make_inputs(30 + h + save_c, b=b, t=t, h=h)
    jhs, jcs = jrec._fwd(jnp.asarray(gx).transpose(1, 0, 2), jnp.asarray(wh),
                         True, save_c=save_c)
    hs, cs = trec.lstm_forward(torch.from_numpy(gx)[None],
                               torch.from_numpy(wh)[None], save_c)
    assert hs.shape == (1, b, t, h) and hs.dtype == torch.float32
    np.testing.assert_allclose(hs[0].numpy(),
                               np.asarray(jhs).transpose(1, 0, 2), **TOL)
    if save_c:
        np.testing.assert_allclose(cs[0].numpy(),
                                   np.asarray(jcs).transpose(1, 0, 2), **TOL)
    else:
        assert jcs is None and cs.numel() == 0


def test_impl_validation_and_no_kernel_on_cpu():
    gx, wh, _ = make_inputs(5, b=2, t=3)
    with pytest.raises(ValueError, match="lstm impl"):
        trec.lstm_scan(torch.from_numpy(gx), torch.from_numpy(wh),
                       impl="warp")
    before = (trec.lstm_forward.launches, trec.lstm_backward.launches)
    a = torch.from_numpy(gx).requires_grad_()
    trec.lstm_scan(a, torch.from_numpy(wh)).sum().backward()
    assert (trec.lstm_forward.launches, trec.lstm_backward.launches) == before
    meta = torch.empty((1, 2, 3, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        trec.lstm_forward(meta, torch.empty((1, 16, 64), device="meta"), True)
