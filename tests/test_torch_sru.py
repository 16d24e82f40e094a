"""The port's SRU classifier (distkeras_tpu_torch/models/sru.py) held
against the JAX package's ``sru_classifier`` on the same numpy inputs.

``impl="assoc"`` is a log-depth doubling scan in plain PyTorch, the JAX
package's ``lax.associative_scan`` a different tree over the same
composition, ``impl="scan"`` the sequential oracle on both sides: the same
values up to f32 rounding, never bit-equal across the two. f32 on both
sides, weights carried over by ``convert.tensors_from_jax``. Tolerances:
logits rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models.sru import sru_classifier as jsru
from distkeras_tpu.models.sru import sru_recurrence as jsru_recurrence
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import sru_classifier
from distkeras_tpu_torch.models.sru import sru_recurrence

LOGITS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
CFG = dict(vocab=50, embed_dim=12, hidden_dim=16, depth=2)
T = 13


@functools.lru_cache(maxsize=None)
def _pair(impl):
    jspec = jsru(maxlen=T, dtype=jnp.float32, impl=impl, **CFG)
    tspec = sru_classifier(maxlen=T, dtype=torch.float32, impl=impl, **CFG)
    p, _ = jax.tree_util.tree_map(
        np.asarray, jax.jit(jspec.init)(jax.random.PRNGKey(0)))
    return jspec, tspec, p


def _batch(seed=1, B=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[0, 9:] = 0.0
    mask[2, 4:] = 0.0
    return toks, mask


def _gates(seed=0, B=3, T_=37, H=5, f_shift=0.0):
    g = np.random.default_rng(seed).normal(size=(B, T_, 3 * H))
    g[..., H:2 * H] += f_shift
    return g.astype(np.float32)


@pytest.mark.parametrize("T_", [1, 2, 37, 64])
def test_assoc_equals_the_sequential_scan(T_):
    g = torch.from_numpy(_gates(T_=T_))
    ca, ra = sru_recurrence(g, "assoc")
    cs, rs = sru_recurrence(g, "scan")
    assert ca.dtype == torch.float32 and ca.shape == (3, T_, 5)
    torch.testing.assert_close(ca, cs, rtol=1e-5, atol=1e-6)
    assert torch.equal(ra, rs)


def test_assoc_survives_gates_that_underflow():
    """Forget gates near 0 for hundreds of steps: their running product
    underflows f32, which a cumprod/cumsum closed form would divide by;
    the doubling scan never divides."""
    g = torch.from_numpy(_gates(T_=300, f_shift=-30.0))
    ca, _ = sru_recurrence(g, "assoc")
    cs, _ = sru_recurrence(g, "scan")
    assert torch.all(torch.isfinite(ca))
    torch.testing.assert_close(ca, cs, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["assoc", "scan"])
def test_recurrence_matches_jax_with_gradients(impl):
    g = _gates(T_=29)
    cot = _gates(seed=4, T_=29)[..., :10]

    def jf(x):
        c, r = jsru_recurrence(x, impl=impl)
        return jnp.sum(jnp.concatenate([c, r], -1) * cot)

    def tf(x):
        c, r = sru_recurrence(x, impl)
        return torch.sum(torch.cat([c, r], -1) * torch.from_numpy(cot))

    jc, jr = jsru_recurrence(g, impl=impl)
    tc, tr = sru_recurrence(torch.from_numpy(g), impl)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **LOGITS)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **LOGITS)
    np.testing.assert_allclose(torch.func.grad(tf)(torch.from_numpy(g))
                               .numpy(), np.asarray(jax.grad(jf)(g)), **GRADS)


@pytest.mark.parametrize("impl", ["assoc", "scan"])
def test_classifier_matches_jax_logits_and_gradients(impl):
    """depth 2 with embed ≠ hidden: layer 0 has the ``skip_0``
    projection, layer 1 the identity highway."""
    jspec, tspec, p = _pair(impl)
    toks, mask = _batch()
    y = np.array([0, 1, 1, 0])
    tp = tensors_from_jax(p, tspec.module)
    assert "skip_0.weight" in tp and "skip_1.weight" not in tp

    def jloss(params):
        out, _ = jspec.apply(params, {}, (toks, mask), True)
        return -jnp.mean(jax.nn.log_softmax(out)[np.arange(4), y]), out

    def tloss(params):
        out, _ = tspec.apply(params, {}, (torch.from_numpy(toks),
                                          torch.from_numpy(mask)), True)
        logp = torch.log_softmax(out, -1)
        return -torch.mean(logp[torch.arange(4), torch.from_numpy(y)]), out

    jg, jout = jax.jit(jax.grad(jloss, has_aux=True))(p)
    tg, tout = torch.func.grad(tloss, has_aux=True)(tp)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **LOGITS)
    back = params_to_jax(tg, tspec.module)
    ref = jax.tree_util.tree_leaves_with_path(jg)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, r), (_, g) in zip(ref, got):
        np.testing.assert_allclose(g, np.asarray(r), **GRADS,
                                   err_msg=jax.tree_util.keystr(k))


def test_padding_is_ignored_under_the_mask():
    _, tspec, p = _pair("assoc")
    toks, mask = _batch()
    other = toks.copy()
    other[mask == 0] = (other[mask == 0] + 7) % CFG["vocab"]
    tp = tensors_from_jax(p, tspec.module)
    run = lambda t: tspec.apply(tp, {}, (torch.from_numpy(t),  # noqa: E731
                                         torch.from_numpy(mask)), False)[0]
    a, b = run(toks), run(other)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # and the unmasked rows do see their tokens
    assert not torch.allclose(a[1], run(np.roll(toks, 1, axis=1))[1])


def test_an_unknown_impl_raises_as_in_jax():
    with pytest.raises(ValueError, match="unknown SRU impl 'cuda'"):
        sru_recurrence(torch.zeros(1, 3, 6), "cuda")
    with pytest.raises(ValueError, match="unknown SRU impl 'cuda'"):
        sru_classifier(impl="cuda")
    with pytest.raises(ValueError, match="unknown SRU impl 'cuda'"):
        jsru_recurrence(jnp.zeros((1, 3, 6)), impl="cuda")


def test_sru_trains_through_adag():
    rng = np.random.default_rng(0)
    n = 128
    y = rng.integers(0, 2, n).astype(np.int32)
    toks = rng.integers(2, CFG["vocab"], (n, T)).astype(np.int32)
    toks[:, 0] = y                       # the label in the first token
    mask = np.ones((n, T), np.float32)
    ds = Dataset({"features": toks, "mask": mask, "label": y})
    t = trainers.ADAG(sru_classifier(maxlen=T, dtype=torch.float32, **CFG),
                      loss="sparse_softmax_cross_entropy",
                      worker_optimizer="adam", learning_rate=1e-2,
                      num_workers=2, batch_size=16, communication_window=2,
                      num_epoch=3, features_col=["features", "mask"],
                      device="cpu")
    t.train(ds)
    losses = [r["loss"] for r in t.get_history() if "loss" in r]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
