"""The port's ResNet family (distkeras_tpu_torch/models/resnet.py), its
functional BatchNorm and strided SAME convs (models/layers.py), sync BN
through ``parallel.local_sgd.worker_mean``, and the BN state through the
weight bridge and a JAX-written checkpoint, held against the JAX
package's ``resnet_small`` on the same numpy inputs.

f32 on both sides, weights carried over by ``convert.tensors_from_jax``
and the statistics by ``convert.state_from_jax``. Tolerances: logits
rtol 1e-5 / atol 1e-6 (the same f32 arithmetic summed in another order),
gradients rtol 1e-4 / atol 1e-6 (they pass through BN's batch statistics,
which amplify the reordering), BN running statistics atol 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
from distkeras_tpu.models import resnet_small as jresnet
from distkeras_tpu.parallel.local_sgd import WORKER_AXIS
from distkeras_tpu_torch import checkpoint as ckpt
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.convert import (
    params_to_jax,
    state_from_jax,
    state_to_jax,
    tensors_from_jax,
)
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import resnet_small
from distkeras_tpu_torch.models.layers import BatchNorm, Conv, same_pads
from distkeras_tpu_torch.parallel.local_sgd import worker_mean

LOGITS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
STATS = dict(rtol=0, atol=1e-6)
SMALL = dict(widths=(4, 8), input_shape=(8, 8, 3))


@functools.lru_cache(maxsize=None)
def _pair(sync_bn=False):
    """(JAX spec, port spec, flax params, flax state), read-only."""
    cfg = SMALL
    jspec = jresnet(dtype=jnp.float32, sync_bn=sync_bn, **cfg)
    tspec = resnet_small(dtype=torch.float32, sync_bn=sync_bn, **cfg)
    # jitted: flax's op-by-op init of a BN network takes seconds on the CPU
    p, nt = jax.tree_util.tree_map(
        np.asarray, jax.jit(jspec.init)(jax.random.PRNGKey(0)))
    return jspec, tspec, p, nt


def _images(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close_trees(got, ref, tol):
    ref_l = jax.tree_util.tree_leaves_with_path(ref)
    got_l = jax.tree_util.tree_leaves_with_path(got)
    assert [k for k, _ in got_l] == [k for k, _ in ref_l]
    for (k, r), (_, g) in zip(ref_l, got_l):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), **tol,
                                   err_msg=jax.tree_util.keystr(k))


def _port_grads(tspec, tp, tst, x, cot, training=True):
    x, cot = torch.as_tensor(x), torch.as_tensor(cot)

    def f(params):
        out, new = tspec.apply(params, tst, x, training)
        return torch.sum(out * cot), (out, new)

    grads, (out, new) = torch.func.grad(f, has_aux=True)(tp)
    return grads, out, new


def _jax_grads(jspec, p, nt, x, cot, training=True):
    def f(params):
        out, new = jspec.apply(params, nt, x, training)
        return jnp.sum(out * cot), (out, new)

    return jax.jit(jax.grad(f, has_aux=True))(p)


def test_same_pads_follow_xla():
    """flax's SAME at stride 2 on an even width pads (0, 1): torch's
    symmetric ``padding=1`` would shift every strided output."""
    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(31, 3, 2) == (1, 1)
    assert same_pads(32, 1, 2) == (0, 0)
    assert same_pads(28, 5, 1) == (2, 2)
    for size, k, s in ((7, 3, 2), (8, 4, 1), (9, 2, 3), (16, 3, 1)):
        (lo, hi), = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")
        assert same_pads(size, k, s) == (lo, hi)


@pytest.mark.parametrize("width", [8, 10])
def test_stride2_conv_matches_flax_same_padding(width):
    """A stride-2 3×3 conv and a stride-2 1×1 projection at even and odd
    widths, against ``flax.linen.Conv(padding="SAME")``."""
    import flax.linen as fnn

    x = _images((2, width, width, 3))
    for k in (3, 1):
        jconv = fnn.Conv(5, (k, k), strides=(2, 2), padding="SAME",
                         use_bias=False, dtype=jnp.float32)
        p = jax.device_get(jconv.init(jax.random.PRNGKey(0), x)["params"])
        ref = np.asarray(jconv.apply({"params": p}, x))
        conv = Conv(3, 5, k, torch.float32, stride=2, use_bias=False)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(
                np.array(p["kernel"]).transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).detach().numpy(), ref, **LOGITS)


def test_train_forward_stats_and_grads_match_flax():
    """Training mode at an even width with a stride-2 block and a
    projection: logits, the new ``batch_stats`` and every parameter's
    gradient."""
    jspec, tspec, p, nt = _pair()
    x = _images((4, 8, 8, 3))
    cot = _images((4, 10), seed=2)
    tp = tensors_from_jax(p, tspec.module)
    tst = state_from_jax(nt["batch_stats"], tspec.module)
    jg, (jout, jnt) = _jax_grads(jspec, p, nt, x, cot)
    tg, tout, tnt = _port_grads(tspec, tp, tst, x, cot)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **LOGITS)
    _close_trees(state_to_jax(tnt, tspec.module), jnt["batch_stats"], STATS)
    _close_trees(params_to_jax(tg, tspec.module), jg, GRADS)
    # the statistics moved off their (0, 1) init
    assert float(torch.abs(tnt["bn_stem.mean"]).max()) > 1e-3


def test_eval_mode_uses_the_running_statistics():
    """Eval mode after one training step: the stats it normalizes with are
    the moved ones, and it returns the state unchanged."""
    jspec, tspec, p, nt = _pair()
    _, jnt = jspec.apply(p, nt, _images((4, 8, 8, 3)), True)
    x = _images((3, 8, 8, 3), seed=5)
    ref, jnt2 = jspec.apply(p, jnt, x, False)
    tst = state_from_jax(jnt["batch_stats"], tspec.module)
    got, tnt = tspec.apply(tensors_from_jax(p, tspec.module), tst,
                           torch.from_numpy(x), False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **LOGITS)
    assert tnt.keys() == tst.keys()
    assert all(tnt[k] is tst[k] for k in tst)
    fresh, _ = tspec.apply(tensors_from_jax(p, tspec.module), tspec.init(0)[1],
                           torch.from_numpy(x), False)
    assert not np.allclose(fresh.detach().numpy(), np.asarray(ref))


def test_batchnorm_variance_is_flax_fast_variance():
    """``var = max(0, E[x²] − E[x]²)`` in f32 and a 0.9 momentum: a
    constant channel's variance clamps at 0 rather than going negative."""
    bn = BatchNorm(2)
    x = torch.ones(4, 2, 3, 3) * 3.0
    x[:, 1] = torch.linspace(-1, 1, 36).reshape(4, 3, 3)
    y, new = bn(x, training=True)
    assert float(new["var"][0]) == pytest.approx(0.9, abs=1e-7)
    mean, var = x[:, 1].mean(), (x[:, 1] ** 2).mean() - x[:, 1].mean() ** 2
    assert float(new["mean"][1]) == pytest.approx(0.1 * float(mean),
                                                  abs=1e-7)
    assert float(new["var"][1]) == pytest.approx(0.9 + 0.1 * float(var),
                                                 abs=1e-6)
    assert torch.all(y[:, 0] == 0.0)
    _, none = bn(x, training=False)
    assert none == {}


def test_worker_mean_gradient_is_pmeans_transpose():
    """Under ``vmap(grad)`` worker i gets ∂(Σ_j loss_j)/∂θ_i, as
    ``lax.pmean`` over a named axis gives in the JAX package; the
    own-loss gradient would be [-0.5, 4.33, 12.67]."""
    def f_t(w, x):
        xw = x * w
        m = worker_mean(xw)
        return torch.sum((xw - m) ** 2) + torch.sum(m)

    def f_j(w, x):
        xw = x * w
        m = jax.lax.pmean(xw, WORKER_AXIS)
        return jnp.sum((xw - m) ** 2) + jnp.sum(m)

    w = np.array([1.0, 2.0, 3.0], np.float32)
    x = np.array([0.5, -1.0, 2.0], np.float32)
    got = torch.func.vmap(torch.func.grad(f_t))(torch.from_numpy(w),
                                                torch.from_numpy(x))
    ref = jax.vmap(jax.grad(f_j), axis_name=WORKER_AXIS)(w, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), [-0.5, 6.0, 20.0], rtol=1e-6)
    # outside vmap it is the identity, gradient included
    t = torch.tensor([1.0, 2.0], requires_grad=True)
    worker_mean(t).sum().backward()
    assert torch.equal(t.grad, torch.ones(2))


def test_sync_bn_matches_jax_worker_axis():
    """sync BN over W = 3 stacked workers, each with its own params and
    batch: the forward, the (equal) statistics and the per-worker
    gradients against ``jax.vmap(jax.grad(...), axis_name=WORKER_AXIS)``.
    """
    W = 3
    jspec, tspec, p, nt = _pair(sync_bn=True)
    assert tspec.requires_worker_axis and jspec.requires_worker_axis
    rng = np.random.default_rng(3)
    ps = jax.tree_util.tree_map(
        lambda a: np.stack([a + 0.05 * i * rng.normal(size=a.shape)
                            .astype(np.float32) for i in range(W)]), p)
    nts = jax.tree_util.tree_map(lambda a: np.stack([a] * W), nt)
    x = _images((W, 4, 8, 8, 3))
    cot = _images((W, 4, 10), seed=2)

    jg, (jout, jnt) = jax.vmap(
        lambda pp, nn_, xx, cc: _jax_grads(jspec, pp, nn_, xx, cc),
        axis_name=WORKER_AXIS)(ps, nts, x, cot)
    tps = {k: torch.stack([tensors_from_jax(
        jax.tree_util.tree_map(lambda a: a[i], ps), tspec.module)[k]
        for i in range(W)]) for k in tensors_from_jax(p, tspec.module)}
    tnts = {k: v[None].expand(W, *v.shape).clone() for k, v in
            state_from_jax(nt["batch_stats"], tspec.module).items()}
    tg, tout, tnt = torch.func.vmap(
        lambda pp, nn_, xx, cc: _port_grads(tspec, pp, nn_, xx, cc))(
        tps, tnts, torch.from_numpy(x), torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **LOGITS)
    for i in range(W):
        pick = lambda t: {k: v[i] for k, v in t.items()}  # noqa: E731
        _close_trees(state_to_jax(pick(tnt), tspec.module),
                     jax.tree_util.tree_map(lambda a: a[i],
                                            jnt["batch_stats"]), STATS)
        _close_trees(params_to_jax(pick(tg), tspec.module),
                     jax.tree_util.tree_map(lambda a: a[i], jg), GRADS)
    # global-batch statistics: every worker carries the same ones
    m = tnt["bn_stem.mean"]
    assert torch.allclose(m, m[:1].expand_as(m), atol=1e-7)


def test_sync_bn_forward_equals_the_flat_batch():
    W, B = 4, 3
    _, tspec, p, _ = _pair(sync_bn=True)
    flat = resnet_small(dtype=torch.float32, **SMALL)
    tp = tensors_from_jax(p, tspec.module)
    st = tspec.init(0)[1]
    x = torch.from_numpy(_images((W, B, 8, 8, 3)))
    out_w, nt_w = torch.func.vmap(
        lambda xs: tspec.apply(tp, st, xs, True))(x)
    out_f, nt_f = flat.apply(tp, st, x.reshape(W * B, 8, 8, 3), True)
    np.testing.assert_allclose(out_w.reshape(W * B, -1).numpy(),
                               out_f.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(nt_w["bn_stem.mean"][0].numpy(),
                               nt_f["bn_stem.mean"].numpy(), **STATS)


def _cifar(n=96, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    x[np.arange(n), y % 8, :, 0] += 2.0   # a learnable class signal
    return x, y


_TRAIN = dict(loss="sparse_softmax_cross_entropy", worker_optimizer="adam",
              learning_rate=3e-3, num_workers=2, batch_size=8,
              communication_window=2, seed=0)


def test_sync_bn_is_refused_on_the_ps_backend():
    spec = resnet_small(dtype=torch.float32, sync_bn=True, **SMALL)
    t = trainers.DOWNPOUR(spec, backend="ps", device="cpu", **_TRAIN)
    with pytest.raises(ValueError, match="stacked-worker axis"):
        t.train(Dataset.from_arrays(*_cifar()))


@pytest.mark.parametrize("sync_bn", [False, True])
def test_resnet_trains_through_adag_with_its_statistics(sync_bn):
    """ADAG on the CPU: the loss is finite, ``trained_nt_`` holds moved
    statistics (equal across workers under sync BN), and the eval-mode
    forward on the center with them is finite."""
    spec = resnet_small(dtype=torch.float32, sync_bn=sync_bn, **SMALL)
    t = trainers.ADAG(spec, device="cpu", num_epoch=2, **_TRAIN)
    x, y = _cifar()
    center = t.train(Dataset.from_arrays(x, y))
    losses = [r["loss"] for r in t.get_history() if "loss" in r]
    assert losses and np.all(np.isfinite(losses))
    nt = t.trained_nt_
    assert float(torch.abs(nt["bn_stem.mean"]).max()) > 1e-3
    assert float(torch.abs(nt["bn_stem.var"] - 1).max()) > 1e-3
    stacked = t.state_.nt["bn_stem.var"]
    assert torch.equal(stacked[0], stacked[1]) == sync_bn
    out, _ = spec.apply(center, nt, torch.from_numpy(x[:5]), False)
    assert out.shape == (5, 10) and torch.all(torch.isfinite(out))


def test_resnet_resume_from_a_jax_checkpoint_restores_its_statistics(
        tmp_path):
    """A ``.dkc`` the JAX ADAG trainer wrote for a ResNet: the port's
    resume takes its center and worker 0's BatchNorm statistics (not the
    (0, 1) init), and with no epoch left returns them as trained."""
    d = tmp_path / "jck"
    jspec = jresnet(dtype=jnp.float32, **SMALL)
    x, y = _cifar()
    from distkeras_tpu.data import Dataset as JDataset

    jt = jdk.ADAG(jspec, num_epoch=1, checkpoint_dir=d, **_TRAIN)
    jcenter = jax.device_get(jt.train(JDataset.from_arrays(x, y)))
    r = ckpt.load_checkpoint(d)
    assert r.origin == "jax"
    spec = resnet_small(dtype=torch.float32, **SMALL)
    t = trainers.ADAG(spec, device="cpu", num_epoch=1, checkpoint_dir=d,
                      resume=True, **_TRAIN)
    with pytest.warns(UserWarning, match="elastic resume"):
        out = t.train(Dataset.from_arrays(x, y))
    want = tensors_from_jax(jcenter, spec.module)
    assert set(out) == set(want)
    assert all(torch.equal(out[k], want[k]) for k in want)
    jnt0 = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                  r.tree["state"]["nt"]["batch_stats"])
    stats = state_from_jax(jnt0, spec.module)
    assert float(torch.abs(stats["bn_stem.mean"]).max()) > 1e-3
    for k, v in stats.items():
        assert torch.equal(t.trained_nt_[k], v), k
    # every worker of the resumed state starts from those statistics
    assert torch.equal(t.state_.nt["bn_stem.var"][1], stats["bn_stem.var"])
    with pytest.raises(ValueError, match="shape"):
        state_from_jax(jnt0, resnet_small(dtype=torch.float32, widths=(4, 6),
                                          input_shape=(8, 8, 3)).module)


def test_spec_init_state_is_flax_init():
    jspec, tspec, p, nt = _pair()
    params, state = tspec.init(0)
    _close_trees(state_to_jax(state, tspec.module), nt["batch_stats"],
                 dict(rtol=0, atol=0))
    assert set(params) == set(tensors_from_jax(p, tspec.module))
    assert dataclasses.replace(tspec).requires_worker_axis is False
