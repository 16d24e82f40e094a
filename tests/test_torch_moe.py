"""The port's mixture of experts (distkeras_tpu_torch/parallel/expert.py,
models/moe.py) held against the JAX package's single-device oracle
``moe_mlp_reference`` and ``moe_transformer_classifier`` on the same numpy
inputs.

f32 on both sides, weights carried over by ``convert.tensors_from_jax``.
Tolerances: outputs and logits rtol 1e-5 / atol 1e-6, gradients rtol 1e-4
/ atol 1e-6, the aux loss rtol 1e-6. Random gate logits have no ties, so
both sides pick the same experts and the same slots.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models.moe import moe_aux_loss as jmoe_aux_loss
from distkeras_tpu.models.moe import moe_transformer_classifier as jmoe
from distkeras_tpu.parallel import expert as jexpert
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import (
    moe_aux_loss,
    moe_transformer_classifier,
)
from distkeras_tpu_torch.parallel import expert, moe_mlp_reference

OUT = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
CFG = dict(vocab=40, maxlen=12, dim=16, heads=2, depth=2, num_experts=4,
           top_k=2, capacity_factor=2.0)


def _moe_params(seed=0, d=8, h=12, E=4):
    p = jexpert.init_moe_params(np.random.default_rng(seed), d, h, E,
                                scale=0.3)
    rng = np.random.default_rng(seed + 1)
    p["b1"] = rng.normal(0, 0.1, p["b1"].shape).astype(np.float32)
    p["b2"] = rng.normal(0, 0.1, p["b2"].shape).astype(np.float32)
    return p


def _tokens(T=24, d=8, seed=2):
    return np.random.default_rng(seed).normal(size=(T, d)).astype(np.float32)


def test_init_moe_params_draws_the_jax_numbers():
    a = jexpert.init_moe_params(np.random.default_rng(5), 4, 6, 3)
    b = expert.init_moe_params(np.random.default_rng(5), 4, 6, 3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("top_k,cf", [(1, None), (2, 2.0), (2, 0.5),
                                      (1, 0.25)])
def test_moe_mlp_reference_matches_jax(top_k, cf):
    """Output, aux and the gradients of params and tokens; ``cf`` 0.5 and
    0.25 overflow the capacity and drop tokens (checked)."""
    p, x = _moe_params(), _tokens()
    cot = _tokens(seed=9)

    def jf(pp, xx):
        y, aux = jexpert.moe_mlp_reference(pp, xx, top_k=top_k,
                                           capacity_factor=cf)
        return jnp.sum(y * cot) + 3.0 * aux, (y, aux)

    def tf(pp, xx):
        y, aux = moe_mlp_reference(pp, xx, top_k=top_k, capacity_factor=cf)
        return torch.sum(y * torch.from_numpy(cot)) + 3.0 * aux, (y, aux)

    (jgp, jgx), (jy, jaux) = jax.jit(jax.grad(jf, argnums=(0, 1),
                                             has_aux=True))(p, x)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    (tgp, tgx), (ty, taux) = torch.func.grad(tf, argnums=(0, 1),
                                             has_aux=True)(
        tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **OUT)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), **GRADS)
    for k in p:
        np.testing.assert_allclose(tgp[k].numpy(), np.asarray(jgp[k]),
                                   **GRADS, err_msg=k)
    T, E = x.shape[0], p["gate"].shape[1]
    cap = expert.moe_capacity(T, E, top_k, cf)
    dispatch, _, _ = expert._dispatch_combine(
        torch.from_numpy(x @ p["gate"]), E, cap, top_k)
    kept = float(dispatch.sum())
    assert dispatch.amax(dim=0).le(1).all()        # one token a slot
    if cf is not None and cf < 1:
        assert kept < T * top_k                    # overflow dropped some
    else:
        assert kept == T * top_k


def test_dispatch_is_choice_major_and_drops_overflow():
    """Four tokens all preferring expert 0 then 1, capacity 2: expert 0
    takes tokens 0 and 1 (first choices), expert 1 takes tokens 0 and 1's
    second choices before 2 and 3's; tokens 2 and 3 are dropped."""
    logits = torch.tensor([[4.0, 3.0, 0.0]] * 4)
    d, c, aux = expert._dispatch_combine(logits, 3, 2, 2)
    jd, jc, jaux = jexpert._dispatch_combine(jnp.asarray(logits.numpy()), 3,
                                             2, 2)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6)
    assert d[:2, 0].sum() == 2 and d[2:].sum() == 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _pair():
    jspec = jmoe(dtype=jnp.float32, **CFG)
    tspec = moe_transformer_classifier(dtype=torch.float32, **CFG)
    p, _ = jax.tree_util.tree_map(
        np.asarray, jax.jit(jspec.init)(jax.random.PRNGKey(0)))
    return jspec, tspec, p


def _batch(B=3, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], (B, CFG["maxlen"])).astype(np.int32)
    mask = np.ones(toks.shape, np.float32)
    mask[1, 7:] = 0.0
    return toks, mask


def test_classifier_matches_jax_logits_and_gradients():
    jspec, tspec, p = _pair()
    toks, mask = _batch()
    cot = np.random.default_rng(4).normal(size=(3, 2)).astype(np.float32)
    tp = tensors_from_jax(p, tspec.module)
    assert {"block_0.gate", "block_1.w2", "embed.weight"} <= set(tp)

    def jf(pp):
        out, _ = jspec.apply(pp, {}, (toks, mask), True)
        return jnp.sum(out * cot), out

    def tf(pp):
        out, _ = tspec.apply(pp, {}, (torch.from_numpy(toks),
                                      torch.from_numpy(mask)), True)
        return torch.sum(out * torch.from_numpy(cot)), out

    jg, jout = jax.jit(jax.grad(jf, has_aux=True))(p)
    tg, tout = torch.func.grad(tf, has_aux=True)(tp)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **OUT)
    ref = jax.tree_util.tree_leaves_with_path(jg)
    got = jax.tree_util.tree_leaves_with_path(params_to_jax(tg, tspec.module))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, r), (_, g) in zip(ref, got):
        np.testing.assert_allclose(g, np.asarray(r), **GRADS,
                                   err_msg=jax.tree_util.keystr(k))


def test_moe_aux_loss_matches_jax():
    jspec, tspec, p = _pair()
    toks, mask = _batch()
    jout, jaux = jax.jit(lambda pp: jmoe_aux_loss(jspec.module, pp,
                                                  (toks, mask)))(p)
    tp = tensors_from_jax(p, tspec.module)
    tout, taux = moe_aux_loss(tspec.module, tp, (torch.from_numpy(toks),
                                                 torch.from_numpy(mask)))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **OUT)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0.0
    # the aux is differentiable, for an objective that adds it
    g = torch.func.grad(lambda pp: moe_aux_loss(
        tspec.module, pp, (torch.from_numpy(toks),
                           torch.from_numpy(mask)))[1])(tp)
    assert float(g["block_0.gate"].abs().sum()) > 0.0


def test_the_expert_parallel_paths_name_their_item():
    """The expert-parallel paths are ported (A12): over an ``ep`` mesh of
    one rank ``moe_mlp`` is the single-device layer and
    ``moe_transformer_classifier(mesh=...)`` the mesh-less model, to f32
    rounding (multi-rank meshes: ``tests/test_torch_mesh_strategies.py``);
    experts that do not divide over the axis raise."""
    from distkeras_tpu_torch.parallel.mesh import Mesh

    params = {k: torch.from_numpy(v) for k, v in _moe_params().items()}
    x = torch.from_numpy(_tokens())
    with Mesh({"ep": 1}, device="cpu") as mesh:
        y, aux = expert.moe_mlp(params, x, mesh, top_k=2)
        ry, raux = moe_mlp_reference(params, x, top_k=2,
                                     capacity_factor=2.0)
        np.testing.assert_allclose(y.numpy(), ry.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
        kw = dict(vocab=30, maxlen=8, dim=8, heads=2, depth=1,
                  num_experts=4, dtype=torch.float32)
        plain, sharded = (moe_transformer_classifier(**kw),
                          moe_transformer_classifier(mesh=mesh, **kw))
        p, nt = plain.init(0)
        toks = torch.from_numpy(np.arange(16).reshape(2, 8) % 30)
        feats = (toks, torch.ones(2, 8))
        np.testing.assert_allclose(
            sharded.apply(p, nt, feats, False)[0].detach().numpy(),
            plain.apply(p, nt, feats, False)[0].detach().numpy(), atol=1e-6)
        with pytest.raises(ValueError, match="experts"):
            expert.moe_mlp({**params, "gate": params["gate"][:, :3]}, x,
                           _TwoRanks(), top_k=2)


class _TwoRanks:
    """A two-rank ep axis as ``moe_mlp`` reads it (size only: the check
    fires before any collective)."""

    def size(self, axis):
        return 2

    def group(self, axis):
        return None


def test_moe_trains_through_adag():
    rng = np.random.default_rng(0)
    n, L = 96, CFG["maxlen"]
    y = rng.integers(0, 2, n).astype(np.int32)
    toks = rng.integers(2, CFG["vocab"], (n, L)).astype(np.int32)
    toks[:, 0] = y
    ds = Dataset({"features": toks, "mask": np.ones((n, L), np.float32),
                  "label": y})
    t = trainers.ADAG(moe_transformer_classifier(dtype=torch.float32, **CFG),
                      loss="sparse_softmax_cross_entropy",
                      worker_optimizer="adam", learning_rate=3e-3,
                      num_workers=2, batch_size=8, communication_window=2,
                      num_epoch=2, features_col=["features", "mask"],
                      device="cpu")
    t.train(ds)
    losses = [r["loss"] for r in t.get_history() if "loss" in r]
    assert losses and np.all(np.isfinite(losses))
