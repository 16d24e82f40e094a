"""The port's encoder classifier (distkeras_tpu_torch/models/
transformer.py) held against the JAX package's ``transformer_classifier``
with the same initial weights (``convert.tensors_from_jax``), on tokens
whose key mask is ragged (one row fully masked).

f32 on both sides; the JAX side runs its reference attention, the port
the flash Function over the plain versions of K2–K4 (non-causal with a
key mask: the path config 6 drives through the kernels on the card) and
its own reference. Logits and loss 1e-5, gradients 1e-6 absolute
(measured ≤ 2e-7). One DOWNPOUR window (W = 2, window 2, SGD lr 0.1):
centers and workers within 1e-6 absolute, as for the other models in
tests/test_torch_trainers.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.models import transformer_classifier as jax_classifier
from distkeras_tpu.models.transformer import sincos_positions as jsincos
from distkeras_tpu.ops.losses import sparse_softmax_cross_entropy as jax_ce
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.parallel.local_sgd import LocalSGDEngine as JaxEngine
from distkeras_tpu.parallel.mesh import get_mesh
from distkeras_tpu_torch import optim, trainers
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.models import transformer_classifier
from distkeras_tpu_torch.models import transformer as ttr
from distkeras_tpu_torch.ops.losses import (
    sparse_softmax_cross_entropy as torch_ce,
)
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine

CFG = dict(vocab=50, maxlen=40, dim=32, heads=4, depth=2, num_classes=3)
LENGTHS = (40, 23, 7, 0)     # the last row has no valid key at all


def _batch(seed=0, rows=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], (rows, CFG["maxlen"])).astype(
        np.int32)
    mask = np.zeros(toks.shape, np.float32)
    for i in range(rows):
        mask[i, :LENGTHS[i % len(LENGTHS)]] = 1.0
    labels = (toks[:, 0] % CFG["num_classes"]).astype(np.int32)
    return toks, mask, labels


def _pair(attn_impl="flash", **over):
    cfg = {**CFG, **over}
    jspec = jax_classifier(dtype=jnp.float32, attn_impl="reference", **cfg)
    tspec = transformer_classifier(dtype=torch.float32, attn_impl=attn_impl,
                                   **cfg)
    p, nt = jspec.init_np(0)
    return jspec, tspec, p, nt, tensors_from_jax(p, tspec.module)


@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_gradients_match_jax(attn_impl, causal):
    jspec, tspec, p, nt, tp = _pair(attn_impl, causal=causal)
    toks, mask, labels = _batch()
    jx = (jnp.asarray(toks), jnp.asarray(mask))
    tx = (torch.from_numpy(toks), torch.from_numpy(mask))

    def jloss(pp):
        out, _ = jspec.apply(pp, nt, jx, True)
        return jax_ce(jnp.asarray(labels), out), out

    def tloss(pp):
        out, _ = tspec.apply(pp, {}, tx, True)
        return torch_ce(torch.from_numpy(labels), out), out

    (jv, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, p))
    tg, (tv, tout) = torch.func.grad_and_value(tloss, has_aux=True)(tp)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    tgj = params_to_jax(tg, tspec.module)
    assert jax.tree.structure(tgj) == jax.tree.structure(jg)
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tgj)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


def test_downpour_window_matches_jax_engine():
    W, WIN, B = 2, 2, 4
    jspec, tspec, p, nt, tp = _pair("flash")
    toks, mask, labels = _batch(seed=1, rows=W * WIN * B)
    shape = (W, WIN, B)
    batch = (toks.reshape(*shape, -1), mask.reshape(*shape, -1),
             labels.reshape(shape))

    def jax_step(params, nt_, b):
        out, n = jspec.apply(params, nt_, (b[0], b[1]), training=True)
        return jax_ce(b[2], out), n

    def torch_step(params, nt_, b):
        out, n = tspec.apply(params, nt_, (b[0], b[1]), training=True)
        return torch_ce(b[2], out), n

    je = JaxEngine(jspec, jax_step, optax.sgd(0.1), jr.DownpourMerge(),
                   get_mesh(W), num_workers=W, window=WIN)
    jstate, jloss = je.run_window(je.init_state(p, nt), batch)
    te = LocalSGDEngine(tspec, torch_step, optim.sgd(0.1),
                        tr.DownpourMerge(), device="cpu", num_workers=W,
                        window=WIN)
    tstate, tloss = te.run_window(te.init_state(tp, {}), batch)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    center = params_to_jax(te.center_params(tstate), tspec.module)
    for a, b in zip(jax.tree.leaves(jstate.center), jax.tree.leaves(center)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)
    jw = jax.device_get(jstate.workers)
    for i in range(W):
        wi = params_to_jax({k: v[i] for k, v in tstate.workers.items()},
                           tspec.module)
        for a, b in zip(jax.tree.leaves(jw), jax.tree.leaves(wi)):
            np.testing.assert_allclose(b, np.asarray(a)[i], rtol=0,
                                       atol=1e-6)


def test_downpour_trainer_trains_on_cpu():
    """The trainer route with (tokens, mask) columns: the loss falls on
    labels that depend on the tokens."""
    from distkeras_tpu_torch.data import Dataset

    toks, mask, labels = _batch(seed=2, rows=64)
    ds = Dataset({"features": toks, "mask": mask, "label": labels})
    t = trainers.DOWNPOUR(transformer_classifier(dtype=torch.float32,
                                                 attn_impl="flash", **CFG),
                          loss="sparse_softmax_cross_entropy",
                          worker_optimizer="adam", learning_rate=3e-3,
                          features_col=["features", "mask"], num_workers=2,
                          batch_size=8, communication_window=2, num_epoch=4,
                          device="cpu")
    t.train(ds)
    losses = t.history.losses()
    assert np.all(np.isfinite(losses)) and len(losses) == 8
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


def test_params_round_trip_positions_and_later_options():
    _, tspec, p, _, tp = _pair()
    back = params_to_jax(tp, tspec.module)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))   # exact
    np.testing.assert_array_equal(ttr.sincos_positions(16, 8),
                                  jsincos(16, 8))
    params, state = transformer_classifier(**CFG).init(0)
    assert all(v.dtype == torch.float32 for v in params.values())
    assert set(state) == {"pos_table"}
    with pytest.raises(NotImplementedError, match="A12"):
        transformer_classifier(attn_impl="ring")
    with pytest.raises(NotImplementedError, match="A10"):
        transformer_classifier(remat=True)
    with pytest.raises(NotImplementedError, match="A12"):
        ttr.pipelined_transformer_forward(None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="A12"):
        ttr.sequence_parallel_transformer_forward(None, None, None, None)
    with pytest.raises(ValueError, match="attn_impl"):
        transformer_classifier(attn_impl="xla")
