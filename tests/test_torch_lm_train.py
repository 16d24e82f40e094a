"""The port's LM training form (distkeras_tpu_torch/models/lm.py::
transformer_lm_spec, the fused loss seam in model.py/trainers.py, and
data.next_token_dataset) held against the JAX package's
``transformer_lm`` spec, with the same initial weights carried over by
``convert.tensors_from_jax``.

f32 on both sides. The JAX LM with ``attn_impl="flash"`` runs its
reference attention off the TPU; the port's runs the flash Function over
the plain versions of K2–K4, so the gradients also check the flash
backward inside a model. Loss 1e-6 relative and gradients 1e-6 absolute
(measured ≤ 2e-7). One ADAG window (W = 2, window 2, fused Adam at lr
1e-3): centers within 1e-5 absolute — see tests/test_torch_trainers.py for
why Adam keeps that margin (measured ≤ 2e-7 here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import transformer_lm as jax_lm_spec
from distkeras_tpu.models.lm import next_token_dataset as jnext_tokens
from distkeras_tpu.ops.losses import get_loss as jget_loss
from distkeras_tpu.ops.pallas_kernels import fused_adam as jfused_adam
from distkeras_tpu.parallel import merge_rules as jr
from distkeras_tpu.parallel.local_sgd import LocalSGDEngine as JaxEngine
from distkeras_tpu.parallel.mesh import get_mesh
from distkeras_tpu.trainers import _make_loss_step as jloss_step
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import next_token_dataset
from distkeras_tpu_torch.models import transformer_lm, transformer_lm_spec
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine

LOSS = "sparse_softmax_cross_entropy"
VOCAB = 64
CFG = dict(vocab=VOCAB, maxlen=32, dim=32, heads=4, depth=2,
           pos_embedding="rope", kv_heads=2, ce_chunk=20)


def _pair(**over):
    cfg = {**CFG, **over}
    jspec = jax_lm_spec(dtype=jnp.float32, attn_impl="flash", **cfg)
    tspec = transformer_lm_spec(dtype=torch.float32, attn_impl="flash",
                                **cfg)
    p, nt = jspec.init_np(0)
    return jspec, tspec, p, nt, tensors_from_jax(p, tspec.module)


def _tokens(rows, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (rows, 17)).astype(np.int32)


@pytest.mark.parametrize("fused_ce", [False, True])
@pytest.mark.parametrize("tie_embeddings", [False, True])
def test_loss_and_gradients_match_jax_spec(fused_ce, tie_embeddings):
    jspec, tspec, p, nt, tp = _pair(fused_ce=fused_ce,
                                    tie_embeddings=tie_embeddings)
    assert (tspec.fused_losses is not None) == fused_ce
    toks = _tokens(3)
    x, y = toks[:, :-1], toks[:, 1:]
    jstep = jloss_step(jspec, jget_loss(LOSS), 1, LOSS)
    tstep = trainers._make_loss_step(tspec, get_loss(LOSS), 1, LOSS)
    jv, jg = jax.value_and_grad(
        lambda pp: jstep(pp, nt, (jnp.asarray(x), jnp.asarray(y)))[0])(
        jax.tree.map(jnp.asarray, p))
    tg, (tv, _) = torch.func.grad_and_value(tstep, has_aux=True)(
        tp, {}, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    tgj = params_to_jax(tg, tspec.module)
    assert jax.tree.structure(tgj) == jax.tree.structure(jg)
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tgj)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


def test_fused_loss_takes_a_row_mask():
    """The fused loss's ``mask`` (per-row [B] or per-token [B, L]) against
    the JAX spec's."""
    jspec, tspec, p, nt, tp = _pair(fused_ce=True)
    toks = _tokens(4, seed=1)
    x, y = toks[:, :-1], toks[:, 1:]
    jf = jspec.fused_losses[LOSS]
    tf = tspec.fused_losses[LOSS]
    for mask in (np.array([1, 0, 1, 1], np.float32),
                 (np.arange(64).reshape(4, 16) % 3 > 0).astype(np.float32)):
        jv, _ = jf(jax.tree.map(jnp.asarray, p), nt, jnp.asarray(x),
                   jnp.asarray(y), training=False, mask=jnp.asarray(mask))
        tv, _ = tf(tp, {}, torch.from_numpy(x), torch.from_numpy(y),
                   training=False, mask=torch.from_numpy(mask))
        np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)


def test_adag_window_with_fused_adam_matches_jax_engine():
    W, WIN, B = 2, 2, 3
    jspec, tspec, p, nt, tp = _pair(fused_ce=True)
    toks = _tokens(W * WIN * B, seed=2).reshape(W, WIN, B, 17)
    x, y = toks[..., :-1], toks[..., 1:]
    je = JaxEngine(jspec, jloss_step(jspec, jget_loss(LOSS), 1, LOSS),
                   jfused_adam(1e-3), jr.ADAGMerge(), get_mesh(W),
                   num_workers=W, window=WIN)
    jstate, jloss = je.run_window(je.init_state(p, nt), (x, y))
    te = LocalSGDEngine(
        tspec, trainers._make_loss_step(tspec, get_loss(LOSS), 1, LOSS),
        fused_adam(1e-3), tr.ADAGMerge(), device="cpu", num_workers=W,
        window=WIN)
    tstate, tloss = te.run_window(te.init_state(tp, {}), (x, y))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    center = params_to_jax(te.center_params(tstate), tspec.module)
    for a, b in zip(jax.tree.leaves(jstate.center), jax.tree.leaves(center)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


def test_adag_trainer_trains_the_lm_spec_on_cpu():
    """The trainer route end to end (fused loss by name, f32 params, the
    flash Function under vmap(grad)): a learnable stream's loss falls."""
    rng = np.random.default_rng(3)
    start = rng.integers(0, VOCAB, (64, 1))
    toks = (start + 3 * np.arange(17)[None]) % VOCAB
    spec = transformer_lm_spec(dtype=torch.float32, attn_impl="flash",
                               fused_ce=True, **CFG)
    t = trainers.ADAG(spec, loss=LOSS, worker_optimizer="fused_adam",
                      learning_rate=3e-3, num_workers=2, batch_size=8,
                      communication_window=2, num_epoch=3, device="cpu")
    center = t.train(next_token_dataset(toks))
    losses = t.history.losses()
    assert np.all(np.isfinite(losses)) and len(losses) == 6
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    assert all(v.dtype == torch.float32 for v in center.values())


def test_spec_init_params_round_trip_and_dtypes():
    _, tspec, p, _, tp = _pair(fused_ce=True)
    back = params_to_jax(tp, tspec.module)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))   # exact
    params, state = transformer_lm_spec(**CFG).init(0)
    assert all(v.dtype == torch.float32 for v in params.values())
    assert set(state) == {"rope_table"}
    again, _ = transformer_lm_spec(**CFG).init(0)
    for k in params:
        torch.testing.assert_close(params[k], again[k], rtol=0, atol=0)
    # the served module keeps its weights in the model dtype
    served = transformer_lm(device="cpu", **{k: CFG[k] for k in (
        "vocab", "maxlen", "dim", "heads", "depth")})
    assert served.embed.weight.dtype == torch.bfloat16
    assert served.blocks[0].qkv.weight.dtype == torch.bfloat16


def test_next_token_dataset_matches_jax_and_remat_raises():
    toks = _tokens(5)
    ours, ref = next_token_dataset(toks), jnext_tokens(toks)
    for col in ("features", "label"):
        np.testing.assert_array_equal(ours[col], ref[col])
    with pytest.raises(NotImplementedError, match="A10"):
        transformer_lm_spec(remat=True)
    spec = dataclasses.replace(transformer_lm_spec(**CFG), fused_losses={})
    step = trainers._make_loss_step(spec, get_loss(LOSS), 1, LOSS)
    x = torch.from_numpy(toks[:, :-1])
    loss, _ = step(spec.init(0)[0], spec.init(0)[1],
                   (x, torch.from_numpy(toks[:, 1:])))
    assert torch.isfinite(loss)
