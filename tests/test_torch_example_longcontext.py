"""The port's long-context example
(``python -m distkeras_tpu_torch.examples.longcontext``, the twin of
``examples/longcontext.py``) against the JAX example at its quick size,
in f32 on the CPU:

- the flash+remat leg's step (``remat=True`` classifier, L=512): from the
  same params and batch, the twin's loss equals the JAX example's
  ``train_step_fn`` loss within 1e-5 relative and its gradients equal
  ``jax.grad`` of the same loss within 1e-4 of each leaf's largest
  gradient; after one Adam step both sides' weights moved by at most
  ``2.02 · lr`` and agree within it (Adam moves an element ~lr whatever
  its gradient's size, and the qkv bias's k part has an exactly zero
  gradient, so noise there is a whole step);
- the sequence-parallel leg: the loss and gradient norm² of
  ``sequence_parallel_transformer_forward`` over a port mesh of one rank
  against the JAX package's over the 8 CPU devices, within 1e-5 relative;
- the twin end to end (``--quick --device cpu``).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import transformer_classifier as jclassifier
from distkeras_tpu.models.transformer import TransformerClassifier as JTC
from distkeras_tpu.models.transformer import (
    sequence_parallel_transformer_forward as jsp_forward,
)
from distkeras_tpu.ops.losses import sparse_softmax_cross_entropy as jsce
from distkeras_tpu.parallel.mesh import get_mesh as jget_mesh
from distkeras_tpu_torch.convert import tensors_from_jax
from distkeras_tpu_torch.examples import longcontext as twin
from distkeras_tpu_torch.models.transformer import TransformerClassifier
from distkeras_tpu_torch.parallel.mesh import get_mesh

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3


@pytest.fixture(scope="module")
def jax_example():
    """``examples/longcontext.py`` as a module; its import-time
    ``KERAS_BACKEND`` default is set and then restored."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KERAS_BACKEND", "jax")
        spec = importlib.util.spec_from_file_location(
            "jax_longcontext_example", REPO / "examples" / "longcontext.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().cpu().numpy()


def test_flash_remat_step_matches_the_jax_example(jax_example):
    pspec, dims, L, B, impl, _, _, batch = twin.flash_remat_setup(
        True, torch.device("cpu"))
    assert (L, B, impl) == (512, 2, "reference")
    toks, mask, y = (_np(t) for t in batch)
    jspec = jclassifier(vocab=1000, maxlen=L, num_classes=4,
                        attn_impl="reference", dtype=jnp.float32,
                        remat=True, **dims)
    jparams, jnt = jspec.init_np(0)

    def jloss(p):
        out, _ = jspec.apply(p, jnt, (toks, mask), training=True)
        return jsce(y, out)

    jgrads = jax.grad(jloss)(jparams)
    params0 = {k: v.clone() for k, v in tensors_from_jax(
        jparams, pspec.module).items()}
    tx, jstep = jax_example.train_step_fn(jspec)
    jnew, _, _, jl = jstep(jax.tree.map(jnp.array, jparams),
                           tx.init(jparams), jnt, toks, mask, y)

    loss, grads, _ = twin.loss_and_grads(pspec, params0, {}, *batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = tensors_from_jax(jgrads, pspec.module)
    assert set(grads) == set(want)
    for k, g in grads.items():
        w = want[k].numpy()
        tol = 1e-4 * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=tol, err_msg=k)

    params = {k: v.clone() for k, v in params0.items()}
    make_opt, step = twin.train_step_fn(pspec, lr=LR)
    params, _, _, sl = step(params, make_opt(params), {}, *batch)
    assert float(sl) == float(loss)
    jnew = tensors_from_jax(jax.device_get(jnew), pspec.module)
    for k, v in params.items():
        moved = np.abs(_np(v) - _np(params0[k])).max()
        assert moved <= 2.02 * LR, (k, moved)
        np.testing.assert_allclose(_np(v), jnew[k].numpy(), rtol=0,
                                   atol=2.02 * LR, err_msg=k)


def test_sequence_parallel_leg_matches_the_jax_package():
    n = len(jax.devices())
    L = 16 * n
    kw = dict(vocab=1000, maxlen=L, dim=64, heads=4, depth=2, num_classes=4)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1000, size=(2, L)).astype(np.int32)
    mask = np.ones((2, L), np.float32)
    jmod = JTC(dtype=jnp.float32, **kw)
    jparams = jmod.init(jax.random.PRNGKey(0), toks, mask,
                        training=False)["params"]

    def jloss(p):
        return jnp.mean(jsp_forward(jmod, p, toks, mask,
                                    jget_mesh(n, axis="sp")) ** 2)

    jval, jgrads = jax.value_and_grad(jloss)(jparams)
    jgn = sum(float(np.sum(np.asarray(g, np.float64) ** 2))
              for g in jax.tree.leaves(jgrads))

    module = TransformerClassifier(dtype=torch.float32, **kw)
    params = tensors_from_jax(jparams, module)
    with get_mesh(1, device="cpu", axis="sp") as mesh:
        val, gn = twin.sp_loss_and_grad_norm(
            module, params, torch.from_numpy(toks.astype(np.int64)),
            torch.from_numpy(mask), mesh)
    np.testing.assert_allclose(val, float(jval), rtol=1e-5)
    np.testing.assert_allclose(gn, jgn, rtol=1e-5)


def test_twin_runs_quick():
    out = twin.main(["--quick", "--device", "cpu"])
    assert out["flash_remat"]["L"] == 512
    assert np.isfinite(out["flash_remat"]["loss"])
    assert out["sp"]["ranks"] == 1 and np.isfinite(out["sp"]["grad_norm2"])
