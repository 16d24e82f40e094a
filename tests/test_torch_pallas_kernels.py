"""The port's fused Adam (distkeras_tpu_torch/ops/pallas_kernels.py) and
functional optimizers (distkeras_tpu_torch/optim.py) held against the JAX
package's fused Adam in Pallas interpret mode and against optax, on the
same numpy inputs.

On the CPU ``fused_adam`` runs the kernel's plain version; the CUDA kernel
(K5) is held against it on the card by ``chip_smoke.py``. The port applies
every optimizer to worker-stacked ``[W, …]`` trees, so the oracle is
``jax.vmap`` of the optax update. Tolerances: both sides do the same f32
operations (the port multiplies by 1/(1-b^t) as the TPU kernel does,
optax divides by 1-b^t), so updates agree to 1e-5 relative / 1e-7
absolute at lr 1e-2, the bound tests/test_pallas_kernels.py holds the TPU
kernel to against optax.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.ops.pallas_kernels import fused_adam as jax_fused_adam
from distkeras_tpu_torch import optim
from distkeras_tpu_torch.ops import pallas_kernels as tk
from distkeras_tpu_torch.trainers import resolve_optimizer

W = 3


def random_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "conv": rng.normal(size=(W, 3, 3, 4, 8)).astype(np.float32),
        "bias": rng.normal(size=(W, 8)).astype(np.float32),
        "dense": rng.normal(size=(W, 200, 33)).astype(np.float32),
    }


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def assert_tree_close(got, ref, **tol):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **tol)


@pytest.mark.parametrize("oracle", ["pallas", "optax"])
def test_fused_adam_matches_jax_over_five_steps(oracle):
    lr = 1e-2
    jtx = jax_fused_adam(lr, interpret=True) if oracle == "pallas" \
        else optax.adam(lr)
    ttx = tk.fused_adam(lr)
    params = random_tree(0)
    js = jax.vmap(jtx.init)(params)
    ts = ttx.init(to_torch(params))
    jp, tp = dict(params), to_torch(params)
    for step in range(5):
        grads = random_tree(step + 10)
        ju, js = jax.vmap(jtx.update)(grads, js)
        tu, ts = ttx.update(to_torch(grads), ts)
        assert_tree_close(tu, ju, rtol=1e-5, atol=1e-7)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
    assert_tree_close(tp, jp, rtol=1e-5, atol=1e-6)
    assert ts["count"] == 5
    assert float(ts["mu"]["dense"].abs().sum()) > 0


def test_fused_adam_plain_repeats_kernel_arithmetic():
    """``impl="plain"`` is the function the CPU path runs; the step
    counter drives the bias correction exactly as the TPU kernel's caller
    computes it (f32 power of the f32 count)."""
    g = torch.linspace(-1, 1, 37)
    m = torch.zeros(37)
    v = torch.zeros(37)
    out_k = tk.fused_adam_step([g], [m], [v], 3, 1e-3)
    out_p = tk.fused_adam_step([g], [m], [v], 3, 1e-3, impl="plain")
    for a, b in zip(out_k, out_p):
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    k = tk._coefficients(3, 1e-3, 0.9, 0.999, 1e-8)
    assert k["bc1"] == np.float32(1) / (np.float32(1) - np.float32(0.9) ** 3)
    with pytest.raises(ValueError, match="impl"):
        tk.fused_adam_step([g], [m], [v], 1, 1e-3, impl="warp")
    before = tk.fused_adam_step.launches
    tk.fused_adam(1e-3).update({"g": g}, tk.fused_adam(1e-3).init({"g": g}))
    assert tk.fused_adam_step.launches == before   # the CPU runs no kernel


def test_fused_adam_bf16_gradients_give_bf16_updates():
    g = torch.linspace(-1, 1, 9).to(torch.bfloat16)
    u, st = tk.fused_adam(1e-2).update({"g": g}, tk.fused_adam(1e-2).init(
        {"g": g}))
    assert u["g"].dtype == torch.bfloat16
    assert st["mu"]["g"].dtype == torch.float32


OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
    "momentum": (lambda: optax.sgd(0.1, momentum=0.9, nesterov=True),
                 lambda: optim.sgd(0.1, momentum=0.9, nesterov=True)),
    "adam": (lambda: optax.adam(1e-2), lambda: optim.adam(1e-2)),
    "adagrad": (lambda: optax.adagrad(1e-2), lambda: optim.adagrad(1e-2)),
    "rmsprop": (lambda: optax.rmsprop(1e-2), lambda: optim.rmsprop(1e-2)),
    "adadelta": (lambda: optax.adadelta(1e-2), lambda: optim.adadelta(1e-2)),
    "adamw": (lambda: optax.adamw(1e-2), lambda: optim.adamw(1e-2)),
    "adamax": (lambda: optax.adamax(1e-2), lambda: optim.adamax(1e-2)),
    "nadam": (lambda: optax.nadam(1e-2), lambda: optim.nadam(1e-2)),
    "clipnorm": (
        lambda: optax.chain(optax.clip_by_global_norm(5.0), optax.sgd(0.1)),
        lambda: resolve_optimizer("sgd", 0.1, clipnorm=5.0)),
    "clipvalue": (lambda: optax.chain(optax.clip(0.5), optax.adam(1e-2)),
                  lambda: resolve_optimizer("adam", 1e-2, clipvalue=0.5)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_optax_per_worker(name):
    """Three steps of each optimizer on a stacked tree equal ``jax.vmap``
    of optax's update (optax defaults, not torch's; clipnorm one global
    norm per worker). The same f32 formulas in both: 1e-5 / 1e-6."""
    jmake, tmake = OPTIMIZERS[name]
    jtx, ttx = jmake(), tmake()
    params = random_tree(1)
    js = jax.vmap(jtx.init)(params)
    tp = to_torch(params)
    ts = ttx.init(tp)
    jp = dict(params)
    for step in range(3):
        grads = random_tree(step + 20)
        ju, js = jax.vmap(jtx.update)(grads, js, jp)
        tu, ts = ttx.update(to_torch(grads), ts, tp)
        assert_tree_close(tu, ju, rtol=1e-5, atol=1e-6)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}


def test_clipnorm_is_per_worker():
    """One worker's large gradient is clipped without touching the
    others'."""
    g = {"w": torch.stack([torch.full((4,), 10.0), torch.full((4,), 0.1)])}
    tx = optim.clip_by_global_norm(1.0)
    out, _ = tx.update(g, tx.init(g))
    np.testing.assert_allclose(out["w"][0].norm().item(), 1.0, rtol=1e-6)
    torch.testing.assert_close(out["w"][1], g["w"][1])


def test_resolve_optimizer_names():
    for name in ("sgd", "adam", "fused_adam", "adagrad", "rmsprop",
                 "adadelta", "adamw", "adamax", "nadam"):
        assert isinstance(resolve_optimizer(name, 0.1),
                          optim.GradientTransformation)
    with pytest.raises(ValueError, match="worker_optimizer"):
        resolve_optimizer("lbfgs", 0.1)
