"""``remat=True`` in the port (models/layers.py::remat_block, used by
models/transformer.py and models/lm.py) under the engine's
``torch.func.vmap(torch.func.grad_and_value(loss_step))`` at W = 2, on
the flash path's plain version (``attn_impl="plain"``: the flash
Function, with its own ``vmap`` rule, over the plain versions of K2–K4).

Remat on against off on the same params and batch: the same loss and
gradients (the recompute repeats the forward's arithmetic; tolerance
loss rtol 1e-6, gradients rtol 1e-5 / atol 1e-7), the same parameter
names, the attention forward run twice a block a step and its backward
once; and the rematted classifier against the JAX package's
``nn.remat`` one (logits rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import transformer_classifier as jclassifier
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.convert import params_to_jax, tensors_from_jax
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import (
    transformer_classifier,
    transformer_lm,
    transformer_lm_spec,
)
from distkeras_tpu_torch.models import lm as lm_mod
from distkeras_tpu_torch.ops import flash_attention as fa
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.trainers import _make_loss_step

LOSS = "sparse_softmax_cross_entropy"
SAME = dict(loss=dict(rtol=1e-6, atol=0), grads=dict(rtol=1e-5, atol=1e-7))
W = 2
CLS = dict(vocab=30, maxlen=10, dim=16, heads=2, depth=2)
LM = dict(vocab=48, maxlen=16, dim=16, heads=4, depth=2, kv_heads=2,
          pos_embedding="rope", ce_chunk=12)


def _cls_batch(seed=0, B=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CLS["vocab"], (W, B, CLS["maxlen"]))
    mask = np.ones(toks.shape, np.float32)
    mask[0, 1, 6:] = 0.0
    y = rng.integers(0, 2, (W, B))
    return (torch.from_numpy(toks), torch.from_numpy(mask),
            torch.from_numpy(y))


def _lm_batch(seed=0, B=2, L=13):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, LM["vocab"], (W, B, L + 1)))
    return toks[..., :-1], toks[..., 1:]


def _stacked(spec):
    """Each worker its own params: the seed-0 init plus a per-worker
    perturbation."""
    params, nt = spec.init(0)
    gen = torch.Generator().manual_seed(1)
    stack = lambda v: torch.stack([v + 0.01 * i * torch.randn(  # noqa: E731
        v.shape, generator=gen) for i in range(W)])
    return ({k: stack(v) for k, v in params.items()},
            {k: v[None].expand(W, *v.shape).clone() for k, v in nt.items()})


def _engine_grads(spec, n_feat, batch):
    """The engine's step: vmap over W of grad_and_value(loss_step)."""
    step = _make_loss_step(spec, get_loss(LOSS), n_feat, LOSS)
    params, nt = _stacked(spec)
    fn = torch.func.vmap(torch.func.grad_and_value(step, has_aux=True),
                         randomness="different")
    grads, (loss, _) = fn(params, nt, batch)
    return grads, loss


def _assert_same(a, b):
    (ga, la), (gb, lb) = a, b
    torch.testing.assert_close(la, lb, **SAME["loss"])
    assert ga.keys() == gb.keys()
    for k in ga:
        torch.testing.assert_close(ga[k], gb[k], **SAME["grads"], msg=k)


class _Counted:
    """Counts the plain flash forward and backward (the CPU stand-ins of
    K2 and of K3 + K4) while it is entered."""

    def __init__(self, monkeypatch):
        self.fwd = self.bwd = 0
        fwd, bwd = fa._fa_forward_plain, fa._fa_bwd_plain

        def count_fwd(*a, **k):
            self.fwd += 1
            return fwd(*a, **k)

        def count_bwd(*a, **k):
            self.bwd += 1
            return bwd(*a, **k)

        monkeypatch.setattr(fa, "_fa_forward_plain", count_fwd)
        monkeypatch.setattr(fa, "_fa_bwd_plain", count_bwd)


def test_classifier_remat_equals_no_remat_under_the_engine(monkeypatch):
    specs = [transformer_classifier(dtype=torch.float32, attn_impl="plain",
                                    remat=r, **CLS) for r in (False, True)]
    names = [[n for n, _ in s.module.named_parameters()] for s in specs]
    assert names[0] == names[1] and "blocks.1.qkv.weight" in names[0]
    counts = []
    out = []
    for spec in specs:
        c = _Counted(monkeypatch)
        out.append(_engine_grads(spec, 2, _cls_batch()))
        counts.append((c.fwd, c.bwd))
    _assert_same(*out)
    # one launch a block for all W workers (the vmap rule folds them);
    # the rematted run repeats the forward in the backward pass
    depth = CLS["depth"]
    assert counts[0] == (depth, depth)
    assert counts[1] == (2 * depth, depth)


@pytest.mark.parametrize("fused_ce", [False, True])
def test_lm_spec_remat_equals_no_remat_under_the_engine(fused_ce,
                                                        monkeypatch):
    specs = [transformer_lm_spec(dtype=torch.float32, attn_impl="plain",
                                 fused_ce=fused_ce, remat=r, **LM)
             for r in (False, True)]
    assert [n for n, _ in specs[0].module.named_parameters()] == \
        [n for n, _ in specs[1].module.named_parameters()]
    counts, out = [], []
    for spec in specs:
        c = _Counted(monkeypatch)
        out.append(_engine_grads(spec, 1, _lm_batch()))
        counts.append((c.fwd, c.bwd))
    _assert_same(*out)
    assert counts[1] == (2 * counts[0][0], counts[0][1])


def test_lm_serving_methods_run_the_blocks_unrematted(monkeypatch):
    """flax's ``nn.remat`` transforms ``__call__`` only: prefill, decode and
    extend never go through the remat Function; the full forward does."""
    calls = []
    real = lm_mod.remat_block

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(lm_mod, "remat_block", counted)
    cfg = {k: v for k, v in LM.items() if k != "ce_chunk"}
    model = lm_mod.TransformerLM(dtype=torch.float32, device="cpu",
                                 remat=True, **cfg)
    ref = transformer_lm(dtype=torch.float32, device="cpu", seed=0, **cfg)
    model.load_state_dict(ref.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, LM["vocab"], (2, 6)))
    with torch.no_grad():
        logits, caches = model.prefill(toks)
        model.decode_step(toks[:, 0], caches, 6)
        model.extend(toks[:, :2], caches, 7)
        assert calls == []
        full = model(toks)
    assert len(calls) == LM["depth"]
    torch.testing.assert_close(full, ref(toks), rtol=0, atol=0)
    torch.testing.assert_close(logits[:, -1], full[:, -1], rtol=1e-5,
                               atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_pair():
    jspec = jclassifier(dtype=jnp.float32, remat=True, **CLS)
    p, _ = jax.tree_util.tree_map(
        np.asarray, jax.jit(jspec.init)(jax.random.PRNGKey(0)))
    return jspec, p


def test_rematted_classifier_matches_jax_remat():
    jspec, p = _jax_pair()
    tspec = transformer_classifier(dtype=torch.float32, attn_impl="plain",
                                   remat=True, **CLS)
    toks, mask, y = (t[0].numpy() for t in _cls_batch())
    toks = toks.astype(np.int32)

    def jf(pp):
        out, _ = jspec.apply(pp, {}, (toks, mask), True)
        return -jnp.mean(jax.nn.log_softmax(out)[np.arange(3), y]), out

    def tf(pp):
        out, _ = tspec.apply(pp, {}, (torch.from_numpy(toks),
                                      torch.from_numpy(mask)), True)
        logp = torch.log_softmax(out, -1)
        return -torch.mean(logp[torch.arange(3), torch.from_numpy(y)]), out

    jg, jout = jax.jit(jax.grad(jf, has_aux=True))(p)
    tg, tout = torch.func.grad(tf, has_aux=True)(
        tensors_from_jax(p, tspec.module))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    ref = jax.tree_util.tree_leaves_with_path(jg)
    got = jax.tree_util.tree_leaves_with_path(params_to_jax(tg, tspec.module))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, r), (_, g) in zip(ref, got):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(k))


def test_rematted_classifier_trains_through_adag():
    rng = np.random.default_rng(0)
    n, L = 64, CLS["maxlen"]
    y = rng.integers(0, 2, n).astype(np.int32)
    toks = rng.integers(2, CLS["vocab"], (n, L)).astype(np.int32)
    toks[:, 0] = y
    ds = Dataset({"features": toks, "mask": np.ones((n, L), np.float32),
                  "label": y})
    kw = dict(loss=LOSS, worker_optimizer="adam", learning_rate=3e-3,
              num_workers=2, batch_size=8, communication_window=2,
              num_epoch=1, features_col=["features", "mask"], device="cpu")
    centers = [trainers.ADAG(transformer_classifier(
        dtype=torch.float32, attn_impl="plain", remat=r, **CLS), **kw)
        .train(ds) for r in (False, True)]
    for k in centers[0]:
        torch.testing.assert_close(centers[1][k], centers[0][k], rtol=1e-5,
                                   atol=1e-6, msg=k)



_PEAK_SCRIPT = """
import sys
import torch
from torch import nn
from distkeras_tpu_torch.models.layers import remat_block

torch.set_num_threads(2)
D, W, N, DEPTH = 384, 2, 2048, 6


class Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.a, self.b = nn.Linear(D, 4 * D), nn.Linear(4 * D, D)

    def forward(self, x):
        return x + self.b(torch.tanh(self.a(x)) * 2.0)


class Stack(nn.Module):
    def __init__(self, remat):
        super().__init__()
        self.remat = remat
        self.blocks = nn.ModuleList([Block() for _ in range(DEPTH)])

    def forward(self, x):
        for b in self.blocks:
            x = remat_block(b, x) if self.remat else b(x)
        return (x ** 2).mean()


def step(remat, rows):
    m = Stack(remat)
    p = {k: v.detach()[None].expand(W, *v.shape).clone()
         for k, v in m.named_parameters()}
    loss = lambda p, x: torch.func.functional_call(m, p, (x,))
    torch.func.vmap(torch.func.grad_and_value(loss))(
        p, torch.randn(W, rows, D))


def status_kb(key):
    for line in open("/proc/self/status"):
        if line.startswith(key + ":"):
            return int(line.split()[1])


for remat in (True, False):      # warm both paths up at a small size
    step(remat, 16)
for remat in (True, False):
    # reset the peak resident size to the current one: each delta is
    # this step's own, whatever the imports or the other step touched
    with open("/proc/self/clear_refs", "w") as f:
        f.write("5")
    base = status_kb("VmRSS")
    step(remat, N)
    print((status_kb("VmHWM") - base) / 1024)
"""


def test_remat_lowers_the_peak_under_the_engines_transforms():
    """The point of remat, under ``vmap(grad_and_value)``: the process's
    peak resident memory over the step (a fresh process, the peak reset
    before each step through ``/proc/self/clear_refs``, depth 6 of [W·N,
    4·384] f32 activations) under half the un-rematted one's.
    ``torch.func.grad`` differentiates with ``create_graph=True``; a
    recompute recorded for a second derivative keeps every block alive
    and the two peaks come out equal."""
    import os
    import subprocess
    import sys

    # a fixed mmap threshold: glibc otherwise raises it after a free and
    # keeps later blocks of that size in its heap, which the peak counts
    env = dict(os.environ, MALLOC_MMAP_THRESHOLD_="65536",
               PYTHONPATH=os.pathsep.join([os.getcwd()] + sys.path))
    out = subprocess.run([sys.executable, "-c", _PEAK_SCRIPT],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    remat, plain = (float(v) for v in out.stdout.split())
    assert remat < 0.5 * plain, (remat, plain)
