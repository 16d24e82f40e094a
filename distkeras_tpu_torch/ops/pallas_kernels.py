"""Fused Adam as one hand-written CUDA kernel per optimizer step.

Port of ``distkeras_tpu/ops/pallas_kernels.py``. The TPU kernel fused the
whole Adam step (both moment updates, bias correction and the update) into
one pass over HBM per leaf. On Hopper the step is a multi-tensor kernel
(``csrc/adam.cu``): one launch walks every leaf of the worker-stacked tree,
since the engine applies the optimizer to the stacked ``[W, …]`` tensors
outside the worker vmap and the op is elementwise. On a CPU tensor the
plain version below runs instead; it repeats the kernel's arithmetic
operation by operation.

Select it with ``worker_optimizer="fused_adam"`` on any trainer.
``fused_adam(..., impl="plain")`` runs the plain version on any device (the
on-card comparison in ``chip_smoke.py`` uses it).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from distkeras_tpu_torch.ops import _build
from distkeras_tpu_torch.optim import GradientTransformation
from distkeras_tpu_torch.utils import tree_leaves, tree_map

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _coefficients(count: int, lr, b1, b2, eps):
    """f32 scalars of one step: the moment weights, -lr, eps and the bias
    corrections ``[1/(1-b1^t), 1/(1-b2^t)]`` as the TPU kernel's caller
    computes them (f32 power of the f32 step count)."""
    t = np.float32(count)
    f = np.float32
    bc1 = f(1.0) / (f(1.0) - np.power(f(b1), t))
    bc2 = f(1.0) / (f(1.0) - np.power(f(b2), t))
    return dict(b1=f(b1), one_minus_b1=f(1.0 - b1), b2=f(b2),
                one_minus_b2=f(1.0 - b2), neg_lr=f(-lr), eps=f(eps),
                bc1=f(bc1), bc2=f(bc2))


def _adam_plain(g, m, v, k):
    """Plain version of one leaf: the kernel's operations in its order,
    each rounded to f32 (the CPU path, and the on-card comparison). The
    coefficients are f32 values held as Python floats, which PyTorch
    applies to f32 tensors in f32."""
    c = {n: float(x) for n, x in k.items()}
    g32 = g.to(torch.float32)
    m_new = c["b1"] * m + c["one_minus_b1"] * g32
    v_new = c["b2"] * v + (c["one_minus_b2"] * g32) * g32
    u = (c["neg_lr"] * (m_new * c["bc1"])) / (
        torch.sqrt(v_new * c["bc2"]) + c["eps"])
    return m_new, v_new, u.to(g.dtype)


def _bind(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dk_adam.argtypes = [vp, i, ctypes.c_longlong, f, f, f, f, f, f, f, f,
                            i, vp]
    lib.dk_adam.restype = i
    lib.dk_adam_chunk.argtypes = []
    lib.dk_adam_chunk.restype = i


def _adam_cuda(gs, ms, vs, k, out=None):
    """One launch of ``csrc/adam.cu`` over every leaf, into ``out``
    (``(new_m, new_v, us)`` lists, which may be ``ms``, ``vs`` and ``gs``
    themselves: the kernel reads an element's inputs before it writes its
    outputs) or into new tensors."""
    dev = gs[0].device
    for g, m, v in zip(gs, ms, vs):
        if g.dtype not in _DTYPE_CODE:
            raise TypeError(f"fused_adam kernel takes float32 or bfloat16 "
                            f"gradients, got {g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("fused_adam moments must be float32")
        if not (g.device == m.device == v.device == dev):
            raise ValueError("fused_adam leaves must lie on one CUDA device")
        if not (g.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("fused_adam leaves must be contiguous")
        if g.shape != m.shape or g.shape != v.shape:
            raise ValueError(f"gradient {tuple(g.shape)} and moments "
                             f"{tuple(m.shape)}/{tuple(v.shape)} differ")
    if out is None:
        out = ([torch.empty_like(m) for m in ms],
               [torch.empty_like(v) for v in vs],
               [torch.empty_like(g) for g in gs])
    new_m, new_v, us = out
    table = _adam_table(gs, ms, vs, new_m, new_v, us)
    if table is not None:
        _adam_launch(table, k)
    return new_m, new_v, us


def _adam_table(gs, ms, vs, new_m, new_v, us):
    """The kernel's device-side leaf table (see ``csrc/adam.cu``), or None
    when every leaf is empty: ``(table, n_leaves, total_chunks)``."""
    lib = _build.load("adam", _bind)
    chunk = lib.dk_adam_chunk()
    rows, first = [], 0
    for g, m, v, mo, vo, u in zip(gs, ms, vs, new_m, new_v, us):
        n = g.numel()
        if n == 0:
            continue
        rows.append([g.data_ptr(), m.data_ptr(), v.data_ptr(), mo.data_ptr(),
                     vo.data_ptr(), u.data_ptr(), n, first,
                     _DTYPE_CODE[g.dtype]])
        first += -(-n // chunk)
    if not rows:
        return None
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        gs[0].device, non_blocking=True)
    return table, len(rows), first


def _adam_launch(table, k):
    """One launch of the kernel over a prepared leaf table."""
    lib = _build.load("adam", _bind)
    rows, n_leaves, chunks = table
    dev = rows.device
    err = lib.dk_adam(
        rows.data_ptr(), n_leaves, chunks, k["b1"], k["one_minus_b1"],
        k["b2"], k["one_minus_b2"], k["neg_lr"], k["eps"], k["bc1"],
        k["bc2"], 8 * torch.cuda.get_device_properties(dev)
        .multi_processor_count,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_adam")
    _build.count_launch(fused_adam_step)


def fused_adam_step(gs, ms, vs, count: int, lr, b1=0.9, b2=0.999, eps=1e-8,
                    impl: str = "kernel", out=None):
    """One Adam step over lists of leaves: ``(new_m, new_v, updates)``,
    written into ``out`` (three lists of tensors shaped as ``ms``, ``vs``
    and ``gs``; they may be those leaves themselves) where given.

    ``count`` is the step number (1 on the first step). With
    ``impl="kernel"`` CUDA leaves go through one launch of the hand-written
    kernel (or raise) and CPU leaves through the plain version;
    ``impl="plain"`` runs the plain version anywhere. ``launches`` counts
    kernel launches."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown fused_adam impl {impl!r}; use 'kernel' "
                         f"or 'plain'")
    k = _coefficients(count, lr, b1, b2, eps)
    if not gs:
        return [], [], []
    dev = gs[0].device
    if impl == "kernel" and dev.type == "cuda":
        return _adam_cuda(gs, ms, vs, k, out)
    if impl == "kernel" and dev.type != "cpu":
        raise ValueError(f"fused_adam runs on cpu or cuda tensors, got {dev}")
    res = [_adam_plain(g, m, v, k) for g, m, v in zip(gs, ms, vs)]
    res = [o[0] for o in res], [o[1] for o in res], [o[2] for o in res]
    if out is None:
        return res
    for dst, src in zip(out, res):
        for d, x in zip(dst, src):
            d.copy_(x)
    return out


fused_adam_step.launches = 0


def fused_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, impl: str = "kernel"
               ) -> GradientTransformation:
    """Adam as one fused kernel launch per step (optax-compatible
    semantics: same bias correction, eps outside the square root). State:
    ``{"count": int, "mu": tree, "nu": tree}`` with f32 moments."""
    lr = float(learning_rate)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def step(grads, state, into_grads: bool, own_state: bool):
        count = state["count"] + 1
        # autograd may hand back strided views (a transposed head's
        # gradient); the kernel walks contiguous leaves
        gs = [g.contiguous() for g in tree_leaves(grads)]
        ms, vs = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        fresh = lambda leaves: [torch.empty_like(x) for x in leaves]
        out = (ms if own_state else fresh(ms), vs if own_state else fresh(vs),
               gs if into_grads else fresh(gs))
        new_m, new_v, us = fused_adam_step(gs, ms, vs, count, lr, b1, b2,
                                           eps, impl=impl, out=out)
        rebuild = lambda leaves: _unflatten(grads, iter(leaves))
        return rebuild(us), {"count": count, "mu": rebuild(new_m),
                             "nu": rebuild(new_v)}

    def update(grads, state, params=None):
        del params
        return step(grads, state, False, False)

    def update_into(grads, state, own_state: bool):
        """``update`` for a caller that gives up ``grads`` (and, with
        ``own_state``, ``state``'s moments): the updates are written over
        the gradients and the new moments over the old, so that a step
        allocates no new leaves (the collective engine within a window,
        whose gradients and later moments nothing else holds)."""
        return step(grads, state, True, own_state)

    update.into = update_into
    return GradientTransformation(init, update)


def _unflatten(like, leaves):
    return tree_map(lambda _: next(leaves), like)
