"""Functional optimizers over worker-stacked parameter trees.

The JAX package drew its worker optimizers from optax
(``distkeras_tpu/trainers.py::resolve_optimizer``). The port keeps optax's
contract and its defaults (not torch's): a :class:`GradientTransformation`
is ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``, and updates are additive (``params += updates``), which
the merge rules rely on. Trees are nested dicts of tensors.

The engine applies the optimizer outside the worker vmap, to the stacked
``[W, …]`` tensors, so that fused Adam sees every worker's every leaf in
one launch. Every transform here is elementwise, which makes that equal to
the reference's per-worker ``tx.update``, except global-norm clipping: it
reduces over every dim but the leading worker axis, one norm per worker.
Step counts are host integers (every worker steps in lockstep).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from distkeras_tpu_torch.utils import tree_leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _zeros(params, fill=0.0):
    return tree_map(lambda p: torch.full_like(p, fill), params)


def _bias_correction(moment, decay, count):
    """``t / (1 - decay^count)``, the correction computed in f32."""
    bc = np.float32(1.0) - np.power(np.float32(decay), np.float32(count))
    return tree_map(lambda t: t / torch.tensor(bc, dtype=t.dtype,
                                                device=t.device), moment)


def _moment(g, t, decay, order):
    return (1 - decay) * (g ** order) + decay * t


def scale(step_size: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: {},
        lambda g, s, params=None: (tree_map(lambda x: x * step_size, g), s))


def scale_by_learning_rate(learning_rate: float) -> GradientTransformation:
    return scale(-float(learning_rate))


def chain(*transforms) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def update(g, state, params=None):
        new = tree_map(lambda x, t: x + decay * t, g, state["trace"])
        out = tree_map(lambda x, t: x + decay * t, g, new) if nesterov else new
        return out, {"trace": new}

    return GradientTransformation(lambda p: {"trace": _zeros(p)}, update)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                  nesterov=False) -> GradientTransformation:
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(g, state, params=None):
        mu = tree_map(lambda x, t: _moment(x, t, b1, 1), g, state["mu"])
        nu = tree_map(lambda x, t: _moment(x, t, b2, 2), g, state["nu"])
        count = state["count"] + 1
        if nesterov:
            mu_hat = tree_map(
                lambda m, x: b1 * m + (1 - b1) * x,
                _bias_correction(mu, b1, count + 1),
                _bias_correction(g, b1, count))
        else:
            mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        out = tree_map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps),
                       mu_hat, nu_hat)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_adamax(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(g, state, params=None):
        count = state["count"] + 1
        mu = tree_map(lambda x, t: _moment(x, t, b1, 1), g, state["mu"])
        nu = tree_map(lambda x, t: torch.maximum(torch.abs(x) + eps,
                                                 b2 * t), g, state["nu"])
        out = tree_map(lambda m, v: m / v, _bias_correction(mu, b1, count),
                       nu)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value=0.1, eps=1e-7
                 ) -> GradientTransformation:
    def update(g, state, params=None):
        ss = tree_map(lambda x, t: x * x + t, g, state["sum_of_squares"])
        out = tree_map(
            lambda x, t: torch.where(t > 0, torch.rsqrt(t + eps),
                                     torch.zeros_like(t)) * x, g, ss)
        return out, {"sum_of_squares": ss}

    return GradientTransformation(
        lambda p: {"sum_of_squares": _zeros(p, initial_accumulator_value)},
        update)


def scale_by_rms(decay=0.9, eps=1e-8, initial_scale=0.0
                 ) -> GradientTransformation:
    def update(g, state, params=None):
        nu = tree_map(lambda x, t: _moment(x, t, decay, 2), g, state["nu"])
        out = tree_map(lambda x, n: torch.rsqrt(n + eps) * x, g, nu)
        return out, {"nu": nu}

    return GradientTransformation(
        lambda p: {"nu": _zeros(p, initial_scale)}, update)


def scale_by_adadelta(rho=0.9, eps=1e-6) -> GradientTransformation:
    def update(g, state, params=None):
        e_g = tree_map(lambda x, t: _moment(x, t, rho, 2), g, state["e_g"])
        out = tree_map(
            lambda x, cur, prev: (torch.sqrt(prev + eps)
                                  / torch.sqrt(cur + eps)) * x,
            g, e_g, state["e_x"])
        e_x = tree_map(lambda x, t: _moment(x, t, rho, 2), out, state["e_x"])
        return out, {"e_g": e_g, "e_x": e_x}

    return GradientTransformation(
        lambda p: {"e_g": _zeros(p), "e_x": _zeros(p)}, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(g, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        return tree_map(lambda x, p: x + weight_decay * p, g, params), state

    return GradientTransformation(lambda p: {}, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Global-norm clipping with one norm per worker: every leaf is
    ``[W, …]`` and the norm reduces over all dims but the first."""
    max_norm = float(max_norm)

    def update(g, state, params=None):
        leaves = tree_leaves(g)
        sq = sum(torch.sum(torch.square(x).reshape(x.shape[0], -1), dim=1)
                 for x in leaves)
        norm = torch.sqrt(sq)

        def clip(x):
            n = norm.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
            return torch.where(n < max_norm, x, (x / n) * max_norm)

        return tree_map(clip, g), state

    return GradientTransformation(lambda p: {}, update)


def clip(max_delta: float) -> GradientTransformation:
    """Elementwise clipping to ``[-max_delta, max_delta]``."""
    d = float(max_delta)
    return GradientTransformation(
        lambda p: {},
        lambda g, s, params=None: (tree_map(lambda x: x.clamp(-d, d), g), s))


def sgd(learning_rate, momentum: float | None = None, nesterov=False):
    parts = [trace(momentum, nesterov)] if momentum is not None else []
    return chain(*parts, scale_by_learning_rate(learning_rate))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, nesterov=False):
    return chain(scale_by_adam(b1, b2, eps, nesterov=nesterov),
                 scale_by_learning_rate(learning_rate))


def nadam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    return adam(learning_rate, b1, b2, eps, nesterov=True)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def adamax(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    return chain(scale_by_adamax(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    return chain(scale_by_rss(initial_accumulator_value, eps),
                 scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate, decay=0.9, eps=1e-8):
    return chain(scale_by_rms(decay, eps),
                 scale_by_learning_rate(learning_rate))


def adadelta(learning_rate, rho=0.9, eps=1e-6):
    return chain(scale_by_adadelta(rho, eps),
                 scale_by_learning_rate(learning_rate))
