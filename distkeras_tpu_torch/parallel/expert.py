"""Mixture of experts: the GShard-style MoE MLP, on one device and over an
``ep`` mesh axis. Port of ``distkeras_tpu/parallel/expert.py``.

A learned gate picks ``top_k`` experts a token; tokens are packed into
per-expert capacity slots through one-hot dispatch and combine tensors
(static shapes), slots assigned choice-major (every first choice before
any second choice), and tokens beyond an expert's capacity are dropped:
they contribute zero, and the residual around the layer carries them.
Everything is differentiable through the combine weights (the softmax
probabilities).

Over an ``ep`` axis (:func:`moe_mlp`, :func:`moe_mlp_shard`) each rank
routes its own slice of the tokens and holds ``E/N`` of the experts; the
dispatched slots travel to their experts' rank and back with a
differentiable ``all_to_all_single``, capacity counted a rank (the GShard
convention), and the aux loss is the mean of the ranks'. Every replicated
input (the tokens, the gate) enters through a conjugate operator, so its
gradient comes back whole on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from distkeras_tpu_torch.parallel import mesh as mesh_mod


def init_moe_params(rng: np.random.Generator, d_model: int, d_hidden: int,
                    num_experts: int, scale: float = 0.02) -> dict:
    """Host-side init: gate + stacked expert MLP weights ``[E, ...]``, as
    numpy arrays drawn from ``rng`` (the JAX package's draws)."""
    def rnd(*shape):
        return rng.normal(0, scale, size=shape).astype(np.float32)

    return {
        "gate": rnd(d_model, num_experts),
        "w1": rnd(num_experts, d_model, d_hidden),
        "b1": np.zeros((num_experts, d_hidden), np.float32),
        "w2": rnd(num_experts, d_hidden, d_model),
        "b2": np.zeros((num_experts, d_model), np.float32),
    }


def _expert_mlp(w1, b1, w2, b2, x):
    """The per-expert feed-forward, x ``[..., E, C, d] → [..., E, C, d]``,
    with ``jax.nn.gelu``'s default tanh approximation."""
    h = torch.einsum("...ecd,edh->...ech", x, w1) + b1[..., None, :]
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("...ech,ehd->...ecd", h, w2) + b2[..., None, :]


def _one_hot(idx, n: int):
    """f32 one-hot of integer ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a row of zeros (``jax.nn.one_hot``'s rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _dispatch_combine(gate_logits, num_experts: int, capacity: int,
                      top_k: int):
    """GShard dispatch/combine tensors for local tokens: ``gate_logits [t,
    E]`` → (dispatch ``[t, E, C]`` 0/1, combine ``[t, E, C]``, the
    load-balancing aux ``E · Σ_e frac_e · mean_prob_e`` with ``frac`` the
    first choices' share). Slots are assigned choice-major; tokens over
    capacity are dropped."""
    t = gate_logits.shape[0]
    probs = torch.softmax(gate_logits.to(torch.float32), dim=-1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)         # [t, k]
    # renormalize the kept probabilities so combine weights sum to 1
    top_vals = top_vals / torch.clamp(
        torch.sum(top_vals, dim=-1, keepdim=True), min=1e-9)

    oh = _one_hot(top_idx, num_experts)                            # [t, k, E]
    # choice-major slot ranks: [k*t, E] with the choice as the slow axis
    oh_cm = oh.transpose(0, 1).reshape(top_k * t, num_experts)
    ranks = torch.cumsum(oh_cm, dim=0) - oh_cm
    pos_cm = torch.sum(ranks * oh_cm, dim=-1)                      # [k*t]
    pos = pos_cm.reshape(top_k, t).transpose(0, 1).to(torch.int64)  # [t, k]
    keep = (pos < capacity).to(torch.float32)                      # [t, k]

    pos_oh = _one_hot(pos, capacity)                               # [t, k, C]
    dispatch = torch.einsum("tke,tkc,tk->tec", oh, pos_oh, keep)
    combine = torch.einsum("tke,tkc,tk->tec", oh, pos_oh, keep * top_vals)

    frac = torch.mean(oh[:, 0, :], dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = num_experts * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def moe_capacity(tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float | None) -> int:
    """Slots an expert: ``max(1, int(cf · T · k / E))``, or ``T`` (no
    token ever dropped) for ``capacity_factor=None``."""
    if capacity_factor is None:
        return tokens
    return max(1, int(capacity_factor * tokens * top_k / num_experts))


def moe_mlp_reference(params, x, top_k: int = 1,
                      capacity_factor: float | None = None):
    """The single-device MoE MLP: ``x [T, d]`` → (``[T, d]``, aux loss).
    ``params``: ``gate [d, E]``, ``w1 [E, d, h]``, ``b1 [E, h]``, ``w2
    [E, h, d]``, ``b2 [E, d]`` (tensors). ``capacity_factor=None`` means
    no token is ever dropped (capacity = T)."""
    E = params["gate"].shape[1]
    cap = moe_capacity(x.shape[0], E, top_k, capacity_factor)
    xf = x.to(torch.float32)
    logits = xf @ params["gate"]
    dispatch, combine, aux = _dispatch_combine(logits, E, cap, top_k)
    xin = torch.einsum("tec,td->ecd", dispatch, xf)
    out = _expert_mlp(params["w1"], params["b1"], params["w2"], params["b2"],
                      xin)
    return torch.einsum("tec,ecd->td", combine, out).to(x.dtype), aux


def moe_mlp_shard(params, x, group, top_k: int = 1,
                  capacity_factor: float = 2.0):
    """The expert-parallel MoE MLP on one rank of ``group``: ``x [T, d]``
    the tokens every rank holds alike, ``params["gate"] [d, E]`` whole,
    the expert leaves this rank's ``[E/N, …]``. The rank routes tokens
    ``r·T/N …``; returns ``(y [T, d], aux)``, the same on every rank."""
    N = mesh_mod._gsize(group)
    E = params["gate"].shape[1]
    T = x.shape[0]
    if E % N:
        raise ValueError(f"{E} experts not divisible by the ep axis of "
                         f"size {N}")
    if T % N:
        raise ValueError(f"{T} tokens not divisible by the ep axis of "
                         f"size {N}")
    capacity = max(1, int(capacity_factor * (T // N) * top_k / E))
    xl = mesh_mod.split_to(x.to(torch.float32), group, 0)
    gate = mesh_mod.copy_to(params["gate"], group)
    dispatch, combine, aux = _dispatch_combine(xl @ gate, E, capacity, top_k)
    xin = torch.einsum("tec,td->ecd", dispatch, xl)
    # [E, C, d] → each rank its expert group: [E/N, N·C, d]
    xin = mesh_mod.all_to_all(xin, group, 0, 1)
    out = _expert_mlp(params["w1"], params["b1"], params["w2"], params["b2"],
                      xin)
    out = mesh_mod.all_to_all(out, group, 1, 0)
    y = torch.einsum("tec,ecd->td", combine, out).to(x.dtype)
    return (mesh_mod.gather_from(y, group, 0),
            mesh_mod.reduce_from(aux, group) / N)


def moe_mlp(params, x, mesh, axis: str = "ep", top_k: int = 1,
            capacity_factor: float = 2.0):
    """Expert-parallel MoE MLP: tokens AND experts split over ``axis``.
    Every rank passes the whole ``params`` (:func:`init_moe_params`, as
    tensors; ``E`` divisible by the axis size) and the whole ``x [T,
    d]`` (``T`` divisible too); capacity a rank is ``capacity_factor ·
    (T/N) · top_k / E``. Returns ``(y [T, d], aux)`` on every rank, ``y``
    equal to :func:`moe_mlp_reference` when no token overflows; the
    gradients of ``params`` and ``x`` come back whole on every rank."""
    N = mesh.size(axis)
    E = params["gate"].shape[1]
    if E % N:
        raise ValueError(f"{E} experts not divisible by mesh axis "
                         f"'{axis}' of size {N}")
    if x.shape[0] % N:
        raise ValueError(f"{x.shape[0]} tokens not divisible by mesh axis "
                         f"'{axis}' of size {N}")
    g = mesh.group(axis)
    local = {k: (v if k == "gate" else mesh_mod.split_to(v, g, 0))
             for k, v in params.items()}
    return moe_mlp_shard(local, x, g, top_k=top_k,
                         capacity_factor=capacity_factor)
