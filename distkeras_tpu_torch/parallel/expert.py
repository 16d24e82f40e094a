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

Beside it, the LM's dropless token-choice layer (the port's own; the JAX
package has none): :func:`route_sigmoid_topk` scores every expert with a
sigmoid and picks ``top_k`` a token, and :func:`held_experts` computes
the part of the layer's output that the experts held here give, for every
token routed to them, whatever their number (no capacity, nothing
dropped). It is told which experts it holds (``first`` and the count its
weights carry): in an expert-parallel deployment every chip routes over
all experts and computes its own experts' share, and this layer is that
share without the exchange. The held (token, expert) pairs are sorted by
expert on the device, their rows gathered, each expert's SwiGLU run over
its own rows by the grouped products of ``ops/moe_gemm.py``, and the
outputs weighted and summed back per token; no count reaches the host.
Under ``torch.func.vmap`` over the engine's stacked workers the layer and
its backward fold the worker axis into the expert groups: W workers'
``E`` held experts are ``W · E`` groups of one launch.

With ``observability.trace`` on, the layer records ``moe.route`` (the
router, top-k, the sort and the gather), ``moe.experts`` (the grouped
products and SwiGLU), ``moe.combine`` and, on the thread autograd runs it
on, ``moe.backward``; :data:`LOAD` counts the pairs computed here and the
load imbalance of the calls made on a thread that runs a window (see
:class:`ExpertLoad`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.ops.moe_gemm import (
    grouped_mm,
    grouped_mm_dw,
    grouped_mm_dx,
    swiglu_weighted,
    swiglu_weighted_grad,
)
from distkeras_tpu_torch.parallel import mesh as mesh_mod
from distkeras_tpu_torch.utils import fold_vmapped as _fold
from distkeras_tpu_torch.utils import unfold_vmapped as _unfold


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


# -- the LM's dropless token-choice layer ----------------------------------------

def route_sigmoid_topk(x, router_weight, expert_bias, top_k: int,
                       route_scale: float):
    """Sigmoid token-choice routing over every expert: ``s =
    sigmoid(x · router_weightᵀ)`` in f32 (``router_weight [E, d]``), the
    experts ``idx = topk(s + expert_bias)`` (the bias moves the choice
    only), their weights ``s[idx]`` normalised to sum 1 (``+ 1e-20``) and
    scaled by ``route_scale``. ``x [T, d]`` → ``(idx [T, top_k] int64,
    w [T, top_k] f32)``; differentiable in ``x`` and the router through
    ``w``."""
    s = torch.sigmoid(x.to(torch.float32)
                      @ router_weight.to(torch.float32).t())
    idx = torch.topk(s + expert_bias, int(top_k), dim=-1).indices
    w = torch.gather(s, -1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * route_scale


class ExpertLoad:
    """The held experts' load, counted while tracing is on. Each layer
    call adds its groups' rows on the device; at the first call of the
    next window (the engine's correlation id changes) the window's sums
    are read to the host once and emitted as the tracer's counters
    ``moe.pairs`` (pairs computed here a layer call, every worker's) and
    ``moe.rows_max_over_mean`` (the largest group's rows over the mean
    group's, averaged over the calls), and added to the totals
    ``windows``, ``pairs`` and ``calls``."""

    def __init__(self):
        self.corr = None
        self._sums = None       # device [pairs, max/mean] of the window
        self._calls = 0
        self.windows, self.pairs, self.calls = 0, 0.0, 0

    def add(self, offsets) -> None:
        corr = _trace.current_corr()
        if corr != self.corr:
            self.flush()
            self.corr = corr
        rows = (offsets[1:] - offsets[:-1]).to(torch.float32)
        v = torch.stack([rows.sum(),
                         rows.max() / rows.mean().clamp(min=1e-30)])
        self._sums = v if self._sums is None else self._sums + v
        self._calls += 1

    def flush(self) -> None:
        """Emit and total the pending window (one host read)."""
        if self._sums is None:
            return
        pairs, ratio = self._sums.tolist()
        n = self._calls
        _trace.counter("moe.pairs", pairs / n)
        _trace.counter("moe.rows_max_over_mean", ratio / n)
        self.windows, self.pairs, self.calls = (
            self.windows + 1, self.pairs + pairs, self.calls + n)
        self._sums, self._calls = None, 0


#: the process's expert-load counters (what the benchmark's readers read)
LOAD = ExpertLoad()


def _route(idx, first: int, held: int, workers: int):
    """The held pairs sorted by (worker, expert), on the device: ``idx
    [n, k]`` (``n`` tokens, worker after worker) → ``(ok [n·k] bool, order
    [n·k]`` sorted position → pair, ``inv`` pair → sorted position, ``tok``
    the sorted pairs' tokens, ``offsets`` int32 ``[workers·held + 1]``).
    Pairs of experts held elsewhere sort last, in no group."""
    n, k = idx.shape
    local = idx - first
    ok = ((local >= 0) & (local < held)).reshape(-1)
    worker = torch.div(torch.arange(n, device=idx.device), n // workers,
                       rounding_mode="floor")
    groups = workers * held
    key = torch.where(ok, (local + worker[:, None] * held).reshape(-1),
                      groups)
    skey, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        skey, torch.arange(groups + 1, device=idx.device,
                           dtype=skey.dtype)).to(torch.int32)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=idx.device))
    tok = torch.div(order, k, rounding_mode="floor")
    return ok, order, inv, tok, offsets


def _held_forward(x, idx, w, w_gate_up, w_down, first, workers, load):
    n, k = idx.shape
    held = w_gate_up.shape[0] // workers
    with _trace.span("moe.route"):
        ok, order, inv, tok, offsets = _route(idx, first, held, workers)
        xs = x.index_select(0, tok)
        ws = torch.where(ok, w.reshape(-1), 0.0)[order]
    if load is not None:
        load.add(offsets)
    with _trace.span("moe.experts"):
        h = grouped_mm(xs, w_gate_up, offsets)
        ys = grouped_mm(swiglu_weighted(h, ws, offsets), w_down, offsets)
    with _trace.span("moe.combine"):
        y = ys.index_select(0, inv).reshape(n, k, -1).sum(
            dim=1, dtype=torch.float32)
    return y, h


def _held_backward(dy, x, idx, w, w_gate_up, w_down, h, first, workers):
    n, k = idx.shape
    held = w_gate_up.shape[0] // workers
    ok, order, inv, tok, offsets = _route(idx, first, held, workers)
    ws = torch.where(ok, w.reshape(-1), 0.0)[order]
    dg = dy.to(x.dtype).index_select(0, tok)
    dh, a_w, dws = swiglu_weighted_grad(
        h, ws, grouped_mm_dx(dg, w_down, offsets), offsets)
    d_down = grouped_mm_dw(a_w, dg, offsets)
    d_gate_up = grouped_mm_dw(x.index_select(0, tok), dh, offsets)
    dxs = grouped_mm_dx(dh, w_gate_up, offsets)
    dx = dxs.index_select(0, inv).reshape(n, k, -1).sum(
        dim=1, dtype=torch.float32).to(x.dtype)
    return dx, dws[inv].reshape(n, k), d_gate_up, d_down


def _fold_args(info, in_dims, args):
    return [_fold(a, d, info.batch_size) if isinstance(a, torch.Tensor)
            else a for a, d in zip(args, in_dims)]


class _HeldExpertsGrad(torch.autograd.Function):
    """The layer's backward as a Function, so that ``torch.func.vmap``
    batches it through its rule (its own backward, a second derivative,
    is not provided)."""

    @staticmethod
    def forward(dy, x, idx, w, w_gate_up, w_down, h, first, workers):
        with _trace.span("moe.backward"):
            return _held_backward(dy, x, idx, w, w_gate_up, w_down, h,
                                  first, workers)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the expert layer has no second "
                                  "derivative")

    @staticmethod
    def vmap(info, in_dims, *args):
        *tensors, first, workers = _fold_args(info, in_dims, args)
        outs = _HeldExpertsGrad.apply(*tensors, first,
                                      workers * info.batch_size)
        return (tuple(_unfold(o, info.batch_size) for o in outs),
                (0, 0, 0, 0))


class _HeldExperts(torch.autograd.Function):
    """``(y [n, d] f32, h)``: the held experts' weighted outputs a token,
    and the gate|up product the backward reads (not differentiable).
    Under ``vmap`` the worker axis folds into the tokens and the expert
    groups; ``h`` then holds every worker's rows in the folded order, and
    only the backward's rule, which folds it again, reads it."""

    @staticmethod
    def forward(x, idx, w, w_gate_up, w_down, first, workers, load):
        return _held_forward(x, idx, w, w_gate_up, w_down, first, workers,
                             load)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, idx, w, w_gate_up, w_down, first, workers, _ = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(x, idx, w, w_gate_up, w_down, output[1])
        ctx.args = (first, workers)

    @staticmethod
    def backward(ctx, dy, _dh):
        dx, dw, d_gate_up, d_down = _HeldExpertsGrad.apply(
            dy, *ctx.saved_tensors, *ctx.args)
        return dx, None, dw, d_gate_up, d_down, None, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        *tensors, first, workers, load = _fold_args(info, in_dims, args)
        y, h = _HeldExperts.apply(*tensors, first, workers * info.batch_size,
                                  load)
        return (_unfold(y, info.batch_size), _unfold(h, info.batch_size)), \
            (0, 0)


def held_experts(x, idx, w, w_gate_up, w_down, first: int = 0):
    """The part of a dropless token-choice layer's output that the experts
    held here give: ``Σ_j w[t, j] · expert_{idx[t, j]}(x[t])`` over the
    picks ``j`` whose expert is held, every expert a SwiGLU without bias,
    ``down(silu(gate(x)) · up(x))``.

    ``x [T, d]`` (the products' dtype), ``idx [T, k]`` global expert ids,
    ``w [T, k]`` f32 gate weights, ``w_gate_up [E, 2F, d]`` (gate rows,
    then up rows) and ``w_down [E, d, F]``, the experts ``first …
    first + E - 1``. Returns ``[T, d]`` f32; differentiable in ``x``,
    ``w`` and both weights, batchable by ``torch.func.vmap``. Dropless:
    any number of a token's picks, and of all tokens, may land on one
    expert, and an expert with none contributes zero."""
    # counted on the thread that runs a window (its correlation id set),
    # not in a rematerialised block's recompute on autograd's thread
    count = _trace.enabled() and _trace.current_corr() is not None
    y, _ = _HeldExperts.apply(x, idx, w, w_gate_up, w_down, int(first), 1,
                              LOAD if count else None)
    return y
