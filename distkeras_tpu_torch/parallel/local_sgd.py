"""Local-SGD window engine — the collective backend's hot loop.

Port of ``distkeras_tpu/parallel/local_sgd.py``. Worker replica params are
stacked on a leading ``W`` axis and held on one device: one card carries
all W workers, or, with ``mesh=`` (W workers over processes, one card a
rank), each rank of the mesh's ``dp`` axis carries its contiguous
``W / dp`` of them and the merge rule finishes its reductions with one
``all_reduce`` over the ``dp`` group (:class:`~distkeras_tpu_torch.
parallel.merge_rules.WorkerAxis`). Every rank builds the same global
superbatch from the same seed and places only its own workers' rows, as
the JAX package's ``put_global`` does. A communication window is
``window`` local steps, each one
``torch.func.vmap(torch.func.grad_and_value(loss_step))`` over the W axis
(so every worker computes its own gradient on its own batch in one batched
pass), then the optimizer on the stacked tensors (elementwise, so equal to
a per-worker update, and one launch of the fused Adam kernel for all
workers), then the merge rule's reduction over W — the parameter exchange.

The host feeds superbatches ``[W, window, B, …]`` (``Dataset.superbatches``
through ``data.prefetch_to_device``), or uploads each worker's row shard
once and walks the epoch on the device (:meth:`run_epoch_resident`).
Losses stay on the device until the trainer reads them at the end.

With ``observability.trace`` on, a window records ``engine.window`` and,
inside it, ``engine.grads`` around each local step's vmapped forward and
backward, ``engine.forward`` inside the differentiated function (so
``engine.grads`` less it is the backward), ``engine.update`` around the
optimizer and the parameter add, and ``engine.merge`` around the rule's
fold; off, each is the tracer's shared no-op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch.data import place_on
from distkeras_tpu_torch.model import ModelSpec
from distkeras_tpu_torch.observability import trace as _trace
from distkeras_tpu_torch.optim import GradientTransformation
from distkeras_tpu_torch.parallel.merge_rules import MergeRule, WorkerAxis
from distkeras_tpu_torch.utils import (
    flatten,
    resolve_device,
    tree_leaves,
    tree_like,
    tree_map,
    unflatten,
)

LossStep = Callable[[dict, dict, tuple], tuple[torch.Tensor, dict]]

#: the ``dp`` group the running window's worker means span (None: every
#: worker is on this rank)
_DP = threading.local()


@contextlib.contextmanager
def _over_ranks(group):
    prev = getattr(_DP, "group", None)
    _DP.group = group
    try:
        yield
    finally:
        _DP.group = prev


def _rank_mean(x, group):
    """``x`` averaged over the ranks of ``group`` (every rank holds the
    same number of workers, so the mean of the ranks' worker means is the
    mean over all workers); ``x`` itself without a group of several."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


class _WorkerMean(torch.autograd.Function):
    """The mean over the stacked-worker dimension that ``torch.func.vmap``
    batches (the engine's W axis), broadcast back to every worker: the
    counterpart of ``lax.pmean`` over the JAX engine's named
    ``WORKER_AXIS``. Its backward is the same mean of the cotangent, as
    ``pmean``'s transpose, so under ``vmap(grad)`` worker i's gradient is
    ∂(Σ_j loss_j)/∂θ_i, as in the JAX package, not ∂loss_i/∂θ_i. With W
    workers over processes the mean spans every rank's workers: the mean
    over this rank's, then averaged over the ``dp`` group, forward and
    backward."""

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _WorkerMean.apply(g)

    @staticmethod
    def vmap(info, in_dims, x):
        d = in_dims[0]
        group = getattr(_DP, "group", None)
        if d is None:           # the same on every worker of this rank
            return _rank_mean(x.clone(), group), None
        m = _rank_mean(x.mean(dim=d, keepdim=True), group)
        return m.expand_as(x).clone(), d


def worker_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the vmapped worker dimension (sync BatchNorm's
    statistics); ``x`` itself outside ``vmap`` or when ``x`` is not
    batched."""
    return _WorkerMean.apply(x)


@dataclasses.dataclass
class TrainState:
    """Full training state, on the engine's device for the whole run."""

    center: dict       # merged model params
    workers: dict      # per-replica params, stacked [W, …]
    nt: dict           # per-replica non-trainable model state [W, …]
    opt_state: Any     # per-replica optimizer state (stacked leaves)
    step: int          # windows completed


class LocalSGDEngine:
    """Runs communication windows for one (model, rule) pair.

    ``loss_step(params, nt, batch_tuple) -> (loss, new_nt)`` is supplied by
    the trainer (it knows the column layout and loss). ``device`` is the
    card unless the caller asks for the CPU; ``mesh`` (a
    ``parallel.mesh.Mesh``) spreads the ``num_workers`` (global W) over
    the ranks of its ``"dp"`` axis, on the mesh's device. Every state,
    superbatch and staged shard this engine hands out holds this rank's
    workers only (``local_workers`` of them); the center, the losses and
    :meth:`worker_nt` are the same on every rank.
    """

    def __init__(self, spec: ModelSpec, loss_step: LossStep,
                 optimizer: GradientTransformation, rule: MergeRule,
                 device="cuda", num_workers: int = 1, window: int = 1,
                 batch_size: int | None = None, mesh=None):
        self.spec = spec
        self.loss_step = loss_step
        self.optimizer = optimizer
        self.rule = rule
        self.num_workers = int(num_workers)
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.local = slice(0, self.num_workers)
            self.axis = None
        else:
            from distkeras_tpu_torch.parallel.mesh import worker_slice

            self.device = mesh.device
            self.local = worker_slice(mesh, self.num_workers)
            self.axis = WorkerAxis(mesh.group("dp"), self.local.start,
                                   self.num_workers)
        self.local_workers = self.local.stop - self.local.start
        self.window = int(window)
        self.batch_size = int(batch_size) if batch_size else None
        self._place = place_on(self.device)

        def forward(params, nt, batch):
            with _trace.span("engine.forward"):
                return loss_step(params, nt, batch)

        # randomness="different": a model that draws inside its step (a
        # Keras Dropout) draws each worker's own numbers
        self._worker_grads = torch.func.vmap(
            torch.func.grad_and_value(forward, has_aux=True),
            randomness="different")

    # -- init ----------------------------------------------------------------

    def init_state(self, params: dict, nt: dict) -> TrainState:
        """Broadcast initial params (numpy or tensors) to every replica on
        the device (this rank's replicas, over a mesh)."""
        W = self.local_workers
        put = lambda x: torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.device).clone()
        stack = lambda x: x[None].expand(W, *x.shape).clone()
        center = tree_map(put, params)
        workers = tree_map(stack, center)
        return TrainState(
            center=center, workers=workers,
            nt=tree_map(stack, tree_map(put, nt)),
            opt_state=self.optimizer.init(workers), step=0)

    def init_state_from(self, host_state: TrainState) -> TrainState:
        """Place a restored host ``TrainState`` (a checkpoint's: numpy
        leaves, or CPU bf16 tensors) on the device: the resume path. The
        optimizer state takes the structure and leaf types of a fresh
        ``optimizer.init`` (its step counts come back as ints). The host
        state holds all W workers; this rank places its own."""
        leaves = tree_leaves(host_state.workers)
        if leaves and leaves[0].shape[0] != self.num_workers:
            raise ValueError(
                f"checkpoint has {leaves[0].shape[0]} workers, engine "
                f"expects {self.num_workers}")
        sl = self.local

        def put(x, rows=False):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.array(x, copy=True))
            return (t[sl] if rows else t).to(self.device)

        workers = tree_map(lambda x: put(x, True), host_state.workers)
        fresh = self.optimizer.init(workers)
        saved, structure = flatten(host_state.opt_state)
        saved = [h[sl] if isinstance(f, torch.Tensor) else h
                 for h, f in zip(saved, flatten(fresh)[0])]
        opt = tree_like(unflatten(structure, saved), fresh)
        return TrainState(center=tree_map(put, host_state.center),
                          workers=workers,
                          nt=tree_map(lambda x: put(x, True), host_state.nt),
                          opt_state=opt, step=int(host_state.step))

    # -- the window ------------------------------------------------------------

    def _window_span(self, state: TrainState, batch: tuple):
        """The window's ``engine.window`` span. While tracing is on, the
        window's step becomes this thread's corr, so that every span the
        window closes here carries it, and the args say what the window
        trains: ``rows`` (W·window·B) and ``tokens`` (the first column's
        elements where it holds integer ids, else the rows)."""
        if not _trace.enabled():
            return _trace.span("engine.window")
        _trace.set_corr(f"x{state.step}")
        first = batch[0]
        rows = first.shape[0] * first.shape[1] * first.shape[2]
        tokens = first.numel() if not first.is_floating_point() else rows
        return _trace.span("engine.window",
                           args={"rows": int(rows), "tokens": int(tokens)})

    def _step(self, k: int, grads, opt, workers):
        """The optimizer's step ``k`` of a window and the parameter add.
        The window's input state stays as it was (a caller may keep it);
        what the window made itself is its own to overwrite: the
        gradients always, the moments and the workers from the second
        step on. An optimizer with an ``update.into`` (fused Adam) writes
        its updates over the gradients and, from the second step on, its
        moments over the old ones; from the second step on the updates
        are added to the workers in place. No value changes, only where it
        is stored: a 1B-parameter model's window would otherwise hold
        three generations of workers and moments at once."""
        into = getattr(self.optimizer.update, "into", None)
        if into is not None:
            updates, opt = into(grads, opt, own_state=k > 0)
        else:
            updates, opt = self.optimizer.update(grads, opt, workers)
        if k > 0:
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), workers, updates)
        else:
            workers = tree_map(lambda p, u: p + u.to(p.dtype), workers,
                               updates)
        return workers, opt

    def _window_fn(self, state: TrainState, batch: tuple):
        """``window`` vmapped local steps + one merge → (state, mean loss)."""
        workers, nt, opt = state.workers, state.nt, state.opt_state
        losses = []
        group = None if self.axis is None else self.axis.group
        with self._window_span(state, batch):
            with _over_ranks(group):
                for k in range(self.window):
                    step_batch = tuple(a[:, k] for a in batch)
                    with _trace.span("engine.grads"):
                        grads, (loss, nt) = self._worker_grads(
                            workers, nt, step_batch)
                    with _trace.span("engine.update"):
                        workers, opt = self._step(k, grads, opt, workers)
                    del grads
                    losses.append(loss)
            with _trace.span("engine.merge"):
                center, workers = self.rule.merge(state.center, workers,
                                                  axis=self.axis)
            loss = torch.stack(losses).mean(dim=0).mean()
            if self.axis is not None:
                # the global mean: this rank's, weighted by its share of W
                loss = loss * (self.local_workers / self.num_workers)
                loss = loss.contiguous()
                dist.all_reduce(loss, group=group)
        return TrainState(center=center, workers=workers, nt=nt,
                          opt_state=opt, step=state.step + 1), loss

    def _own_rows(self, arrays: tuple) -> tuple:
        """This rank's workers' rows of global ``[W, …]`` host arrays."""
        if self.mesh is None:
            return arrays
        return tuple(a[self.local] for a in arrays)

    def place_batch(self, batch_arrays: tuple) -> tuple:
        """Host superbatch ``[W, …]`` → this rank's workers' rows as
        tensors on the device (pinned, non-blocking copies to a CUDA
        device)."""
        return self._place(self._own_rows(batch_arrays))

    def run_window(self, state: TrainState, batch_arrays: tuple):
        """Run one communication window. ``batch_arrays``: [W, window, B,
        …] host arrays (all W workers'), or tensors already placed by
        :meth:`place_batch`."""
        if not isinstance(batch_arrays[0], torch.Tensor):
            batch_arrays = self.place_batch(batch_arrays)
        return self._window_fn(state, batch_arrays)

    # -- device-resident dataset ---------------------------------------------

    def stage_dataset(self, worker_arrays: tuple) -> tuple:
        """Upload per-worker row shards ``[W, rows_per_worker, …]`` once
        (this rank's workers' shards, over a mesh)."""
        return self._place(self._own_rows(worker_arrays))

    def run_epoch_resident(self, state: TrainState, staged: tuple,
                           shuffle_seed: int | None):
        """One epoch over staged data → (state, per-window losses [S]).

        Shuffling permutes each worker's rows with a ``torch.Generator``
        seeded from ``shuffle_seed`` (the JAX engine's
        ``jax.random.permutation`` draws other numbers); ``None`` keeps
        the staged order. Every rank of a mesh draws all W workers'
        permutations and keeps its own workers', so a run does not depend
        on how W is split over ranks."""
        if self.batch_size is None:
            raise ValueError("resident mode needs batch_size at engine init")
        W, rows = staged[0].shape[:2]
        win, B = self.window, self.batch_size
        S = rows // (win * B)
        if shuffle_seed is not None:
            gen = torch.Generator().manual_seed(int(shuffle_seed))
            perm = torch.stack([torch.randperm(rows, generator=gen)
                                for _ in range(self.num_workers)])
            perm = perm[self.local].to(self.device)
            take = torch.arange(W, device=self.device)[:, None]
            staged = tuple(c[take, perm] for c in staged)
        data = tuple(c[:, : S * win * B].reshape((W, S, win, B) + c.shape[2:])
                     for c in staged)
        losses = []
        for s in range(S):
            state, loss = self._window_fn(state, tuple(d[:, s] for d in data))
            losses.append(loss)
        return state, torch.stack(losses)

    # -- results -------------------------------------------------------------

    def center_params(self, state: TrainState) -> dict:
        """The merged params, as CPU tensors."""
        return tree_map(lambda x: x.detach().cpu(), state.center)

    def worker_nt_device(self, state: TrainState, i: int = 0) -> dict:
        """Worker ``i``'s (global index) non-trainable state on the
        device; over a mesh the rank that holds it broadcasts it to every
        rank of ``dp`` (a collective: every rank calls it)."""
        if self.mesh is None:
            return tree_map(lambda x: x[i], state.nt)
        n = self.local_workers
        owner, row = divmod(int(i), n)
        group = self.axis.group
        src = dist.get_process_group_ranks(group)[owner]
        mine = self.local.start == owner * n

        def bcast(x):
            t = x[row].clone() if mine else torch.empty_like(x[0])
            dist.broadcast(t, src=src, group=group)
            return t

        return tree_map(bcast, state.nt)

    def worker_nt(self, state: TrainState, i: int = 0) -> dict:
        """One worker's non-trainable state, as CPU tensors (the same on
        every rank)."""
        return tree_map(lambda x: x.detach().cpu(),
                        self.worker_nt_device(state, i))

    def sharded_state(self, state: TrainState) -> TrainState:
        """The state as a process-sharded checkpoint tree
        (``checkpoint.save_sharded``): every worker-stacked leaf a
        ``ShardedLeaf`` of its global ``[W, …]`` shape holding this
        rank's rows; the center, the step and the step counts whole."""
        from distkeras_tpu_torch.parallel.tensor import ShardedLeaf

        W, lo = self.num_workers, self.local.start

        def shard(x):
            if not isinstance(x, torch.Tensor):
                return x
            arr = x.detach().cpu()
            if arr.dtype == torch.bfloat16:
                arr = arr.to(torch.float32)
            arr = arr.numpy()
            return ShardedLeaf((W,) + arr.shape[1:], arr.dtype,
                               [((lo,) + (0,) * (arr.ndim - 1), arr)], True)

        return TrainState(center=state.center,
                          workers=tree_map(shard, state.workers),
                          nt=tree_map(shard, state.nt),
                          opt_state=_map_tensors(shard, state.opt_state),
                          step=state.step)


def _map_tensors(fn, tree):
    """``fn`` over the tensor leaves of ``tree``, other leaves kept."""
    leaves, structure = flatten(tree)
    return unflatten(structure, [fn(x) if isinstance(x, torch.Tensor) else x
                                 for x in leaves])
