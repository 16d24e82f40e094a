"""Local-SGD window engine — the collective backend's hot loop.

Port of ``distkeras_tpu/parallel/local_sgd.py``. Worker replica params are
stacked on a leading ``W`` axis and held on one device: one card carries
all W workers. A communication window is ``window`` local steps, each one
``torch.func.vmap(torch.func.grad_and_value(loss_step))`` over the W axis
(so every worker computes its own gradient on its own batch in one batched
pass), then the optimizer on the stacked tensors (elementwise, so equal to
a per-worker update, and one launch of the fused Adam kernel for all
workers), then the merge rule's reduction over W — the parameter exchange.

The host feeds superbatches ``[W, window, B, …]`` (``Dataset.superbatches``
through ``data.prefetch_to_device``), or uploads each worker's row shard
once and walks the epoch on the device (:meth:`run_epoch_resident`).
Losses stay on the device until the trainer reads them at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from distkeras_tpu_torch.data import place_on
from distkeras_tpu_torch.model import ModelSpec
from distkeras_tpu_torch.optim import GradientTransformation
from distkeras_tpu_torch.parallel.merge_rules import MergeRule
from distkeras_tpu_torch.utils import (
    resolve_device,
    tree_leaves,
    tree_like,
    tree_map,
)

LossStep = Callable[[dict, dict, tuple], tuple[torch.Tensor, dict]]


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
    the trainer (it knows the column layout and loss). ``device`` replaces
    the JAX engine's mesh: the card unless the caller asks for the CPU.
    """

    def __init__(self, spec: ModelSpec, loss_step: LossStep,
                 optimizer: GradientTransformation, rule: MergeRule,
                 device="cuda", num_workers: int = 1, window: int = 1,
                 batch_size: int | None = None):
        self.spec = spec
        self.loss_step = loss_step
        self.optimizer = optimizer
        self.rule = rule
        self.device = resolve_device(device)
        self.num_workers = int(num_workers)
        self.window = int(window)
        self.batch_size = int(batch_size) if batch_size else None
        self._place = place_on(self.device)
        # randomness="different": a model that draws inside its step (a
        # Keras Dropout) draws each worker's own numbers
        self._worker_grads = torch.func.vmap(
            torch.func.grad_and_value(loss_step, has_aux=True),
            randomness="different")

    # -- init ----------------------------------------------------------------

    def init_state(self, params: dict, nt: dict) -> TrainState:
        """Broadcast initial params (numpy or tensors) to every replica on
        the device."""
        W = self.num_workers
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
        ``optimizer.init`` (its step counts come back as ints)."""
        leaves = tree_leaves(host_state.workers)
        if leaves and leaves[0].shape[0] != self.num_workers:
            raise ValueError(
                f"checkpoint has {leaves[0].shape[0]} workers, engine "
                f"expects {self.num_workers}")

        def put(x):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.array(x, copy=True))
            return t.to(self.device)

        workers = tree_map(put, host_state.workers)
        opt = tree_like(host_state.opt_state, self.optimizer.init(workers))
        return TrainState(center=tree_map(put, host_state.center),
                          workers=workers, nt=tree_map(put, host_state.nt),
                          opt_state=opt, step=int(host_state.step))

    # -- the window ------------------------------------------------------------

    def _window_fn(self, state: TrainState, batch: tuple):
        """``window`` vmapped local steps + one merge → (state, mean loss)."""
        workers, nt, opt = state.workers, state.nt, state.opt_state
        losses = []
        for k in range(self.window):
            step_batch = tuple(a[:, k] for a in batch)
            grads, (loss, nt) = self._worker_grads(workers, nt, step_batch)
            updates, opt = self.optimizer.update(grads, opt, workers)
            workers = tree_map(lambda p, u: p + u.to(p.dtype), workers,
                               updates)
            losses.append(loss)
        center, workers = self.rule.merge(state.center, workers)
        loss = torch.stack(losses).mean(dim=0).mean()
        return TrainState(center=center, workers=workers, nt=nt,
                          opt_state=opt, step=state.step + 1), loss

    def place_batch(self, batch_arrays: tuple) -> tuple:
        """Host superbatch → tensors on the device (pinned, non-blocking
        copies to a CUDA device)."""
        return self._place(batch_arrays)

    def run_window(self, state: TrainState, batch_arrays: tuple):
        """Run one communication window. ``batch_arrays``: [W, window, B,
        …] host arrays, or tensors already placed by :meth:`place_batch`."""
        if not isinstance(batch_arrays[0], torch.Tensor):
            batch_arrays = self.place_batch(batch_arrays)
        return self._window_fn(state, batch_arrays)

    # -- device-resident dataset ---------------------------------------------

    def stage_dataset(self, worker_arrays: tuple) -> tuple:
        """Upload per-worker row shards ``[W, rows_per_worker, …]`` once."""
        return self._place(worker_arrays)

    def run_epoch_resident(self, state: TrainState, staged: tuple,
                           shuffle_seed: int | None):
        """One epoch over staged data → (state, per-window losses [S]).

        Shuffling permutes each worker's rows with a ``torch.Generator``
        seeded from ``shuffle_seed`` (the JAX engine's
        ``jax.random.permutation`` draws other numbers); ``None`` keeps
        the staged order."""
        if self.batch_size is None:
            raise ValueError("resident mode needs batch_size at engine init")
        W, rows = staged[0].shape[:2]
        win, B = self.window, self.batch_size
        S = rows // (win * B)
        if shuffle_seed is not None:
            gen = torch.Generator().manual_seed(int(shuffle_seed))
            perm = torch.stack([torch.randperm(rows, generator=gen)
                                for _ in range(W)]).to(self.device)
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

    def worker_nt(self, state: TrainState, i: int = 0) -> dict:
        """One worker's non-trainable state, as CPU tensors."""
        return tree_map(lambda x: x[i].detach().cpu(), state.nt)
