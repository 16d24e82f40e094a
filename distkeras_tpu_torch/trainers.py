"""Trainer hierarchy — the reference's user-facing API, on PyTorch + CUDA.

Port of ``distkeras_tpu/trainers.py`` on the collective backend:
``Trainer``, ``DistributedTrainer``, ``AsynchronousDistributedTrainer``,
``SingleTrainer`` and the five algorithms ``ADAG, DOWNPOUR, AEASGD, EAMSGD,
DynSGD`` with the reference's constructor kwargs and defaults, and
``train(dataset, shuffle=False) -> trained params``. ``train`` builds a
:class:`~distkeras_tpu_torch.parallel.LocalSGDEngine` and runs
communication windows whose merge rule is the parameter exchange.

``device="cuda"`` (the default) replaces the JAX package's ``mesh``: one
card holds all ``num_workers`` stacked workers. Kwargs whose machinery
belongs to a later slice of the port (the parameter-server backend and its
resilience, elastic and observability knobs, checkpoints, EMA, validation,
profiling, meshes) are accepted by name and raise ``NotImplementedError``
naming their ``ROADMAP.md`` item when set to anything but their default:
nothing is silently ignored.
"""

from __future__ import annotations

import json
import time
from typing import Callable

import numpy as np
import torch

from distkeras_tpu_torch import optim, utils
from distkeras_tpu_torch.data import Dataset, prefetch_to_device
from distkeras_tpu_torch.model import ModelSpec
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distkeras_tpu_torch.parallel.merge_rules import (
    ADAGMerge,
    DownpourMerge,
    DynSGDMerge,
    ElasticAverageMerge,
    MergeRule,
)

#: reference kwargs of later slices: name → (default, ROADMAP item)
_LATER = {
    "backend": ("collective", "A7 (the async parameter-server backend)"),
    "mesh": (None, "A12 (meshes across cards)"),
    "ema_decay": (None, "A8 (checkpoints and EMA)"),
    "checkpoint_dir": (None, "A8 (checkpoints and EMA)"),
    "checkpoint_every": (1, "A8 (checkpoints and EMA)"),
    "resume": (False, "A8 (checkpoints and EMA)"),
    "checkpoint_async": (False, "A8 (checkpoints and EMA)"),
    "validation_data": (None, "A9 (validation, profiling, Keras frontend)"),
    "profile_dir": (None, "A9 (validation, profiling, Keras frontend)"),
    "deploy_streamer": (None, "A13 (deploy streaming)"),
}
for _name, _default in {
        "ps_transport": "inprocess", "ps_port": 0, "ps_host": None,
        "worker_id_offset": 0, "compression": None, "pull_compression": None,
        "trace": False, "trace_dir": None, "trace_sample": 1.0,
        "analyze": False, "watch": False, "watch_rules": None,
        "watch_dir": None, "watch_hook": None, "scrape_interval": 0.5,
        "tolerate_worker_failures": False, "worker_restart_budget": 0,
        "worker_restart_delay": 0.0, "retry_policy": None,
        "heartbeat_interval": None, "lease_timeout": None,
        "fault_plan": None, "ps_wal_dir": None, "ps_snapshot_every": 100,
        "ps_wal_group_window": 8, "ps_wal_group_interval": 0.25,
        "ps_standby": False, "ps_failover_timeout": None,
        "ps_num_shards": 1, "ps_chain_length": 1, "ps_fused_exchange": True,
        "ps_pipeline_depth": 0, "elastic": False, "autoscale_target": None,
        "preempt_drain_timeout": 5.0, "max_pool_size": None,
        "directory": False, "directory_standby": True,
        "ps_directory": None}.items():
    _LATER[_name] = (_default, "A7 (the async parameter-server backend)")


def _check_later(kwargs: dict) -> None:
    for name, value in kwargs.items():
        if name not in _LATER:
            raise TypeError(f"unexpected keyword argument {name!r}")
        default, item = _LATER[name]
        changed = value is not None if default is None else value != default
        if changed:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: ROADMAP.md {item}")


def _with_clipping(base, clipnorm, clipvalue):
    """Keras-style clipping in front of an optimizer: ``clipnorm`` is a
    global norm per worker, ``clipvalue`` elementwise."""
    pre = []
    if clipnorm is not None:
        pre.append(optim.clip_by_global_norm(float(clipnorm)))
    if clipvalue is not None:
        pre.append(optim.clip(float(clipvalue)))
    return optim.chain(*pre, base) if pre else base


def resolve_optimizer(worker_optimizer, learning_rate: float,
                      momentum: float = 0.0, nesterov: bool = False,
                      clipnorm=None, clipvalue=None):
    """Map the reference's Keras optimizer names onto functional
    optimizers with optax's defaults."""
    if isinstance(worker_optimizer, optim.GradientTransformation):
        return _with_clipping(worker_optimizer, clipnorm, clipvalue)
    name = str(worker_optimizer).lower()
    if name == "sgd":
        base = (optim.sgd(learning_rate, momentum=momentum,
                          nesterov=nesterov)
                if momentum else optim.sgd(learning_rate))
    elif name == "adam":
        base = optim.adam(learning_rate)
    elif name == "fused_adam":
        from distkeras_tpu_torch.ops.pallas_kernels import fused_adam

        base = fused_adam(learning_rate)
    elif name == "adagrad":
        base = optim.adagrad(learning_rate)
    elif name == "rmsprop":
        base = optim.rmsprop(learning_rate)
    elif name == "adadelta":
        base = optim.adadelta(learning_rate)
    elif name == "adamw":
        base = optim.adamw(learning_rate)
    elif name == "adamax":
        base = optim.adamax(learning_rate)
    elif name == "nadam":
        base = optim.nadam(learning_rate)
    else:
        raise ValueError(f"unknown worker_optimizer {worker_optimizer!r}")
    return _with_clipping(base, clipnorm, clipvalue)


def _as_cols(features_col) -> list[str]:
    return [features_col] if isinstance(features_col, str) \
        else list(features_col)


def _make_loss_step(spec: ModelSpec, loss_fn: Callable, n_feat: int,
                    loss_name=None):
    """``loss_step(params, nt, batch)`` for a batch ``(*features, label)``.
    When the spec carries a fused implementation of this loss name
    (``ModelSpec.fused_losses``), the step calls it instead of
    ``loss(y, apply(x))``."""
    fused = (spec.fused_losses or {}).get(loss_name)
    if fused is not None:
        def fused_step(params, nt, batch):
            feats, y = batch[:n_feat], batch[n_feat]
            x = feats[0] if n_feat == 1 else tuple(feats)
            return fused(params, nt, x, y, training=True)

        return fused_step

    def loss_step(params, nt, batch):
        feats, y = batch[:n_feat], batch[n_feat]
        x = feats[0] if n_feat == 1 else tuple(feats)
        out, new_nt = spec.apply(params, nt, x, training=True)
        return loss_fn(y, out), new_nt

    return loss_step


def _fits_device_budget(ds: Dataset, cols, budget_bytes: int) -> bool:
    row_bytes = sum(int(np.prod(ds[c].shape[1:])) * ds[c].dtype.itemsize
                    for c in cols)
    return len(ds) * row_bytes <= budget_bytes


def _as_spec(model) -> ModelSpec:
    if isinstance(model, ModelSpec):
        return model
    raise TypeError(
        f"model must be a distkeras_tpu_torch ModelSpec, got {type(model)} "
        f"(the Keras frontend is not ported yet: ROADMAP.md A9)")


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Abstract base trainer: ``train()``, ``record_training_start/end``,
    ``get_training_time``, ``get_history``."""

    def __init__(self, keras_model, loss="mse", worker_optimizer="sgd",
                 learning_rate: float = 0.01, seed: int = 0,
                 clipnorm=None, clipvalue=None):
        self.spec = _as_spec(keras_model)
        self.loss = loss
        self.loss_fn = get_loss(loss)
        self.worker_optimizer = worker_optimizer
        self.learning_rate = learning_rate
        self.clipnorm = clipnorm
        self.clipvalue = clipvalue
        self.seed = seed
        self.history = utils.History()
        self.timer = utils.Timer()
        self.trained_params_ = None
        self.trained_nt_ = None
        self.log_metrics = False
        self.metrics_: list[dict] = []

    def record_training_start(self):
        self.timer.start()

    def record_training_end(self):
        self.timer.stop()

    def get_training_time(self) -> float:
        return self.timer.elapsed()

    def get_history(self):
        return self.history

    def get_averaged_loss(self, last: int = 50) -> float:
        losses = [float(l) for l in self.history.losses()[-last:]]
        return float(np.mean(losses)) if losses else float("nan")

    def _epoch_metrics(self, epoch: int, rows: int, updates: int,
                       elapsed: float):
        rec = {"epoch": epoch, "samples_per_sec": round(rows / elapsed, 1),
               "updates_per_sec": round(updates / elapsed, 2),
               "wall_time": round(elapsed, 4)}
        self.metrics_.append(rec)
        self.history.append(**rec)
        if self.log_metrics:
            print(json.dumps({"metric": "epoch", **rec}), flush=True)

    def _materialize_history(self):
        """Device loss scalars → host floats, one record per window."""
        expanded = []
        for rec in self.history.records:
            if "losses" in rec:
                arr = rec["losses"].detach().cpu().numpy()
                expanded.extend({"loss": float(v), "epoch": rec.get("epoch")}
                                for v in arr)
            elif "loss" in rec:
                rec["loss"] = float(rec["loss"])
                expanded.append(rec)
            else:
                expanded.append(rec)
        self.history.records = expanded

    def train(self, dataset, shuffle: bool = False):
        raise NotImplementedError

    def _coerce_dataset(self, dataset) -> Dataset:
        if isinstance(dataset, Dataset):
            return dataset
        if isinstance(dataset, tuple) and len(dataset) == 2:
            return Dataset.from_arrays(*dataset)
        raise TypeError(f"expected Dataset or (features, labels), got "
                        f"{type(dataset)}")

    def _finalize(self, params, nt):
        self.trained_params_ = params
        self.trained_nt_ = nt
        return params


class DistributedTrainer(Trainer):
    """Shared machinery of the distributed trainers: ``num_workers,
    batch_size, features_col, label_col, num_epoch,
    communication_window``; the merge rule is the parameter server."""

    #: subclasses override
    default_window = 1

    def __init__(self, keras_model, loss="mse", worker_optimizer="sgd",
                 learning_rate: float = 0.01,
                 num_workers: int | None = None, batch_size: int = 32,
                 features_col="features", label_col: str = "label",
                 num_epoch: int = 1, communication_window: int | None = None,
                 seed: int = 0, device="cuda",
                 device_data: bool | None = None, prefetch: int = 1,
                 log_metrics: bool = False, clipnorm=None, clipvalue=None,
                 **later):
        _check_later(later)
        super().__init__(keras_model, loss, worker_optimizer,
                         learning_rate=learning_rate, seed=seed,
                         clipnorm=clipnorm, clipvalue=clipvalue)
        self.device = utils.resolve_device(device)
        self.num_workers = int(num_workers) if num_workers is not None else 1
        self.batch_size = int(batch_size)
        self.features_col: list[str] = _as_cols(features_col)
        self.label_col = label_col
        self.num_epoch = int(num_epoch)
        self.communication_window = int(
            communication_window if communication_window is not None
            else self.default_window)
        # device_data=True stages the epoch on the device and walks every
        # window there; None = auto (on when the epoch fits the budget).
        # Unshuffled, the two paths see the same data in the same order.
        self.device_data = device_data
        self.device_data_budget_bytes = 512 * 1024 * 1024
        self.prefetch = int(prefetch)
        self.log_metrics = bool(log_metrics)

    def allocate_merge_rule(self) -> MergeRule:
        raise NotImplementedError

    def allocate_optimizer(self):
        return resolve_optimizer(self.worker_optimizer, self.learning_rate,
                                 clipnorm=self.clipnorm,
                                 clipvalue=self.clipvalue)

    def _loss_step(self) -> Callable:
        return _make_loss_step(
            self.spec, self.loss_fn, len(self.features_col),
            self.loss if isinstance(self.loss, str) else None)

    def train(self, dataset, shuffle: bool = False):
        return self._train_collective(self._coerce_dataset(dataset), shuffle)

    def _train_collective(self, ds: Dataset, shuffle: bool):
        engine = LocalSGDEngine(
            spec=self.spec, loss_step=self._loss_step(),
            optimizer=self.allocate_optimizer(),
            rule=self.allocate_merge_rule(), device=self.device,
            num_workers=self.num_workers, window=self.communication_window,
            batch_size=self.batch_size)
        params, nt = self.spec.init(self.seed)
        state = engine.init_state(params, nt)
        cols = self.features_col + [self.label_col]
        use_resident = self.device_data
        if use_resident is None:
            use_resident = _fits_device_budget(
                ds, cols, self.device_data_budget_bytes)

        W, win, B = self.num_workers, self.communication_window, \
            self.batch_size
        self.record_training_start()
        if use_resident:
            staged = engine.stage_dataset(ds.worker_shards(
                W, B, win, cols, seed=self.seed if shuffle else None,
                cover_all=shuffle))
            n_windows = staged[0].shape[1] // (win * B)
            for epoch in range(self.num_epoch):
                seed = (self.seed + epoch) if shuffle else None
                t0 = time.perf_counter()
                state, losses = engine.run_epoch_resident(state, staged, seed)
                self.history.append(losses=losses, epoch=epoch)
                if self.log_metrics:
                    _synchronize(self.device)
                    self._epoch_metrics(epoch, W * n_windows * win * B,
                                        n_windows, time.perf_counter() - t0)
        else:
            for epoch in range(self.num_epoch):
                seed = (self.seed + epoch) if shuffle else None
                t0 = time.perf_counter()
                n_windows = 0
                batch_iter = ds.superbatches(W, B, win, cols, seed=seed)
                if self.prefetch:
                    batch_iter = prefetch_to_device(
                        batch_iter, engine.place_batch, depth=self.prefetch)
                for batch in batch_iter:
                    state, loss = engine.run_window(state, batch)
                    self.history.append(loss=loss, epoch=epoch)
                    n_windows += 1
                if self.log_metrics and n_windows:
                    _synchronize(self.device)
                    self._epoch_metrics(epoch, n_windows * W * win * B,
                                        n_windows, time.perf_counter() - t0)
        _synchronize(self.device)
        self.record_training_end()
        self.state_ = state
        self._materialize_history()
        return self._finalize(engine.center_params(state),
                              engine.worker_nt(state, 0))


class AsynchronousDistributedTrainer(DistributedTrainer):
    """Parity alias: the reference's base class of the five asynchronous
    algorithms."""


class SingleTrainer(DistributedTrainer):
    """One replica, no communication — the correctness oracle."""

    default_window = 1

    def __init__(self, keras_model, loss="mse", worker_optimizer="sgd",
                 learning_rate: float = 0.01, batch_size: int = 32,
                 features_col="features", label_col: str = "label",
                 num_epoch: int = 1, seed: int = 0, device="cuda",
                 prefetch: int = 1, clipnorm=None, clipvalue=None, **later):
        super().__init__(
            keras_model, loss, worker_optimizer, learning_rate=learning_rate,
            num_workers=1, batch_size=batch_size, features_col=features_col,
            label_col=label_col, num_epoch=num_epoch, communication_window=1,
            seed=seed, device=device, prefetch=prefetch, clipnorm=clipnorm,
            clipvalue=clipvalue, **later)

    def allocate_merge_rule(self) -> MergeRule:
        return ADAGMerge()  # with W=1 the merge is the identity fold


class ADAG(AsynchronousDistributedTrainer):
    """Asynchronous Distributed Adaptive Gradients: mean of the worker
    commits each window."""

    default_window = 12

    def allocate_merge_rule(self) -> MergeRule:
        return ADAGMerge()


class DOWNPOUR(AsynchronousDistributedTrainer):
    """Downpour SGD: workers push unscaled weight deltas."""

    default_window = 5

    def allocate_merge_rule(self) -> MergeRule:
        return DownpourMerge()


class AEASGD(AsynchronousDistributedTrainer):
    """Asynchronous Elastic-Averaging SGD with the elastic force ``rho``;
    workers keep their own variables between windows."""

    default_window = 32

    def __init__(self, keras_model, loss="mse", worker_optimizer="sgd",
                 learning_rate: float = 0.04, rho: float = 3.0, **kw):
        super().__init__(keras_model, loss, worker_optimizer,
                         learning_rate=learning_rate, **kw)
        self.rho = float(rho)

    def allocate_merge_rule(self) -> MergeRule:
        return ElasticAverageMerge(alpha=self.rho * self.learning_rate,
                                   num_workers=self.num_workers)


class EAMSGD(AEASGD):
    """Elastic averaging with Nesterov momentum on the worker update."""

    def __init__(self, keras_model, loss="mse", worker_optimizer="sgd",
                 learning_rate: float = 0.04, rho: float = 3.0,
                 momentum: float = 0.9, **kw):
        super().__init__(keras_model, loss, worker_optimizer,
                         learning_rate=learning_rate, rho=rho, **kw)
        self.momentum = float(momentum)

    def allocate_optimizer(self):
        return resolve_optimizer(self.worker_optimizer, self.learning_rate,
                                 momentum=self.momentum, nesterov=True,
                                 clipnorm=self.clipnorm,
                                 clipvalue=self.clipvalue)


class DynSGD(AsynchronousDistributedTrainer):
    """Staleness-aware dynamic-learning-rate SGD: commits scaled by
    ``1/(τ+1)`` (see ``DynSGDMerge``)."""

    default_window = 10

    def allocate_merge_rule(self) -> MergeRule:
        return DynSGDMerge()


__all__ = ["Trainer", "DistributedTrainer", "AsynchronousDistributedTrainer",
           "SingleTrainer", "ADAG", "DOWNPOUR", "AEASGD", "EAMSGD", "DynSGD",
           "resolve_optimizer"]
