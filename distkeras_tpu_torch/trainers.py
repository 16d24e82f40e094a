"""Trainer hierarchy — the reference's user-facing API, on PyTorch + CUDA.

Port of ``distkeras_tpu/trainers.py``: ``Trainer``, ``DistributedTrainer``,
``AsynchronousDistributedTrainer``, ``SingleTrainer`` and the five
algorithms ``ADAG, DOWNPOUR, AEASGD, EAMSGD, DynSGD`` with the reference's
constructor kwargs and defaults, and ``train(dataset, shuffle=False) ->
trained params``. On the collective backend (the default) ``train`` builds
a :class:`~distkeras_tpu_torch.parallel.LocalSGDEngine` and runs
communication windows whose merge rule is the parameter exchange; with
``backend="ps"`` it runs free-running worker threads against a parameter
server (:func:`~distkeras_tpu_torch.workers.run_async_training`) over the
in-process, socket, native or shared-memory transport, serially or with
one window's exchange in flight (``ps_pipeline_depth=1``), or an external
server at ``ps_host``. A Keras 3 model (torch backend) may stand in for a
``ModelSpec``: the trained weights are written back into it and ``train``
returns the same model.

``device="cuda"`` (the default) replaces the JAX package's ``mesh``: one
card holds all ``num_workers`` workers. ``validation_data`` scores a
held-out set after every epoch (after the run on the PS backend);
``profile_dir`` records a ``torch.profiler`` trace of the run. The PS
backend's resilience knobs (``retry_policy``, ``heartbeat_interval``,
``lease_timeout``, ``fault_plan``, ``worker_restart_budget``,
``worker_restart_delay``, ``tolerate_worker_failures``, ``ps_wal_dir``,
``ps_snapshot_every``, ``ps_wal_group_window``, ``ps_wal_group_interval``,
``ps_standby``, ``ps_failover_timeout``), its sharded center
(``ps_num_shards``, ``ps_chain_length``) and its elastic membership
(``elastic``, ``autoscale_target``, ``preempt_drain_timeout``,
``max_pool_size``) and its membership directory (``directory``,
``directory_standby``, ``ps_directory``) are the reference's, with its
checks.
``checkpoint_dir`` / ``checkpoint_every`` / ``resume`` /
``checkpoint_async`` snapshot the training state at epoch boundaries and
resume from it (``checkpoint.py``; on the PS backend at an epoch barrier
of the workers), also from a checkpoint the JAX package wrote (its center
carries over); ``ema_decay`` keeps a Polyak average of the center,
``ema_params_``, per window on the collective backend and per commit on
the PS. Kwargs whose machinery belongs to a later slice of the port (the
PS backend's observability knobs, meshes) are accepted by
name and raise ``NotImplementedError`` naming their ``ROADMAP.md`` item
when set to anything but their default: nothing is silently ignored.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Callable

import numpy as np
import torch

from distkeras_tpu_torch import optim, utils
from distkeras_tpu_torch.data import (
    Dataset,
    padded_chunks,
    prefetch_to_device,
)
from distkeras_tpu_torch.model import (
    ModelSpec,
    from_keras,
    keras_weights_to_model,
)
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distkeras_tpu_torch.parallel.compression import (
    Int8Codec,
    resolve_codec,
    validate_pull_compression,
)
from distkeras_tpu_torch.parallel.merge_rules import (
    ADAGMerge,
    DownpourMerge,
    DynSGDMerge,
    ElasticAverageMerge,
    MergeRule,
)
from distkeras_tpu_torch.parameter_servers import validate_ema_decay
from distkeras_tpu_torch.utils import tree_map

#: reference kwargs of later slices: name → (default, ROADMAP item)
_LATER = {
    "mesh": (None, "A12 (meshes across cards)"),
    "deploy_streamer": (None, "A13 (deploy streaming)"),
}
for _item, _knobs in {
        "A13 (observability: analyze and watch)": {
            "analyze": False, "watch": False, "watch_rules": None,
            "watch_dir": None, "watch_hook": None,
            "scrape_interval": 0.5}}.items():
    for _name, _default in _knobs.items():
        _LATER[_name] = (_default, _item)


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


def _as_spec(model) -> tuple[ModelSpec, object]:
    """A Keras model or a ModelSpec → ``(spec, the Keras model or None)``."""
    if isinstance(model, ModelSpec):
        return model, None
    if hasattr(model, "stateless_call"):
        return from_keras(model), model
    raise TypeError(
        f"model must be a Keras 3 model or a distkeras_tpu_torch ModelSpec, "
        f"got {type(model)}")


def _ema_tracking(center: dict, decay: float, use_resident: bool):
    """The window-by-window EMA of a streaming training loop: ``(use_resident,
    ema, ema_step)``. The resident input mode is overridden (with a
    warning): the EMA folds in every window's center, which a whole epoch
    walked on the device never hands back. ``ema`` is a copy of the center
    (the engine's states are its own); ``ema_step(ema, center)`` folds
    ``d·e + (1−d)·c`` in place over the leaves, in the reference's order:
    both products rounded, then their sum."""
    if use_resident:
        warnings.warn(
            "ema_decay tracks the center per step/window, which needs the "
            "streaming input path; overriding the resident input mode for "
            "this run", stacklevel=3)
        use_resident = False
    d = float(decay)
    ema = tree_map(lambda x: x.detach().clone(), center)

    def ema_step(ema, center):
        e = utils.flatten(ema)[0]
        torch._foreach_mul_(e, d)
        torch._foreach_add_(e, torch._foreach_mul(utils.flatten(center)[0],
                                                  1.0 - d))
        return ema

    return use_resident, ema, ema_step


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile_ctx(profile_dir, device: torch.device):
    """A ``torch.profiler`` context recording CPU (and, on the card, CUDA)
    activity for a training run, which writes a Chrome trace into
    ``profile_dir`` on exit; a no-op without a directory. The trace's path
    is in ``paths`` once the run ends."""
    if not profile_dir:
        return contextlib.nullcontext(), []
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(str(profile_dir), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    paths: list[str] = []

    def write(prof):
        path = os.path.join(str(profile_dir),
                            f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        paths.append(path)

    return profile(activities=activities, on_trace_ready=write), paths


class _Validator:
    """Held-out evaluation of ``validation_data`` (the JAX package's
    ``_Validator``): one masked forward per fixed-size chunk
    (``padded_chunks``), so ``val_loss`` is the exact mean over real rows
    for every named loss; ``val_accuracy`` when the label column is
    integer and the model emits a trailing class dimension."""

    def __init__(self, spec: ModelSpec, loss_fn: Callable, ds: Dataset,
                 features_col: list[str], label_col: str, batch_size: int,
                 device: torch.device, fused_loss=None):
        if len(ds) == 0:
            raise ValueError("validation_data has 0 rows")
        if fused_loss is not None and len(features_col) != 1:
            raise ValueError(
                "fused-loss validation supports a single features column")
        self.spec = spec
        self.ds = ds
        self.cols = list(features_col) + [label_col]
        self.bs = int(batch_size)
        self.n_feat = len(features_col)
        self.device = device
        self.fused_loss = fused_loss
        self.label_integer = np.issubdtype(
            np.asarray(ds[label_col][:1]).dtype, np.integer)
        self._per_row = torch.func.vmap(
            lambda yy, oo: loss_fn(yy[None], oo[None]))

    def _eval_chunk(self, params, nt, arrs, mask):
        feats, y = arrs[:self.n_feat], arrs[self.n_feat]
        x = feats[0] if self.n_feat == 1 else tuple(feats)
        if self.fused_loss is not None:
            loss = self.fused_loss(params, nt, x, y, training=False,
                                   mask=mask)[0]
            return loss * torch.sum(mask), -1.0
        out, _ = self.spec.apply(params, nt, x, False)
        loss_sum = torch.sum(self._per_row(y, out) * mask)
        if (self.label_integer and y.ndim == 1 and out.ndim == 2
                and out.shape[-1] >= 2):
            pred = torch.argmax(out, dim=-1).to(y.dtype)
            return loss_sum, torch.sum((pred == y).to(torch.float32) * mask)
        return loss_sum, -1.0

    def __call__(self, params, nt) -> dict:
        params = tree_map(lambda x: x.to(self.device), params)
        nt = tree_map(lambda x: x.to(self.device), nt)
        loss_sum, correct_sum, acc_defined = 0.0, 0.0, True
        cols = [np.asarray(self.ds[c]) for c in self.cols]
        with torch.no_grad():
            for chunk, real in padded_chunks(cols, self.bs):
                mask = torch.zeros(self.bs, dtype=torch.float32,
                                   device=self.device)
                mask[:real] = 1.0
                arrs = tuple(torch.as_tensor(c).to(self.device)
                             for c in chunk)
                ls, cs = self._eval_chunk(params, nt, arrs, mask)
                loss_sum += float(ls)
                cs = float(cs)
                if cs < 0:
                    acc_defined = False
                else:
                    correct_sum += cs
        n = len(self.ds)
        rec = {"val_loss": loss_sum / n}
        if acc_defined:
            rec["val_accuracy"] = correct_sum / n
        return rec


class Trainer:
    """Abstract base trainer: ``train()``, ``record_training_start/end``,
    ``get_training_time``, ``get_history``."""

    def __init__(self, keras_model, loss="mse", worker_optimizer="sgd",
                 learning_rate: float = 0.01, seed: int = 0,
                 clipnorm=None, clipvalue=None):
        self.spec, self.keras_model = _as_spec(keras_model)
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

    def _epoch_metrics(self, epoch: int | None, rows: int, updates: int,
                       elapsed: float, label: str = "epoch"):
        """Record (and with ``log_metrics`` print) throughput: per epoch, or
        for the whole run with ``epoch=None`` (the free-running PS)."""
        rec = {"samples_per_sec": round(rows / elapsed, 1),
               "updates_per_sec": round(updates / elapsed, 2),
               "wall_time": round(elapsed, 4)}
        if epoch is not None:
            rec = {"epoch": epoch, **rec}
        self.metrics_.append(rec)
        self.history.append(**rec)
        if self.log_metrics:
            print(json.dumps({"metric": label, **rec}), flush=True)

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
        """Keep the trained trees; a Keras model gets them written back and
        is returned itself."""
        self.trained_params_ = params
        self.trained_nt_ = nt
        if self.keras_model is not None:
            keras_weights_to_model(self.keras_model, params, nt)
            return self.keras_model
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
                 validation_data=None, profile_dir=None,
                 backend: str = "collective",
                 ps_transport: str = "inprocess", ps_port: int = 0,
                 ps_host: str | None = None, worker_id_offset: int = 0,
                 compression=None, pull_compression: str | None = None,
                 trace: bool = False, trace_dir=None,
                 trace_sample: float = 1.0, ps_fused_exchange: bool = True,
                 ps_pipeline_depth: int = 0,
                 tolerate_worker_failures: bool = False,
                 worker_restart_budget: int = 0,
                 worker_restart_delay: float = 0.0, retry_policy=None,
                 heartbeat_interval: float | None = None,
                 lease_timeout: float | None = None, fault_plan=None,
                 ps_wal_dir: str | None = None, ps_snapshot_every: int = 100,
                 ps_wal_group_window: int = 8,
                 ps_wal_group_interval: float = 0.25,
                 ps_standby: bool = False,
                 ps_failover_timeout: float | None = None,
                 ps_num_shards: int = 1, ps_chain_length: int = 1,
                 ema_decay: float | None = None, checkpoint_dir=None,
                 checkpoint_every: int = 1, resume: bool = False,
                 checkpoint_async: bool = False, elastic: bool = False,
                 autoscale_target=None, preempt_drain_timeout: float = 5.0,
                 max_pool_size: int | None = None, directory: bool = False,
                 directory_standby: bool = True, ps_directory=None,
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
        # a held-out Dataset (or (x, y)) scored after each epoch on the
        # collective backend and after the run on the PS backend
        self.validation_data = validation_data
        self.profile_dir = profile_dir
        self.profile_path_ = None
        if backend not in ("collective", "ps"):
            raise ValueError(
                f"backend must be 'collective' or 'ps', got {backend!r}")
        self.backend = backend
        # the PS transports: in-process (worker threads call the center),
        # TCP socket, the C++ native PS (flat f32 wire, a fold without the
        # GIL; native_ps.py) or shared-memory rings (colocated; shm.py)
        if ps_transport not in ("inprocess", "socket", "native", "shm"):
            raise ValueError(
                f"ps_transport must be 'inprocess', 'socket', 'native', or "
                f"'shm', got {ps_transport!r}")
        if ps_host is not None and ps_transport not in ("socket", "native"):
            raise ValueError(
                "ps_host requires ps_transport='socket' or 'native' (an "
                "external PS is only reachable over TCP; ps_transport='shm' "
                "is colocated-only: its rings live in this host's /dev/shm)")
        self.ps_transport = ps_transport
        self.ps_port = int(ps_port)
        self.ps_host = ps_host
        self.worker_id_offset = int(worker_id_offset)
        if compression is not None:
            codec = resolve_codec(compression)  # fail fast on bad values
            if backend != "ps":
                raise ValueError("compression applies to backend='ps' only "
                                 "(collective merges cross no wire)")
            if ps_transport == "native" and type(codec) is not Int8Codec:
                raise ValueError(
                    "ps_transport='native' supports the stock "
                    "compression='int8' only (its C++ fold is that codec); "
                    "use 'socket' for other codecs")
        self.compression = compression
        if pull_compression is not None:
            validate_pull_compression(pull_compression)
            if backend != "ps":
                raise ValueError("pull_compression applies to backend='ps' "
                                 "only (collective merges cross no wire)")
        self.pull_compression = pull_compression
        self.trace = bool(trace)
        self.trace_dir = trace_dir
        self.trace_sample = float(trace_sample)
        self.trace_path_ = None
        # ps_fused_exchange: each window's commit + pull in one EXCHANGE
        # round trip. ps_pipeline_depth: 0 the serial loop; 1 launches
        # window N+1 on the card, then exchanges window N on the host while
        # it runs, the delta one window stale and priced into DynSGD's τ
        # through the exchange's lag flag
        self.ps_fused_exchange = bool(ps_fused_exchange)
        self.ps_pipeline_depth = int(ps_pipeline_depth)
        if self.ps_pipeline_depth not in (0, 1):
            raise ValueError(
                f"ps_pipeline_depth must be 0 (serial) or 1 (one window in "
                f"flight), got {ps_pipeline_depth}: one exchange already "
                f"hides behind one window, and each extra window adds "
                f"DynSGD staleness")
        if self.ps_pipeline_depth and backend != "ps":
            raise ValueError(
                "ps_pipeline_depth applies to backend='ps' only (the "
                "collective backend has no worker-hosted exchange loop)")
        if self.ps_pipeline_depth and not self.ps_fused_exchange:
            raise ValueError(
                "ps_pipeline_depth >= 1 requires ps_fused_exchange=True: "
                "only the fused EXCHANGE action carries the lag flag that "
                "prices the pipeline's one-window staleness into DynSGD τ")
        if self.ps_pipeline_depth and compression is not None \
                and ps_transport == "native":
            raise ValueError(
                "ps_pipeline_depth >= 1 with compression on "
                "ps_transport='native' is unsupported: the segmented int8 "
                "commit wire has no fused EXCHANGE frame, and its two-trip "
                "fallback cannot carry the pipeline's lag pricing; use "
                "ps_transport='socket' or drop one of the two")
        if not self.ps_fused_exchange and backend != "ps":
            raise ValueError("ps_fused_exchange applies to backend='ps' only")
        # the Polyak average of the center (per window on the collective
        # backend, per commit on the PS), in ema_params_ beside the raw
        # center; EMA state is not checkpointed: a resume restarts it from
        # the restored center
        self.ema_decay = validate_ema_decay(ema_decay)
        if self.ema_decay is not None and backend == "ps" \
                and ps_host is not None:
            raise ValueError(
                "ema_decay with an external ps_host must be configured on "
                "the PS owner's server (the center lives there)")
        self.ema_params_ = None
        # epoch checkpoints: the full training state every
        # checkpoint_every epochs and the last; checkpoint_async writes on
        # a background thread
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.resume = bool(resume)
        self.checkpoint_async = bool(checkpoint_async)
        self._async_ckpt = None
        self.checkpoint_ms_: list[float] = []
        if self.ps_pipeline_depth and checkpoint_dir and not elastic:
            raise ValueError(
                "ps_pipeline_depth >= 1 is incompatible with epoch-barrier "
                "checkpointing (checkpoint_dir): the barrier would snapshot "
                "with one window still un-exchanged; drop checkpoint_dir or "
                "run depth 0")
        self.ps_stats_ = None
        self._init_directory(backend, ps_transport, ps_host, directory,
                             directory_standby, ps_directory,
                             ps_num_shards > 1 or ps_chain_length > 1
                             or ps_standby or ps_wal_dir is not None)
        self._init_resilience(
            backend, ps_transport, ps_host, tolerate_worker_failures,
            worker_restart_budget, worker_restart_delay, retry_policy,
            heartbeat_interval, lease_timeout, fault_plan, ps_wal_dir,
            ps_snapshot_every, ps_wal_group_window, ps_wal_group_interval,
            ps_standby, ps_failover_timeout, ps_num_shards, ps_chain_length)
        self._init_elastic(backend, ps_host, elastic, autoscale_target,
                           preempt_drain_timeout, max_pool_size)

    def _init_directory(self, backend, ps_transport, ps_host, directory,
                        directory_standby, ps_directory,
                        owner_knobs: bool) -> None:
        """The membership directory's knobs (``directory/``), checked as
        the reference checks them:

        - ``directory=True``: host the replicated directory beside the PS
          fleet (a WAL-backed ``DirectoryServer`` and, unless
          ``directory_standby=False``, a standby fed by its stream),
          mapping ``("ps", "shard-NN")`` to the endpoint, fence epoch and
          lease. Every worker's client, joiners included, is minted from a
          directory lookup; failover supervisors publish a promotion there
          before fencing the old primary, and their healthy pings renew
          the lease;
        - ``ps_directory``: seeds (``"host:port"`` or ``(host, port)``,
          one or a list) of an external fleet's directory, which this
          trainer discovers the fleet through instead of ``ps_host``.

        ``owner_knobs`` says whether a knob of the fleet's owner
        (``ps_num_shards``, ``ps_chain_length``, ``ps_standby``,
        ``ps_wal_dir``) is set."""
        self.directory = bool(directory)
        self.directory_standby = bool(directory_standby)
        self.ps_directory = ps_directory
        if not (self.directory or ps_directory is not None):
            return
        if backend != "ps":
            raise ValueError(
                "directory/ps_directory apply to backend='ps' only")
        if self.directory and ps_transport != "socket":
            raise ValueError(
                "directory=True requires ps_transport='socket' (the "
                "directory registers TCP endpoints; the in-process and shm "
                "transports have no cross-host endpoints to publish)")
        if self.directory and ps_directory is not None:
            raise ValueError(
                "directory=True hosts the directory; ps_directory= "
                "discovers an external one: set exactly one")
        if ps_host is not None:
            raise ValueError(
                "directory/ps_directory replace ps_host: endpoints come "
                "from the directory, not constructor arguments")
        if ps_directory is not None and owner_knobs:
            raise ValueError(
                "ps_directory discovers a fleet some other process hosts: "
                "the server-side knobs (ps_num_shards, ps_chain_length, "
                "ps_standby, ps_wal_dir) belong to that owner")
        if ps_directory is not None and ps_transport != "socket":
            raise ValueError(
                "ps_directory requires ps_transport='socket' (the "
                "discovered endpoints are TCP servers)")

    def _init_elastic(self, backend, ps_host, elastic, autoscale_target,
                      preempt_drain_timeout, max_pool_size) -> None:
        """The PS backend's elastic membership (``resilience/elastic.py``),
        checked as the reference checks it:

        - ``elastic=True``: a dynamic pool. Data shards are window blocks
          leased from a shared assigner (every example once an epoch
          across membership changes), workers join live, and a preempted
          worker drains (finishes its window, commits, hands its blocks
          back, deregisters) instead of dying into a restart budget;
        - ``autoscale_target``: the rounds/s the autoscaler tracks, or an
          ``ElasticPolicy``: under target it joins workers up to
          ``max_pool_size``, over target (or for a persistent straggler)
          it drains one;
        - ``preempt_drain_timeout``: the seconds a preempted worker has to
          drain before it is force-drained;
        - ``max_pool_size``: the ceiling of joins (default twice
          ``num_workers``)."""
        self.elastic = bool(elastic)
        self.autoscale_target = autoscale_target
        self.preempt_drain_timeout = float(preempt_drain_timeout)
        self.max_pool_size = (None if max_pool_size is None
                              else int(max_pool_size))
        if self.elastic and backend != "ps":
            raise ValueError(
                "elastic=True applies to backend='ps' only (the collective "
                "backend is one fixed SPMD program)")
        if self.elastic and ps_host is not None:
            raise ValueError(
                "elastic=True manages the pool this trainer hosts; an "
                "external ps_host owner runs its own elastic coordinator")
        if self.elastic and self.worker_restart_budget:
            raise ValueError(
                "elastic=True and worker_restart_budget are mutually "
                "exclusive: elastic membership replaces restart-in-place (a "
                "preempted or dead worker's blocks go back to the pool; "
                "scale-up goes through the live-join path)")
        if not self.elastic:
            if autoscale_target is not None:
                raise ValueError(
                    "autoscale_target requires elastic=True (the autoscaler "
                    "grows and shrinks the pool through the live-join and "
                    "drain paths)")
            if max_pool_size is not None:
                raise ValueError("max_pool_size requires elastic=True")
        if isinstance(autoscale_target, (int, float)) \
                and autoscale_target <= 0:
            raise ValueError(f"autoscale_target must be positive, got "
                             f"{autoscale_target}")
        if self.preempt_drain_timeout <= 0:
            raise ValueError(f"preempt_drain_timeout must be positive, got "
                             f"{preempt_drain_timeout}")
        if self.max_pool_size is not None \
                and self.max_pool_size < self.num_workers:
            raise ValueError(
                f"max_pool_size ({max_pool_size}) must be >= num_workers "
                f"({self.num_workers})")

    def _init_resilience(self, backend, ps_transport, ps_host,
                         tolerate_worker_failures, worker_restart_budget,
                         worker_restart_delay, retry_policy,
                         heartbeat_interval, lease_timeout, fault_plan,
                         ps_wal_dir, ps_snapshot_every, ps_wal_group_window,
                         ps_wal_group_interval, ps_standby,
                         ps_failover_timeout, ps_num_shards,
                         ps_chain_length) -> None:
        """The PS backend's resilience knobs (``resilience/``), checked as
        the reference checks them:

        - ``tolerate_worker_failures``: survivors finish the run when a
          worker dies (it still fails if every worker dies);
        - ``worker_restart_budget=K``: a dead worker restarts up to K
          times from a fresh center pull, after ``worker_restart_delay``
          seconds;
        - ``retry_policy``: a ``RetryPolicy``; pulls and commits that hit
          transient transport failures reconnect and retry, commits
          carrying per-worker seqnos the server folds once;
        - ``heartbeat_interval``: workers renew a lease at window
          boundaries; ``lease_timeout`` (default 5× the interval) evicts
          a silent worker, surfaced in ``ps_stats_`` and fed into DynSGD's
          staleness;
        - ``fault_plan``: a ``FaultPlan`` (the caller installs its wire
          hook with ``with plan:``; kills and stragglers hook the worker
          loop here);
        - ``ps_wal_dir``: the write-ahead log and snapshots, on every
          transport (a directory that holds a log is recovered);
          ``ps_snapshot_every`` commits between snapshots;
          ``ps_wal_group_window``: commits an fsync groups (their ACKs
          wait for it; 1 flushes each record and fsyncs periodically, 0
          fsyncs on the interval only); ``ps_wal_group_interval`` seconds
          bound the durability window in every mode;
        - ``ps_standby`` (socket): a warm replica streams every applied
          commit and is promoted, with a fencing-epoch bump, when the
          primary's lease lapses (``ps_failover_timeout`` seconds without
          a ping; default ``lease_timeout``, else 2 s);
        - ``ps_num_shards``: the center split across N PS shards by
          byte-weighted consistent hashing over leaf paths (``sharding/``),
          each worker fanning its exchanges out to every shard; bit-
          identical to the single PS (same fold order and τ a shard);
        - ``ps_chain_length`` (socket): replicas a shard INCLUDING the
          primary, chained (each link streams every record to the next;
          a shard's failover promotes down its chain). A chain of two on
          one shard is the ``ps_standby`` topology, which it subsumes."""
        self.tolerate_worker_failures = bool(tolerate_worker_failures)
        self.worker_restart_budget = int(worker_restart_budget)
        if self.worker_restart_budget < 0:
            raise ValueError(f"worker_restart_budget must be >= 0, got "
                             f"{worker_restart_budget}")
        self.worker_restart_delay = float(worker_restart_delay)
        self.retry_policy = retry_policy
        if heartbeat_interval is not None and heartbeat_interval <= 0:
            raise ValueError(f"heartbeat_interval must be positive, got "
                             f"{heartbeat_interval}")
        self.heartbeat_interval = heartbeat_interval
        if lease_timeout is not None and lease_timeout <= 0:
            raise ValueError(
                f"lease_timeout must be positive, got {lease_timeout}")
        self.lease_timeout = lease_timeout
        self.fault_plan = fault_plan
        self.ps_wal_dir = ps_wal_dir
        self.ps_snapshot_every = int(ps_snapshot_every)
        if self.ps_snapshot_every <= 0:
            raise ValueError(f"ps_snapshot_every must be positive, got "
                             f"{ps_snapshot_every}")
        self.ps_wal_group_window = int(ps_wal_group_window)
        if self.ps_wal_group_window < 0:
            raise ValueError(
                f"ps_wal_group_window must be >= 0 (0 = time-bounded "
                f"async, 1 = per-record flush, N = group size), got "
                f"{ps_wal_group_window}")
        self.ps_wal_group_interval = float(ps_wal_group_interval)
        if self.ps_wal_group_interval <= 0:
            raise ValueError(f"ps_wal_group_interval must be positive, got "
                             f"{ps_wal_group_interval}")
        self.ps_standby = bool(ps_standby)
        if ps_failover_timeout is not None and ps_failover_timeout <= 0:
            raise ValueError(f"ps_failover_timeout must be positive, got "
                             f"{ps_failover_timeout}")
        self.ps_failover_timeout = ps_failover_timeout
        if self.ps_standby and ps_transport != "socket":
            raise ValueError(
                "ps_standby requires ps_transport='socket' (the replica is "
                "a second socket server; the in-process PS shares the "
                "trainer's fate and the native PS has no replication "
                "stream)")
        if self.ps_standby and ps_host is not None:
            raise ValueError(
                "ps_standby applies to the PS this trainer hosts; an "
                "external ps_host owner runs its own standby")
        self.ps_num_shards = int(ps_num_shards)
        if self.ps_num_shards < 1:
            raise ValueError(
                f"ps_num_shards must be >= 1, got {ps_num_shards}")
        self.ps_chain_length = int(ps_chain_length)
        if self.ps_chain_length < 1:
            raise ValueError(
                f"ps_chain_length must be >= 1, got {ps_chain_length}")
        sharded = self.ps_num_shards > 1 or self.ps_chain_length > 1
        if self.ps_chain_length > 1 and ps_transport != "socket":
            raise ValueError(
                "ps_chain_length > 1 requires ps_transport='socket' (chain "
                "replicas are socket servers; the in-process PS shares the "
                "trainer's fate and the native PS has no replication "
                "stream)")
        if sharded and ps_host is not None:
            raise ValueError(
                "ps_num_shards/ps_chain_length apply to the center this "
                "trainer hosts; an external ps_host owner runs its own "
                "sharded group")
        if sharded and self.ps_standby:
            raise ValueError(
                "ps_standby is the single hot standby; with ps_num_shards/"
                "ps_chain_length use ps_chain_length >= 2 (chain "
                "replication subsumes it)")
        if fault_plan is not None and getattr(
                fault_plan, "kill_ps_after_commits", None) is not None:
            # a PS kill with no recovery path would crash the run after
            # every worker spent its retry deadline, and off the socket
            # transport nothing would fire it
            if ps_transport != "socket":
                raise ValueError(
                    "fault_plan.kill_ps_after_commits requires "
                    "ps_transport='socket' (the in-process PS shares the "
                    "trainer's fate; the native PS has no kill/failover "
                    "wiring)")
            if ps_host is not None:
                raise ValueError(
                    "fault_plan.kill_ps_after_commits applies to the PS "
                    "this trainer hosts, not an external ps_host")
            if ps_wal_dir is None and not self.ps_standby \
                    and self.ps_chain_length <= 1:
                raise ValueError(
                    "fault_plan.kill_ps_after_commits needs a recovery "
                    "path: set ps_wal_dir (restart-in-place), "
                    "ps_standby=True, or ps_chain_length >= 2 (chain "
                    "failover)")
            ks = getattr(fault_plan, "kill_shard_id", None)
            if ks is not None and ks >= self.ps_num_shards:
                raise ValueError(
                    f"fault_plan.kill_shard_id={ks} is out of range for "
                    f"ps_num_shards={self.ps_num_shards}")
        if fault_plan is not None and getattr(
                fault_plan, "has_directory_events", False) \
                and not self.directory:
            raise ValueError(
                "fault_plan carries directory kill/partition events but "
                "directory=True is not set: nothing would ever consult "
                "them, so the chaos would silently test nothing")
        if backend != "ps" and (
                worker_restart_budget or retry_policy is not None
                or heartbeat_interval is not None or lease_timeout is not None
                or fault_plan is not None or ps_wal_dir is not None
                or ps_standby or sharded):
            raise ValueError(
                "the resilience knobs (worker_restart_budget, retry_policy, "
                "heartbeat_interval, lease_timeout, fault_plan, ps_wal_dir, "
                "ps_standby, ps_num_shards, ps_chain_length) apply to "
                "backend='ps' only (the collective backend is one SPMD "
                "program)")
        self.resilience_stats_ = None

    def allocate_merge_rule(self) -> MergeRule:
        raise NotImplementedError

    def _dispatch_checkpoint(self, payload, epoch: int) -> None:
        """One checkpoint write, on a background thread with
        ``checkpoint_async`` (its host copy on this one), else here."""
        from distkeras_tpu_torch import checkpoint as ckpt

        if self.checkpoint_async:
            if self._async_ckpt is None:
                self._async_ckpt = ckpt.AsyncCheckpointer()
            self._async_ckpt.save(self.checkpoint_dir, payload, step=epoch)
        else:
            ckpt.save_checkpoint(self.checkpoint_dir, payload, step=epoch)

    def _finish_checkpoints(self) -> None:
        """Join an in-flight async save and re-raise its failure (from a
        ``finally``: an aborted run neither drops nor hides one)."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    def _maybe_checkpoint(self, state, epoch: int) -> None:
        """The epoch's checkpoint when the cadence calls for one; its time
        on this thread (the whole save, or the async host copy) lands in
        ``checkpoint_ms_``."""
        from distkeras_tpu_torch import checkpoint as ckpt

        if self.checkpoint_dir and ckpt.should_checkpoint(
                epoch, self.checkpoint_every, self.num_epoch):
            t0 = time.perf_counter()
            self._dispatch_checkpoint({"state": state, "epoch": epoch},
                                      epoch)
            self.checkpoint_ms_.append(1e3 * (time.perf_counter() - t0))

    def allocate_optimizer(self):
        return resolve_optimizer(self.worker_optimizer, self.learning_rate,
                                 clipnorm=self.clipnorm,
                                 clipvalue=self.clipvalue)

    def _loss_step(self) -> Callable:
        return _make_loss_step(
            self.spec, self.loss_fn, len(self.features_col),
            self.loss if isinstance(self.loss, str) else None)

    def train(self, dataset, shuffle: bool = False):
        ds = self._coerce_dataset(dataset)
        if self.backend == "ps" and self.checkpoint_async:
            raise ValueError(
                "checkpoint_async is not supported on backend='ps' (the "
                "hogwild workers checkpoint at a cross-thread barrier); use "
                "the collective backend or synchronous checkpoints")
        ctx, paths = _profile_ctx(self.profile_dir, self.device)
        try:
            with ctx:
                if self.backend == "ps":
                    return self._train_ps(ds, shuffle)
                return self._train_collective(ds, shuffle)
        finally:
            if paths:
                self.profile_path_ = paths[-1]
            # an aborted run neither drops an in-flight save nor hides its
            # failure
            self._finish_checkpoints()

    def _make_validator(self):
        """The ``validation_data`` evaluator, or None; built before training
        starts, so a malformed set fails fast."""
        if self.validation_data is None:
            return None
        return _Validator(
            self.spec, self.loss_fn,
            self._coerce_dataset(self.validation_data), self.features_col,
            self.label_col, self.batch_size, self.device,
            fused_loss=(self.spec.fused_losses or {}).get(self.loss))

    def _validate_epoch(self, validator, params, nt, epoch):
        rec = validator(params, nt)
        rec = {"epoch": epoch, **rec} if epoch is not None else dict(rec)
        self.metrics_.append(rec)
        self.history.append(**rec)
        if self.log_metrics:
            print(json.dumps({"metric": "validation", **rec}), flush=True)

    def _train_ps(self, ds: Dataset, shuffle: bool):
        """``backend="ps"``: worker threads against a parameter server; the
        history holds one record per worker window."""
        from distkeras_tpu_torch.workers import run_async_training

        validator = self._make_validator()
        self.record_training_start()
        t0 = time.perf_counter()
        center, nt, history = run_async_training(self, ds, shuffle)
        elapsed = time.perf_counter() - t0
        self.record_training_end()
        for rec in history:
            self.history.append(**rec)
        if self.log_metrics and elapsed > 0:
            # hogwild epochs overlap freely: whole-run throughput
            n_updates = sum(1 for r in history if "loss" in r)
            rows = n_updates * self.communication_window * self.batch_size
            self._epoch_metrics(None, rows, n_updates, elapsed, label="run")
        params = tree_map(lambda c: torch.from_numpy(np.asarray(c)), center)
        nt = tree_map(lambda x: torch.from_numpy(np.asarray(x)), nt)
        if self.ema_params_ is not None:
            self.ema_params_ = tree_map(
                lambda c: torch.from_numpy(np.asarray(c)), self.ema_params_)
        if validator is not None:
            self._validate_epoch(validator, params, nt, None)
        return self._finalize(params, nt)

    def _train_collective(self, ds: Dataset, shuffle: bool):
        engine = LocalSGDEngine(
            spec=self.spec, loss_step=self._loss_step(),
            optimizer=self.allocate_optimizer(),
            rule=self.allocate_merge_rule(), device=self.device,
            num_workers=self.num_workers, window=self.communication_window,
            batch_size=self.batch_size)
        params, nt = self.spec.init(self.seed)
        state = engine.init_state(params, nt)
        self.checkpoint_ms_ = []
        start_epoch = 0
        if self.checkpoint_dir and self.resume:
            state, start_epoch = self._resume_collective(engine, state, nt)
        cols = self.features_col + [self.label_col]
        use_resident = self.device_data
        if use_resident is None:
            use_resident = _fits_device_budget(
                ds, cols, self.device_data_budget_bytes)
        ema = ema_step = None
        if self.ema_decay is not None:
            use_resident, ema, ema_step = _ema_tracking(
                state.center, self.ema_decay, use_resident)

        W, win, B = self.num_workers, self.communication_window, \
            self.batch_size
        validator = self._make_validator()
        worker0 = lambda st: tree_map(lambda x: x[0], st.nt)
        self.record_training_start()
        if use_resident:
            staged = engine.stage_dataset(ds.worker_shards(
                W, B, win, cols, seed=self.seed if shuffle else None,
                cover_all=shuffle))
            n_windows = staged[0].shape[1] // (win * B)
            for epoch in range(start_epoch, self.num_epoch):
                seed = (self.seed + epoch) if shuffle else None
                t0 = time.perf_counter()
                state, losses = engine.run_epoch_resident(state, staged, seed)
                self.history.append(losses=losses, epoch=epoch)
                if self.log_metrics:
                    _synchronize(self.device)
                    self._epoch_metrics(epoch, W * n_windows * win * B,
                                        n_windows, time.perf_counter() - t0)
                if validator is not None:
                    self._validate_epoch(validator, state.center,
                                         worker0(state), epoch)
                self._maybe_checkpoint(state, epoch)
        else:
            for epoch in range(start_epoch, self.num_epoch):
                seed = (self.seed + epoch) if shuffle else None
                t0 = time.perf_counter()
                n_windows = 0
                batch_iter = ds.superbatches(W, B, win, cols, seed=seed)
                if self.prefetch:
                    batch_iter = prefetch_to_device(
                        batch_iter, engine.place_batch, depth=self.prefetch)
                for batch in batch_iter:
                    state, loss = engine.run_window(state, batch)
                    if ema_step is not None:
                        ema = ema_step(ema, state.center)
                    self.history.append(loss=loss, epoch=epoch)
                    n_windows += 1
                if self.log_metrics and n_windows:
                    _synchronize(self.device)
                    self._epoch_metrics(epoch, n_windows * W * win * B,
                                        n_windows, time.perf_counter() - t0)
                if validator is not None:
                    self._validate_epoch(validator, state.center,
                                         worker0(state), epoch)
                self._maybe_checkpoint(state, epoch)
        _synchronize(self.device)
        if ema is not None:
            self.ema_params_ = tree_map(lambda x: x.detach().cpu(), ema)
        self._finish_checkpoints()
        self.record_training_end()
        self.state_ = state
        self._materialize_history()
        return self._finalize(engine.center_params(state),
                              engine.worker_nt(state, 0))


    def _resume_collective(self, engine, state, nt):
        """``(state, start_epoch)`` from the newest checkpoint, if there is
        one. The same worker count resumes exactly (``init_state_from``);
        another count, or a checkpoint the JAX package wrote (its optax
        moments have no counterpart here), resumes elastically: the center
        re-broadcast to fresh workers, the window count kept."""
        from distkeras_tpu_torch import checkpoint as ckpt
        from distkeras_tpu_torch.convert import center_from_jax

        if ckpt.latest_step(self.checkpoint_dir) is None:
            return state, 0
        payload, _, origin = ckpt.load_checkpoint(self.checkpoint_dir)
        host = payload["state"]
        saved = host if origin == "jax" else vars(host)
        leaves = utils.flatten(saved["workers"])[0]
        ckpt_w = leaves[0].shape[0] if leaves else self.num_workers
        if origin == "port" and ckpt_w == self.num_workers:
            state = engine.init_state_from(host)
        else:
            ckpt.warn_elastic_resume(ckpt_w, self.num_workers)
            if origin == "jax":
                center = center_from_jax(saved["center"], self.spec)
            else:
                center = saved["center"]
                nt = tree_map(lambda x: x[0], saved["nt"])
            state = engine.init_state(center, nt)
            state.step = int(np.asarray(saved["step"]))
        return state, int(np.asarray(payload["epoch"])) + 1


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
                 prefetch: int = 1, ema_decay: float | None = None,
                 clipnorm=None, clipvalue=None, **later):
        super().__init__(
            keras_model, loss, worker_optimizer, learning_rate=learning_rate,
            num_workers=1, batch_size=batch_size, features_col=features_col,
            label_col=label_col, num_epoch=num_epoch, communication_window=1,
            seed=seed, device=device, prefetch=prefetch, ema_decay=ema_decay,
            clipnorm=clipnorm, clipvalue=clipvalue, **later)

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
