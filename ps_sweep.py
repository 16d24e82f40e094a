#!/usr/bin/env python3
"""Config 3's parameter-server path (CIFAR-10 VGG-small under DOWNPOUR,
``bench.py:316-324``) at several communication windows and learning rates,
in the port or in the JAX package; or the MNIST twin's MLP on the same
path (``--model mlp``), small enough for both packages on the CPU.

    python3 ps_sweep.py [--package torch|jax] [--device cuda|cpu]
        [--model vgg_small|mlp] [--dtype bf16|f32] [--batch B] [--steps N]
        [--epochs E] [--seeds S,S,...] [--depth 0|1]
        [--algorithm downpour|dynsgd]
        [--transport socket|native|shm|inprocess] [--aligned-start]
        WINDOW:LR [WINDOW:LR ...]

Each ``WINDOW:LR`` is one run a seed: DOWNPOUR (or DynSGD, the
staleness-priced rule, with ``--algorithm dynsgd``), 4 worker threads
through the trainer's own PS (``backend="ps"``, ``ps_transport`` the
``--transport``, socket by default; ``ps_pipeline_depth`` the
``--depth``, 0 by default), E
epochs (2 by default) of N steps of B rows a worker (so N / WINDOW windows
a worker an epoch; the defaults, B = 512 and N = 32, are
``chip_smoke.py``'s 65536 rows an epoch), Adam (the port's ``fused_adam``,
the JAX package's ``adam``: the same update), the trainer's ``seed`` from
``--seeds`` (its init and shuffle; the data stay the same), then held-out
accuracy on 2048 stand-in rows through the package's ``ModelPredictor``
and ``AccuracyEvaluator``. Prints one JSON line a run: the epochs' mean
losses (over every worker, and each worker's own), the accuracy, the
commits, and on the in-process transport the τ of every commit (mean,
max and histogram). ``--aligned-start`` holds
each worker's first exchange until every worker has reached its own, so
no worker commits alone while the others still start up (the JAX
package's workers each compile their window first, and stagger). Gates
nothing: ``chip_smoke.py`` holds config 3 to its gates.

``--package torch`` (the default) imports nothing of JAX; ``--package
jax`` runs the reference on the CPU, where XLA's bf16 convolutions are
slow: ``--dtype f32`` with a smaller ``--batch`` keeps a run to minutes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

WORKERS, TEST = 4, 2048
_DATA = {"vgg_small": "cifar10", "mlp": "mnist"}
_TRAINERS = {"downpour": "DOWNPOUR", "dynsgd": "DynSGD"}


def _modules(package: str, device: str, model: str, algorithm: str):
    """The package's (dataset, model, trainer class, ModelPredictor,
    AccuracyEvaluator, trainer kwargs, predictor kwargs, float32 dtype,
    workers module)."""
    if package == "jax":
        os.environ.setdefault("XLA_FLAGS",
                              f"--xla_force_host_platform_device_count="
                              f"{WORKERS}")
        import jax

        if device == "cpu":
            jax.config.update("jax_platforms", "cpu")
        from distkeras_tpu import datasets, models, trainers
        from distkeras_tpu import workers as workers_mod
        from distkeras_tpu.evaluators import AccuracyEvaluator
        from distkeras_tpu.predictors import ModelPredictor

        return (getattr(datasets, _DATA[model]), getattr(models, model),
                getattr(trainers, _TRAINERS[algorithm]), ModelPredictor,
                AccuracyEvaluator, {"worker_optimizer": "adam"}, {},
                jax.numpy.float32, workers_mod)
    import torch

    from distkeras_tpu_torch import datasets, models, trainers
    from distkeras_tpu_torch import workers as workers_mod
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.predictors import ModelPredictor

    return (getattr(datasets, _DATA[model]), getattr(models, model),
            getattr(trainers, _TRAINERS[algorithm]), ModelPredictor,
            AccuracyEvaluator, {"worker_optimizer": "fused_adam",
                                "device": device},
            {"device": device}, torch.float32, workers_mod)


@contextlib.contextmanager
def _inprocess_servers(workers_mod):
    """Record the in-process ``ParameterServer`` the trainer builds inside
    the block, to read its τ after the run."""
    cls = workers_mod.ParameterServer
    made = []

    class Recording(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    workers_mod.ParameterServer = Recording
    try:
        yield made
    finally:
        workers_mod.ParameterServer = cls


@contextlib.contextmanager
def _aligned_start(workers_mod):
    """Hold every worker's first exchange at one barrier of WORKERS."""
    cls = workers_mod.AsyncWorker
    exchange = cls._do_exchange
    barrier = threading.Barrier(WORKERS)
    first = set()
    lock = threading.Lock()

    def held(self, *args, **kw):
        with lock:
            wait = self.worker_id not in first
            first.add(self.worker_id)
        if wait:
            barrier.wait(timeout=600)
        return exchange(self, *args, **kw)

    cls._do_exchange = held
    try:
        yield
    finally:
        cls._do_exchange = exchange


def run(mods, window: int, lr: float, batch: int, steps: int,
        f32: bool, transport: str = "socket", depth: int = 0,
        epochs: int = 2, seed: int = 0, aligned: bool = False) -> dict:
    (dataset, model, trainer_cls, ModelPredictor, AccuracyEvaluator,
     train_kw, predict_kw, float32, workers_mod) = mods
    train, test = dataset(n_train=WORKERS * batch * steps, n_test=TEST)
    spec = model(dtype=float32) if f32 else model()
    t = trainer_cls(spec, loss="sparse_softmax_cross_entropy",
                 learning_rate=lr, num_workers=WORKERS, batch_size=batch,
                 communication_window=window, num_epoch=epochs,
                 backend="ps", ps_transport=transport,
                 ps_pipeline_depth=depth, seed=seed, **train_kw)
    with contextlib.ExitStack() as stack:
        servers = (stack.enter_context(_inprocess_servers(workers_mod))
                   if transport == "inprocess" else [])
        if aligned:
            stack.enter_context(_aligned_start(workers_mod))
        t0 = time.perf_counter()
        center = t.train(train, shuffle=True)
        wall = time.perf_counter() - t0
    taus = servers[0].recent_staleness() if servers else []
    state = getattr(t, "trained_nt_", None)
    if state is not None and "device" not in predict_kw:
        predict_kw = {**predict_kw, "state": state}
    acc = AccuracyEvaluator().evaluate(
        ModelPredictor(spec, center, **predict_kw).predict(test))
    by_epoch: dict = {}
    by_worker: dict = {}
    for r in t.history.records:
        if "loss" in r:
            by_epoch.setdefault(r.get("epoch"), []).append(float(r["loss"]))
            by_worker.setdefault(r.get("worker"), {}).setdefault(
                r.get("epoch"), []).append(float(r["loss"]))
    return dict(algorithm=trainer_cls.__name__, transport=transport,
                pipeline_depth=depth, window=window,
                lr=lr, batch=batch, epochs=epochs, seed=seed,
                aligned_start=aligned,
                windows_a_worker_an_epoch=steps // window,
                commits=t.ps_stats_["commits"],
                tau_mean=float(np.mean(taus)) if taus else None,
                tau_max=max(taus) if taus else None,
                tau_hist={str(k): taus.count(k) for k in sorted(set(taus))},
                epoch_mean_loss=[float(np.mean(by_epoch[e]))
                                 for e in sorted(by_epoch, key=str)],
                worker_epoch_mean_loss={
                    str(w): [float(np.mean(v[e])) for e in sorted(v, key=str)]
                    for w, v in sorted(by_worker.items(), key=str)},
                test_accuracy=float(acc), wall_s=wall)


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="ps_sweep.py")
    ap.add_argument("runs", nargs="+", metavar="WINDOW:LR")
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=sorted(_DATA), default="vgg_small")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--aligned-start", action="store_true")
    ap.add_argument("--algorithm", choices=sorted(_TRAINERS),
                    default="downpour")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated trainer seeds, one run each")
    ap.add_argument("--depth", type=int, choices=(0, 1), default=0)
    ap.add_argument("--transport", default="socket",
                    choices=("socket", "native", "shm", "inprocess"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip(), flush=True)
    mods = _modules(args.package, args.device, args.model,
                    args.algorithm)
    for spec in args.runs:
        window, lr = spec.split(":")
        for seed in (int(s) for s in args.seeds.split(",")):
            rec = run(mods, int(window), float(lr), args.batch, args.steps,
                      args.dtype == "f32", args.transport, args.depth,
                      args.epochs, seed, args.aligned_start)
            print(json.dumps(dict(package=args.package, model=args.model,
                                  device=args.device, dtype=args.dtype,
                                  **rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
