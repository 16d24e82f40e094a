#!/usr/bin/env python3
"""Config 3's parameter-server path (CIFAR-10 VGG-small under DOWNPOUR,
``bench.py:316-324``) at several communication windows and learning rates,
in the port or in the JAX package.

    python3 ps_sweep.py [--package torch|jax] [--device cuda|cpu]
        [--dtype bf16|f32] [--batch B] [--steps N] WINDOW:LR [WINDOW:LR ...]

Each ``WINDOW:LR`` is one run: 4 worker threads through the trainer's own
socket PS (``backend="ps"``, ``ps_transport="socket"``), 2 epochs of N
steps of B rows a worker (so N / WINDOW windows a worker an epoch; the
defaults, B = 512 and N = 32, are ``chip_smoke.py``'s 65536 rows an
epoch), Adam (the port's ``fused_adam``, the JAX package's ``adam``: the
same update), then held-out accuracy on 2048 stand-in rows through the
package's ``ModelPredictor`` and ``AccuracyEvaluator``. Prints one JSON
line a run: the epochs' mean losses, the accuracy and the commits. Gates
nothing: ``chip_smoke.py`` holds config 3 to its gates at one setting.

``--package torch`` (the default) imports nothing of JAX; ``--package
jax`` runs the reference on the CPU, where XLA's bf16 convolutions are
slow: ``--dtype f32`` with a smaller ``--batch`` keeps a run to minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

WORKERS, EPOCHS, TEST = 4, 2, 2048


def _modules(package: str, device: str):
    """The package's (cifar10, vgg_small, DOWNPOUR, ModelPredictor,
    AccuracyEvaluator, trainer kwargs, float32 dtype)."""
    if package == "jax":
        os.environ.setdefault("XLA_FLAGS",
                              f"--xla_force_host_platform_device_count="
                              f"{WORKERS}")
        import jax

        if device == "cpu":
            jax.config.update("jax_platforms", "cpu")
        from distkeras_tpu.datasets import cifar10
        from distkeras_tpu.evaluators import AccuracyEvaluator
        from distkeras_tpu.models import vgg_small
        from distkeras_tpu.predictors import ModelPredictor
        from distkeras_tpu.trainers import DOWNPOUR

        return (cifar10, vgg_small, DOWNPOUR, ModelPredictor,
                AccuracyEvaluator, {"worker_optimizer": "adam"}, {},
                jax.numpy.float32)
    import torch

    from distkeras_tpu_torch.datasets import cifar10
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.models import vgg_small
    from distkeras_tpu_torch.predictors import ModelPredictor
    from distkeras_tpu_torch.trainers import DOWNPOUR

    return (cifar10, vgg_small, DOWNPOUR, ModelPredictor, AccuracyEvaluator,
            {"worker_optimizer": "fused_adam", "device": device},
            {"device": device}, torch.float32)


def run(mods, window: int, lr: float, batch: int, steps: int,
        f32: bool) -> dict:
    (cifar10, vgg_small, DOWNPOUR, ModelPredictor, AccuracyEvaluator,
     train_kw, predict_kw, float32) = mods
    train, test = cifar10(n_train=WORKERS * batch * steps, n_test=TEST)
    spec = vgg_small(dtype=float32) if f32 else vgg_small()
    t = DOWNPOUR(spec, loss="sparse_softmax_cross_entropy",
                 learning_rate=lr, num_workers=WORKERS, batch_size=batch,
                 communication_window=window, num_epoch=EPOCHS,
                 backend="ps", ps_transport="socket", **train_kw)
    t0 = time.perf_counter()
    center = t.train(train, shuffle=True)
    wall = time.perf_counter() - t0
    state = getattr(t, "trained_nt_", None)
    if state is not None and "device" not in predict_kw:
        predict_kw = {**predict_kw, "state": state}
    acc = AccuracyEvaluator().evaluate(
        ModelPredictor(spec, center, **predict_kw).predict(test))
    by_epoch: dict = {}
    for r in t.history.records:
        if "loss" in r:
            by_epoch.setdefault(r.get("epoch"), []).append(float(r["loss"]))
    return dict(window=window, lr=lr, batch=batch,
                windows_a_worker_an_epoch=steps // window,
                commits=t.ps_stats_["commits"],
                epoch_mean_loss=[float(np.mean(by_epoch[e]))
                                 for e in sorted(by_epoch, key=str)],
                test_accuracy=float(acc), wall_s=wall)


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="ps_sweep.py")
    ap.add_argument("runs", nargs="+", metavar="WINDOW:LR")
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip(), flush=True)
    mods = _modules(args.package, args.device)
    for spec in args.runs:
        window, lr = spec.split(":")
        rec = run(mods, int(window), float(lr), args.batch, args.steps,
                  args.dtype == "f32")
        print(json.dumps(dict(package=args.package, device=args.device,
                              dtype=args.dtype, **rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
