"""MNIST end to end on the port: the twin of ``examples/mnist.py``.

Build the data pipeline with transformers, train with a distributed
trainer, predict and evaluate accuracy, on the card unless ``--device cpu``
asks for the CPU::

    python -m distkeras_tpu_torch.examples.mnist --trainer adag --epochs 2
    python -m distkeras_tpu_torch.examples.mnist --trainer downpour \\
        --backend ps --compression int8 --workers 4
    python -m distkeras_tpu_torch.examples.mnist --device cpu --model mlp \\
        --rows 2048
    python -m distkeras_tpu_torch.examples.mnist --frontend keras
    python -m distkeras_tpu_torch.examples.mnist --ema 0.99

With ``--ema DECAY`` the Polyak average of the center is scored too. The
last line printed is ``test accuracy: <fraction>``.
"""

from __future__ import annotations

import argparse
import os

from distkeras_tpu_torch.datasets import is_synthetic, mnist
from distkeras_tpu_torch.evaluators import AccuracyEvaluator
from distkeras_tpu_torch.models import lenet, mlp
from distkeras_tpu_torch.predictors import ModelPredictor
from distkeras_tpu_torch.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    DynSGD,
    SingleTrainer,
)
from distkeras_tpu_torch.transformers import OneHotTransformer

TRAINERS = {
    "single": SingleTrainer,
    "adag": ADAG,
    "downpour": DOWNPOUR,
    "aeasgd": AEASGD,
    "eamsgd": EAMSGD,
    "dynsgd": DynSGD,
}

#: flags of the JAX example whose machinery is a later slice of the port
_LATER_FLAGS = {
    "int8_predict": "A11.5 (quantize_serving)",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trainer", choices=sorted(TRAINERS), default="adag")
    ap.add_argument("--model", choices=["cnn", "mlp"], default="cnn")
    ap.add_argument("--frontend", choices=["native", "keras"],
                    default="native",
                    help="the port's model zoo, or a user-written Keras 3 "
                         "model (KERAS_BACKEND=torch) handed straight to "
                         "the trainer")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--backend", choices=["collective", "ps"],
                    default="collective")
    ap.add_argument("--compression", choices=["int8", "topk"], default=None,
                    help="lossy commit compression for the PS wire "
                         "(backend=ps; error feedback keeps convergence)")
    ap.add_argument("--ema", type=float, default=None, metavar="DECAY",
                    help="Polyak/EMA averaging of the center; the averaged "
                         "model is also scored at the end")
    ap.add_argument("--int8-predict", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    for flag, item in _LATER_FLAGS.items():
        value = getattr(args, flag)
        if value not in (None, False):
            ap.error(f"--{flag.replace('_', '-')} is not ported yet: "
                     f"ROADMAP.md {item}")
    return args


def build_keras_model(kind: str):
    """A user-written Keras 3 model, as the JAX example builds it (on
    Keras's torch backend unless ``KERAS_BACKEND`` says otherwise)."""
    os.environ.setdefault("KERAS_BACKEND", "torch")
    import keras

    if kind == "cnn":
        layers = [
            keras.layers.Input((28, 28, 1)),
            keras.layers.Conv2D(32, 5, padding="same", activation="relu"),
            keras.layers.MaxPooling2D(),
            keras.layers.Conv2D(64, 5, padding="same", activation="relu"),
            keras.layers.MaxPooling2D(),
            keras.layers.Flatten(),
            keras.layers.Dense(256, activation="relu"),
            keras.layers.Dense(10),
        ]
    else:
        layers = [
            keras.layers.Input((28, 28, 1)),
            keras.layers.Flatten(),
            keras.layers.Dense(500, activation="relu"),
            keras.layers.Dense(300, activation="relu"),
            keras.layers.Dense(10),
        ]
    return keras.Sequential(layers)


def main(argv=None) -> float:
    args = parse_args(argv)
    print(f"device: {args.device}")
    kind = "synthetic stand-in" if is_synthetic("mnist") else "real"
    print(f"mnist: {kind}")

    train, test = mnist(n_train=args.rows, n_test=2048)
    # reference-style feature pipeline: one-hot labels for the loss
    onehot = OneHotTransformer(10, input_col="label",
                               output_col="label_onehot")
    train = onehot.transform(train)

    if args.frontend == "keras":
        model = build_keras_model(args.model)
    else:
        model = lenet() if args.model == "cnn" else mlp()
    cls = TRAINERS[args.trainer]
    kw = dict(loss="softmax_cross_entropy", worker_optimizer="adam",
              learning_rate=args.lr, batch_size=args.batch_size,
              label_col="label_onehot", num_epoch=args.epochs,
              device=args.device)
    if cls is not SingleTrainer:
        kw["num_workers"] = args.workers
        if args.window:
            kw["communication_window"] = args.window
        kw["backend"] = args.backend
        if args.compression:
            kw["compression"] = args.compression
    if args.ema is not None:
        kw["ema_decay"] = args.ema
    trainer = cls(model, **kw)

    trainer.train(train, shuffle=True)
    losses = [float(l) for l in trainer.get_history().losses()]
    print(f"trained {args.trainer} ({args.backend}) in "
          f"{trainer.get_training_time():.1f}s ({len(losses)} windows): "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    if args.ema is not None and trainer.ema_params_ is not None:
        ema_pred = ModelPredictor(trainer.spec, trainer.ema_params_,
                                  trainer.trained_nt_, device=args.device)
        print(f"EMA(decay={args.ema}) accuracy: "
              f"{AccuracyEvaluator().evaluate(ema_pred.predict(test)):.4f}")
    predictor = ModelPredictor(trainer.spec, trainer.trained_params_,
                               trainer.trained_nt_, device=args.device)
    acc = AccuracyEvaluator().evaluate(predictor.predict(test))
    print(f"test accuracy: {acc:.4f}", flush=True)
    return acc


if __name__ == "__main__":
    main()
