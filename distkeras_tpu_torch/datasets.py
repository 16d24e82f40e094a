"""Benchmark datasets for the five BASELINE configs.

Port of ``distkeras_tpu/datasets.py`` (numpy only, kept as the port's own
copy: same files searched, same synthetic stand-ins, same seeds). The
reference's examples pulled MNIST via Keras downloads and the ATLAS Higgs
CSV from CERN storage (``examples/mnist.py``, ``examples/workflow.ipynb`` —
SURVEY.md §2b #19). Nothing here downloads, so each loader:

1. uses a real on-disk copy if present (``$DISTKERAS_DATA/<name>.npz`` or the
   conventional ``~/.keras/datasets`` path), else
2. generates a **deterministic synthetic stand-in with identical shapes,
   dtypes, and class structure** — class-conditional Gaussian templates, so
   models genuinely learn (accuracy is meaningful, not chance) while the
   compute/communication profile matches the real config.

Every loader returns ``(train: Dataset, test: Dataset)`` with columns
``features`` / ``label``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from distkeras_tpu_torch.data import Dataset

def _search_dirs() -> list[str]:
    # read the env at call time, not import time: on a real pod the data dir
    # may be mounted/exported after this module is first imported
    return [
        os.environ.get("DISTKERAS_DATA", ""),
        str(Path.home() / ".keras" / "datasets"),
    ]


def _find(name: str) -> Path | None:
    for d in _search_dirs():
        if d and (p := Path(d) / name).exists():
            return p
    return None


def _class_template_images(
    n: int, num_classes: int, shape: tuple, seed: int, noise: float = 0.35,
    split: int = 0,
):
    """Class-conditional template + noise images in [0, 1].

    Templates are smooth low-frequency patterns per class; a linear probe gets
    well above chance and a CNN separates them almost perfectly — mirroring the
    easy/medium difficulty of MNIST/CIFAR for throughput benchmarking.

    The templates depend only on ``seed`` so train (``split=0``) and test
    (``split=1``) share one distribution; only the sampling noise differs.
    """
    templates = (
        np.random.default_rng(seed)
        .normal(0.5, 0.25, size=(num_classes,) + shape)
        .astype(np.float32)
    )
    rng = np.random.default_rng((seed, split))
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = templates[labels] + rng.normal(0.0, noise, size=(n,) + shape).astype(
        np.float32
    )
    return np.clip(x, 0.0, 1.0), labels


def mnist(n_train: int = 60000, n_test: int = 10000, seed: int = 0):
    """MNIST (28×28×1, 10 classes) or its synthetic stand-in."""
    p = _find("mnist.npz")
    if p is not None:
        with np.load(p) as z:
            xtr, ytr = z["x_train"][:n_train], z["y_train"][:n_train]
            xte, yte = z["x_test"][:n_test], z["y_test"][:n_test]
        xtr = (xtr.astype(np.float32) / 255.0)[..., None]
        xte = (xte.astype(np.float32) / 255.0)[..., None]
        ytr, yte = ytr.astype(np.int32), yte.astype(np.int32)
    else:
        xtr, ytr = _class_template_images(n_train, 10, (28, 28, 1), seed, split=0)
        xte, yte = _class_template_images(n_test, 10, (28, 28, 1), seed, split=1)
    return (
        Dataset.from_arrays(xtr, ytr),
        Dataset.from_arrays(xte, yte),
    )


def cifar10(n_train: int = 50000, n_test: int = 10000, seed: int = 10):
    """CIFAR-10 (32×32×3, 10 classes) or its synthetic stand-in."""
    p = _find("cifar10.npz")
    if p is not None:
        with np.load(p) as z:
            xtr = z["x_train"][:n_train].astype(np.float32) / 255.0
            xte = z["x_test"][:n_test].astype(np.float32) / 255.0
            ytr = z["y_train"][:n_train].astype(np.int32).reshape(-1)
            yte = z["y_test"][:n_test].astype(np.int32).reshape(-1)
    else:
        xtr, ytr = _class_template_images(
            n_train, 10, (32, 32, 3), seed, noise=0.45, split=0
        )
        xte, yte = _class_template_images(
            n_test, 10, (32, 32, 3), seed, noise=0.45, split=1
        )
    return Dataset.from_arrays(xtr, ytr), Dataset.from_arrays(xte, yte)


def higgs(n_train: int = 100000, n_test: int = 20000, seed: int = 20):
    """ATLAS-Higgs-style tabular binary classification (28 float features).

    The real dataset (``workflow.ipynb``'s ATLAS challenge CSV) is physics
    kinematics; the stand-in draws features from two overlapping Gaussians
    pushed through a random nonlinear mixing so a deep MLP beats a linear
    model, as on the real data.
    """
    p = _find("higgs.npz")
    rng = np.random.default_rng(seed)
    if p is not None:
        with np.load(p) as z:
            xtr = z["x_train"][:n_train].astype(np.float32)
            ytr = z["y_train"][:n_train].astype(np.int32).reshape(-1)
            xte = z["x_test"][:n_test].astype(np.float32)
            yte = z["y_test"][:n_test].astype(np.int32).reshape(-1)
    else:
        # One mixing matrix and mean-shift direction for both splits — train
        # and test must share the decision boundary; only the samples differ.
        # Signal = linear mean shift (a linear probe works, ~0.75) plus a
        # nonlinear component (a deep MLP does clearly better), mirroring the
        # real Higgs task's structure.
        w1 = rng.normal(0, 1, size=(28, 28)).astype(np.float32)
        u = rng.normal(0, 1, size=(28,)).astype(np.float32)
        u /= np.linalg.norm(u)

        def make(n, r):
            y = r.integers(0, 2, size=n).astype(np.int32)
            base = r.normal(0, 1, size=(n, 28)).astype(np.float32)
            shift = 1.1 * u[None, :] + np.tanh(base @ w1) * 0.7
            x = base + shift * y[:, None]
            return x.astype(np.float32), y

        xtr, ytr = make(n_train, rng)
        xte, yte = make(n_test, rng)
    return Dataset.from_arrays(xtr, ytr), Dataset.from_arrays(xte, yte)


def imdb(
    n_train: int = 25000,
    n_test: int = 25000,
    vocab: int = 20000,
    maxlen: int = 200,
    seed: int = 30,
):
    """IMDB-style variable-length token sequences, binary sentiment.

    Returns already-padded ``features`` int32[maxlen] plus a ``mask`` column —
    variable lengths are handled on the host so the model sees static shapes
    (SURVEY.md §7.3 hard part 3). Sentiment signal: each class draws tokens
    from a shifted Zipf distribution with a set of class-indicative tokens.
    """
    p = _find("imdb.npz")
    rng = np.random.default_rng(seed)
    if p is not None:
        with np.load(p, allow_pickle=True) as z:
            seqs_tr = z["x_train"][:n_train]
            ytr = z["y_train"][:n_train].astype(np.int32)
            seqs_te = z["x_test"][:n_test]
            yte = z["y_test"][:n_test].astype(np.int32)
    else:
        pos_tokens = rng.choice(np.arange(10, vocab), size=200, replace=False)
        neg_tokens = rng.choice(np.arange(10, vocab), size=200, replace=False)

        def make(n, r):
            y = r.integers(0, 2, size=n).astype(np.int32)
            seqs = []
            for yi in y:
                length = int(r.integers(20, maxlen))
                base = (r.zipf(1.3, size=length) % (vocab - 1) + 1).astype(np.int32)
                marks = pos_tokens if yi else neg_tokens
                n_marks = max(2, length // 8)
                pos = r.integers(0, length, size=n_marks)
                base[pos] = r.choice(marks, size=n_marks)
                seqs.append(base)
            return np.asarray(seqs, dtype=object), y

        seqs_tr, ytr = make(n_train, rng)
        seqs_te, yte = make(n_test, rng)

    def pad(seqs):
        tokens = np.zeros((len(seqs), maxlen), dtype=np.int32)
        mask = np.zeros((len(seqs), maxlen), dtype=np.float32)
        for i, s in enumerate(seqs):
            s = np.asarray(s, dtype=np.int32)[:maxlen]
            tokens[i, : len(s)] = s
            mask[i, : len(s)] = 1.0
        return tokens, mask

    ttr, mtr = pad(seqs_tr)
    tte, mte = pad(seqs_te)
    train = Dataset({"features": ttr, "mask": mtr, "label": ytr})
    test = Dataset({"features": tte, "mask": mte, "label": yte})
    return train, test


def is_synthetic(name: str) -> bool:
    """True when the named dataset will fall back to the synthetic stand-in."""
    return _find(f"{name}.npz") is None
