"""Evaluators: score a prediction column against a label column.

The port's own copy of ``distkeras_tpu/evaluators.py``: ``AccuracyEvaluator``
(the reference's), ``LossEvaluator`` (any loss of
:mod:`distkeras_tpu_torch.ops.losses`, evaluated on CPU tensors),
``FScoreEvaluator`` and ``AUCEvaluator``, numpy otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.ops.losses import get_loss


class AccuracyEvaluator:
    """Fraction of rows where prediction matches label.

    Handles prediction columns holding class scores (argmaxed), probabilities,
    or already-integer indices; labels one-hot or integer.
    """

    def __init__(self, prediction_col: str = "prediction", label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, ds: Dataset) -> float:
        pred = _class_indices(ds[self.prediction_col], len(ds))
        label = _class_indices(ds[self.label_col], len(ds))
        return float(np.mean(pred == label))


class LossEvaluator:
    """Mean loss of a prediction column vs labels (any registered loss)."""

    def __init__(self, loss="mse", prediction_col: str = "prediction",
                 label_col: str = "label"):
        self.loss_fn = get_loss(loss)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, ds: Dataset) -> float:
        return float(self.loss_fn(torch.as_tensor(ds[self.label_col]),
                                  torch.as_tensor(ds[self.prediction_col])))


def _class_indices(arr, n_rows: int) -> np.ndarray:
    """Scores [N, C] → argmax; one-hot → argmax; integers pass through."""
    arr = np.asarray(arr)
    if arr.ndim > 1 and arr.shape[-1] > 1:
        return np.argmax(arr, axis=-1).astype(np.int64)
    return np.round(arr.reshape(n_rows, -1)[:, 0]).astype(np.int64)


class FScoreEvaluator:
    """Precision / recall / F1 (beyond the reference's accuracy-only module).

    ``average="binary"`` scores class ``pos_label`` only; ``"macro"``
    averages the per-class scores unweighted over the union of classes
    present in the labels or the predictions (sklearn semantics — a class
    predicted but absent from the eval split still counts, as 0).
    Zero-division cases score 0, sklearn-style.
    """

    def __init__(self, metric: str = "f1", average: str = "binary",
                 pos_label: int = 1, prediction_col: str = "prediction",
                 label_col: str = "label"):
        if metric not in ("f1", "precision", "recall"):
            raise ValueError(
                f"metric={metric!r}: expected 'f1', 'precision', or 'recall'"
            )
        if average not in ("binary", "macro"):
            raise ValueError(
                f"average={average!r}: expected 'binary' or 'macro'"
            )
        self.metric = metric
        self.average = average
        self.pos_label = int(pos_label)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def _score_one(self, pred, label, cls: int) -> float:
        tp = float(np.sum((pred == cls) & (label == cls)))
        fp = float(np.sum((pred == cls) & (label != cls)))
        fn = float(np.sum((pred != cls) & (label == cls)))
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        if self.metric == "precision":
            return precision
        if self.metric == "recall":
            return recall
        if precision + recall == 0.0:
            return 0.0
        return 2 * precision * recall / (precision + recall)

    def evaluate(self, ds: Dataset) -> float:
        pred = _class_indices(ds[self.prediction_col], len(ds))
        label = _class_indices(ds[self.label_col], len(ds))
        if self.average == "binary":
            return self._score_one(pred, label, self.pos_label)
        classes = np.union1d(np.unique(label), np.unique(pred))
        return float(np.mean(
            [self._score_one(pred, label, int(c)) for c in classes]
        ))


class AUCEvaluator:
    """ROC AUC from a score column (rank statistic, ties averaged).

    The prediction column may hold a single score per row or ``[N, C]``
    class scores — the ``pos_label`` column is the score and rows with
    ``label == pos_label`` are the positives (one-vs-rest for C > 2).
    A single score column is the score FOR class ``pos_label``: with
    ``pos_label == 0`` the 1-D scores are negated so "higher score" still
    means "more positive" (mirroring the column-select of the [N, C] path).
    """

    def __init__(self, prediction_col: str = "prediction",
                 label_col: str = "label", pos_label: int = 1):
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.pos_label = int(pos_label)

    def evaluate(self, ds: Dataset) -> float:
        scores = np.asarray(ds[self.prediction_col], np.float64)
        if scores.ndim > 1 and scores.shape[-1] > 1:
            if self.pos_label >= scores.shape[-1]:
                raise ValueError(
                    f"pos_label {self.pos_label} out of range for "
                    f"[N, {scores.shape[-1]}] score matrix"
                )
            scores = scores[:, self.pos_label]
        else:
            scores = scores.reshape(len(ds))
            if self.pos_label == 0:
                scores = -scores
            elif self.pos_label != 1:
                raise ValueError(
                    f"pos_label {self.pos_label} needs [N, C] class scores; "
                    "a single score column only identifies class 0 vs 1"
                )
        label = _class_indices(ds[self.label_col], len(ds))
        pos = label == self.pos_label
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if not n_pos or not n_neg:
            raise ValueError(
                f"AUC needs both classes; got {n_pos} positive / "
                f"{n_neg} negative rows"
            )
        # Mann-Whitney U via tie-averaged ranks, fully vectorized: each tie
        # group gets rank first_index + (count-1)/2 + 1
        order = np.argsort(scores, kind="mergesort")
        s = scores[order]
        uniq_first = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
        counts = np.diff(np.append(uniq_first, len(s)))
        group_rank = uniq_first + (counts - 1) / 2.0 + 1.0
        ranks = np.empty(len(s), np.float64)
        ranks[order] = np.repeat(group_rank, counts)
        u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
        return float(u / (n_pos * n_neg))
