"""Evaluation metrics on PyTorch. Port of ``distkeras_tpu/ops/metrics.py``:
classification accuracy and top-k accuracy."""

from __future__ import annotations

import torch


def _classes(y_true):
    if y_true.ndim > 1 and y_true.shape[-1] > 1:
        return torch.argmax(y_true, dim=-1)
    return y_true.to(torch.int64).reshape(y_true.shape[0], -1)[:, 0]


def accuracy(y_true, y_pred):
    """Classification accuracy. Accepts one-hot or integer ``y_true``;
    ``y_pred`` as class scores (argmaxed) or already-integer predictions."""
    if y_pred.ndim > 1 and y_pred.shape[-1] > 1:
        pred = torch.argmax(y_pred, dim=-1)
    else:
        pred = torch.round(y_pred).to(torch.int64).reshape(
            y_pred.shape[0], -1)[:, 0]
    return torch.mean((pred == _classes(y_true)).to(torch.float32))


def top_k_accuracy(y_true, y_pred, k: int = 5):
    if y_true.ndim > 1 and y_true.shape[-1] > 1:
        true = torch.argmax(y_true, dim=-1)
    else:
        true = y_true.to(torch.int64).reshape(-1)
    topk = torch.argsort(y_pred, dim=-1, stable=True)[:, -k:]
    return torch.mean(torch.any(topk == true[:, None], dim=-1)
                      .to(torch.float32))
