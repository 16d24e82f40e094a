"""Loss functions by Keras-style name, on PyTorch.

Port of ``distkeras_tpu/ops/losses.py``: each name resolves to a pure
function ``(y_true, y_pred) -> scalar`` that ``torch.func`` can vmap and
differentiate. Every reduction is a mean over all axes (Keras' default);
log/exp math runs in float32 even when activations are bfloat16.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

_EPS = 1e-7


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def _labels(y_true, shape):
    return y_true.to(torch.int64).reshape(shape)


def mean_squared_error(y_true, y_pred):
    return torch.mean(torch.square(_f32(y_pred) - _f32(y_true)))


def mean_absolute_error(y_true, y_pred):
    return torch.mean(torch.abs(_f32(y_pred) - _f32(y_true)))


def categorical_crossentropy(y_true, y_pred):
    """Keras-style CCE on *probabilities* (model ends in softmax)."""
    p = torch.clamp(_f32(y_pred), _EPS, 1.0 - _EPS)
    return torch.mean(-torch.sum(_f32(y_true) * torch.log(p), dim=-1))


def softmax_cross_entropy(y_true, y_pred):
    """CCE on *logits*."""
    logp = F.log_softmax(_f32(y_pred), dim=-1)
    return torch.mean(-torch.sum(_f32(y_true) * logp, dim=-1))


def sparse_softmax_cross_entropy(y_true, y_pred):
    """CCE on logits with integer class labels."""
    logp = F.log_softmax(_f32(y_pred), dim=-1)
    labels = _labels(y_true, y_pred.shape[:-1])
    return torch.mean(-torch.gather(logp, -1, labels[..., None]))


def sparse_categorical_crossentropy(y_true, y_pred):
    """Keras-style sparse CCE on *probabilities*; for logits use
    ``'sparse_softmax_cross_entropy'``."""
    p = torch.clamp(_f32(y_pred), _EPS, 1.0 - _EPS)
    labels = _labels(y_true, y_pred.shape[:-1])
    return torch.mean(-torch.log(torch.gather(p, -1, labels[..., None])))


def binary_crossentropy(y_true, y_pred):
    p = torch.clamp(_f32(y_pred), _EPS, 1.0 - _EPS)
    t = _f32(y_true)
    return torch.mean(-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)))


def sigmoid_binary_crossentropy(y_true, y_pred):
    """BCE on logits, in the log(1+exp(-|x|)) form."""
    logits = _f32(y_pred)
    t = _f32(y_true)
    return torch.mean(torch.clamp(logits, min=0) - logits * t
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def masked_sparse_softmax_cross_entropy(y_true, y_pred, mask):
    """Sequence CCE with a validity mask: padded positions are excluded."""
    logp = F.log_softmax(_f32(y_pred), dim=-1)
    labels = y_true.to(torch.int64)
    picked = torch.gather(logp, -1, labels[..., None])[..., 0]
    m = _f32(mask)
    return -torch.sum(picked * m) / torch.clamp(torch.sum(m), min=1.0)


_LOSSES: dict[str, Callable] = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "categorical_crossentropy": categorical_crossentropy,
    "softmax_cross_entropy": softmax_cross_entropy,
    "sparse_softmax_cross_entropy": sparse_softmax_cross_entropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "sigmoid_binary_crossentropy": sigmoid_binary_crossentropy,
}


def get_loss(loss) -> Callable:
    """Resolve a loss by Keras-style name, or pass a callable through."""
    if callable(loss):
        return loss
    try:
        return _LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"unknown loss {loss!r}; known: {sorted(_LOSSES)}"
        ) from None
