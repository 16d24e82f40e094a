"""Merge rules — each distributed algorithm's parameter-exchange semantics.

Port of ``distkeras_tpu/parallel/merge_rules.py``. Every algorithm shares
one skeleton: a worker trains locally for ``communication_window``
minibatches, then exchanges with the center. They differ only in what is
committed and how the center folds it in:

    merge(center, workers_stacked) -> (center', workers_stacked')

with ``workers_stacked`` carrying a leading ``W`` axis (every worker on
one card in this port; the reductions over W are the exchange). Trees
are dicts of tensors. Because every optimizer update is additive
(``params += update``), a worker's window-accumulated commit equals
``worker − center_at_pull``, so a rule needs only the post-window worker
params and the window-start center.

Each rule also has :meth:`MergeRule.fold`, the one-commit form of the
asynchronous parameter-server backend, over host numpy trees (nested
dicts) with plain operators.
"""

from __future__ import annotations

import warnings

import torch

from distkeras_tpu_torch.utils import tree_map


def _delta(workers, center):
    """Per-worker commit payload: worker − center, leafwise (stacked)."""
    return tree_map(lambda w, c: w - c[None], workers, center)


def _reset_to(center, workers):
    """Every worker re-based onto the new center (the post-merge pull)."""
    return tree_map(lambda c, w: c[None].to(w.dtype).expand(w.shape).clone(),
                    center, workers)


class MergeRule:
    """Base: subclasses define the stacked ``merge`` and the one-commit
    ``fold``."""

    #: whether workers are re-based onto the new center after each merge
    resets_workers: bool = True

    def merge(self, center, workers):
        raise NotImplementedError

    def fold(self, center, commit, num_workers: int, staleness: int):
        raise NotImplementedError


class ADAGMerge(MergeRule):
    """ADAG: center += mean over workers of (worker − center). With
    ``communication_window=1`` and SGD this is synchronous mean-gradient
    all-reduce. Fold: the commit normalized by the worker count."""

    def merge(self, center, workers):
        deltas = _delta(workers, center)
        center = tree_map(lambda c, d: c + torch.mean(d, dim=0, dtype=c.dtype),
                          center, deltas)
        return center, _reset_to(center, workers)

    def fold(self, center, commit, num_workers, staleness):
        return tree_map(lambda c, d: c + d / num_workers, center, commit)


class DownpourMerge(MergeRule):
    """DOWNPOUR: center += SUM over workers of (worker − center)."""

    def merge(self, center, workers):
        deltas = _delta(workers, center)
        center = tree_map(lambda c, d: c + torch.sum(d, dim=0, dtype=c.dtype),
                          center, deltas)
        return center, _reset_to(center, workers)

    def fold(self, center, commit, num_workers, staleness):
        return tree_map(lambda c, d: c + d, center, commit)


class ElasticAverageMerge(MergeRule):
    """AEASGD / EAMSGD: workers keep their own variables; each exchange
    moves worker and center toward each other by ``alpha = rho · lr``:
    ``diff_i = alpha (worker_i − center)``, ``worker_i −= diff_i``,
    ``center += Σ_i diff_i``. Stable for ``alpha · num_workers < 1``."""

    resets_workers = False

    def __init__(self, alpha: float, num_workers: int | None = None):
        self.alpha = float(alpha)
        if num_workers is not None and self.alpha * num_workers >= 1.0:
            warnings.warn(
                f"elastic force alpha={self.alpha:.3f} × num_workers="
                f"{num_workers} = {self.alpha * num_workers:.2f} ≥ 1: the "
                "lockstep center update will overshoot; lower rho, the "
                "learning rate, or the worker count",
                stacklevel=3,
            )

    def merge(self, center, workers):
        a = self.alpha
        diffs = tree_map(lambda w, c: a * (w - c[None]), workers, center)
        new_workers = tree_map(lambda w, d: w - d, workers, diffs)
        new_center = tree_map(
            lambda c, d: c + torch.sum(d, dim=0, dtype=c.dtype), center, diffs)
        return new_center, new_workers

    def fold(self, center, commit, num_workers, staleness):
        return tree_map(lambda c, d: c + d, center, commit)

    def worker_commit(self, worker, center):
        """The asynchronous worker's commit, ``alpha · (worker − center)``
        on host numpy trees; the worker subtracts it from itself too."""
        return tree_map(lambda w, c: self.alpha * (w - c), worker, center)


class DynSGDMerge(MergeRule):
    """DynSGD: each commit is scaled by ``1/(τ+1)``. Lockstep lowering:
    the commits fold in worker-index order, so worker i sees τ = i:
    ``center += Σ_i (worker_i − center)/(i+1)``."""

    def merge(self, center, workers):
        deltas = _delta(workers, center)

        def fold_leaf(c, d):
            w = d.shape[0]
            scale = 1.0 / (torch.arange(w, dtype=torch.float32,
                                        device=d.device) + 1.0)
            scale = scale.reshape((w,) + (1,) * (d.ndim - 1)).to(c.dtype)
            return c + torch.sum(d * scale, dim=0, dtype=c.dtype)

        center = tree_map(fold_leaf, center, deltas)
        return center, _reset_to(center, workers)

    def fold(self, center, commit, num_workers, staleness):
        s = 1.0 / (float(staleness) + 1.0)
        return tree_map(lambda c, d: c + d * s, center, commit)



def get_merge_rule(name: str, *, rho: float = 3.0, learning_rate: float = 0.05,
                   **_) -> MergeRule:
    """A trainer's merge rule by name (``adag``, ``downpour``, ``aeasgd`` /
    ``eamsgd`` / ``easgd`` with ``alpha = rho · learning_rate``,
    ``dynsgd``)."""
    name = name.lower()
    if name == "adag":
        return ADAGMerge()
    if name == "downpour":
        return DownpourMerge()
    if name in ("aeasgd", "eamsgd", "easgd"):
        return ElasticAverageMerge(alpha=rho * learning_rate)
    if name == "dynsgd":
        return DynSGDMerge()
    raise ValueError(f"unknown merge rule {name!r}")
