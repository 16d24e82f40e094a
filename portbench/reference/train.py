"""The reference's training windows: W workers, each starting a window
from the center and taking ``window`` Adam steps on its own rows, then the
merge rule folding the workers into the center.

Adam is optax's: ``m = b1 m + (1 − b1) g``, ``v = b2 v + (1 − b2) g²``,
``p −= lr · (m / (1 − b1^t)) / (sqrt(v / (1 − b2^t)) + eps)``, every
worker keeping its own moments from window to window. The merge rule
named ``rule`` is ``reference/rules/<rule>.py``: its ``fold(delta)``
gives the center's increment from the workers' ``worker_i − center``,
stacked ``[W, …]``. Each worker restarts from the new center. One worker
with a window of one step is plain Adam on one model.
"""

from __future__ import annotations

import importlib

import torch

from portbench.reference.numerics import matmul, no_tf32


def _norms(tree: dict) -> dict:
    names = list(tree)
    vals = torch.stack([torch.linalg.vector_norm(tree[n]) for n in names])
    return dict(zip(names, vals.cpu().tolist()))


def run(model: str, config: dict, params0: dict, windows: list, rule: str,
        lr: float, precision: str = "f32", b1: float = 0.9,
        b2: float = 0.999, eps: float = 1e-8) -> dict:
    """Readings of the windows ``windows`` (tuples of ``[W, window, B,
    …]`` columns) from the center ``params0``: ``{"loss": each window's
    mean loss over its steps and workers, "grad": {leaf: ‖Adam's first
    moment after the first window‖ over the stacked workers}, "change":
    {leaf: ‖center after the last window − params0‖}}``."""
    no_tf32()
    loss_and_grads = importlib.import_module(
        "portbench.reference." + model).loss_and_grads
    fold = importlib.import_module("portbench.reference.rules."
                                   + rule).fold
    mm = matmul(precision)
    W, win = windows[0][0].shape[:2]
    center = {n: v.detach().to(torch.float32).clone()
              for n, v in params0.items()}
    mu = {n: torch.zeros((W,) + c.shape, device=c.device)
          for n, c in center.items()}
    nu = {n: torch.zeros_like(x) for n, x in mu.items()}
    t = 0
    out = {"loss": []}
    for s, columns in enumerate(windows):
        workers = {n: c[None].expand((W,) + c.shape).clone()
                   for n, c in center.items()}
        losses = []
        for k in range(win):
            ls, grads = loss_and_grads(
                workers, tuple(c[:, k] for c in columns), config, mm)
            t += 1
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            with torch.no_grad():
                for n, g in grads.items():
                    mu[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    nu[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    workers[n] -= lr * (mu[n] / bc1) / (
                        torch.sqrt(nu[n] / bc2) + eps)
            losses.append(ls)
            del grads
        out["loss"].append(float(torch.stack(losses).mean()))
        if s == 0:
            out["grad"] = _norms(mu)
        with torch.no_grad():
            for n, c in center.items():
                c += fold(workers[n] - c[None])
        del workers
    out["change"] = _norms({n: c - params0[n] for n, c in center.items()})
    return out
