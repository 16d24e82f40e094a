"""Small helpers shared across the port: device resolution, nested-dict
tree maps, and the training history and timer the trainers keep."""

from __future__ import annotations

import json
import time
from collections.abc import Mapping

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU: ``device="cuda"`` is every default, and a CUDA device on a
    machine without one raises here instead of quietly running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU"
        )
    return dev


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested mappings (tensors or arrays), keyed
    alike in ``tree`` and every tree of ``rest``; returns plain dicts."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested mappings, in key order."""
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def fold_vmapped(x, bdim, size):
    """Inside a ``torch.func.vmap`` rule: move the vmapped dim ``bdim`` of
    ``x`` to the front (or broadcast an unbatched input, ``bdim`` None, to
    ``size``) and fold it into the leading axis, so one kernel launch
    serves every vmapped slice."""
    x = x.movedim(bdim, 0) if bdim is not None else x.expand(size, *x.shape)
    return x.reshape(size * x.shape[1], *x.shape[2:])


def unfold_vmapped(x, size):
    """The inverse of :func:`fold_vmapped` for an output: ``[size · n, …]``
    → ``[size, n, …]``."""
    return x.reshape(size, x.shape[0] // size, *x.shape[1:])


def json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


class History:
    """Append-only per-run training history (loss per window)."""

    def __init__(self):
        self.records: list[dict] = []

    def append(self, **record):
        self.records.append(record)

    def losses(self) -> list[float]:
        return [r["loss"] for r in self.records if "loss" in r]

    def to_json(self) -> str:
        return json.dumps(self.records, default=json_default)

    def __len__(self):
        return len(self.records)

    def __iter__(self):
        return iter(self.records)


class Timer:
    """Wall-clock bookkeeping for ``record_training_start/end`` and
    ``get_training_time``."""

    def __init__(self):
        self.start_time = None
        self.end_time = None

    def start(self):
        self.start_time = time.time()

    def stop(self):
        self.end_time = time.time()

    def elapsed(self) -> float:
        if self.start_time is None:
            return 0.0
        end = self.end_time if self.end_time is not None else time.time()
        return end - self.start_time
