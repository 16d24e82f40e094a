"""Small helpers shared across the port: device resolution, nested-dict
tree maps and the host tree walk of the parameter server, weight and Keras
model serialization, the reference's row helpers, and the training history
and timer the trainers keep."""

from __future__ import annotations

import dataclasses
import io
import json
import pickle
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


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _is_dataclass(node) -> bool:
    return dataclasses.is_dataclass(node) and not isinstance(node, type)


def flatten(tree) -> tuple[list, object]:
    """``(leaves, structure)`` of a host tree of nested dicts, lists,
    tuples, ``NamedTuple``s and dataclasses (the engine's ``TrainState``):
    the parameter server's replacement for ``jax.tree.flatten``. Dict keys
    are walked in sorted order and a dataclass's fields in declaration
    order, as ``jax.tree`` walks a dict and a flax struct, so leaf ``i``
    names the same array in both packages; ``None`` is an empty subtree,
    as there."""
    leaves: list = []

    def walk(node):
        if isinstance(node, Mapping):
            keys = sorted(node)
            return (dict, keys, [walk(node[k]) for k in keys])
        if _is_dataclass(node):
            names = [f.name for f in dataclasses.fields(node)]
            return (type(node), names, [walk(getattr(node, n))
                                        for n in names])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(v) for v in node])
        if node is None:
            return (None, None, [])
        leaves.append(node)
        return None

    return leaves, walk(tree)


def unflatten(structure, leaves):
    """Rebuild the tree :func:`flatten` walked, from ``leaves`` in its
    order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, keys, kids = node
        if kind is None:
            return None
        if kind is dict:
            return {k: build(c) for k, c in zip(keys, kids)}
        if dataclasses.is_dataclass(kind):
            return kind(**{k: build(c) for k, c in zip(keys, kids)})
        if issubclass(kind, tuple) and hasattr(kind, "_fields"):
            return kind(*(build(c) for c in kids))
        return kind(build(c) for c in kids)

    return build(structure)


def flatten_with_paths(tree, is_leaf=None) -> tuple[list, object]:
    """``([(path, leaf)], structure)``: :func:`flatten` with each leaf's
    path written as ``jax.tree_util.keystr`` writes it, character for
    character (``['a']['b']`` for dict keys, ``[0]`` for list and tuple
    indices, ``.name`` for a ``NamedTuple``'s or a dataclass's fields; keys
    sorted, ``None`` an empty subtree). A node for which
    ``is_leaf(node)`` holds is one leaf, not walked into. The structure
    rebuilds with :func:`unflatten`."""
    pairs: list = []

    def walk(node, path):
        if is_leaf is not None and is_leaf(node):
            pairs.append((path, node))
            return None
        if isinstance(node, Mapping):
            keys = sorted(node)
            return (dict, keys, [walk(node[k], f"{path}[{k!r}]")
                                 for k in keys])
        if _is_dataclass(node) or _is_namedtuple(node):
            names = ([f.name for f in dataclasses.fields(node)]
                     if _is_dataclass(node) else list(node._fields))
            return (type(node), names if _is_dataclass(node) else None,
                    [walk(getattr(node, n), f"{path}.{n}")
                     for n in names])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(v, f"{path}[{i}]")
                                       for i, v in enumerate(node)])
        if node is None:
            return (None, None, [])
        pairs.append((path, node))
        return None

    return pairs, walk(tree, "")


def host_tree_map(fn, tree, *rest):
    """``fn`` over the leaves of host trees alike in structure (the
    parameter server's ``jax.tree.map``)."""
    leaves, st = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(st, [fn(*xs) for xs in zip(leaves, *others)])


def tree_like(saved, template, device=None):
    """``saved`` (a checkpoint's host tree: numpy leaves or CPU tensors) in
    ``template``'s structure and leaf types: a tensor leaf of ``template``
    takes its dtype and ``device`` (default: its own), any other leaf its
    Python type (an optimizer's step count comes back as an int)."""
    fresh, structure = flatten(template)
    leaves = flatten(saved)[0]
    if len(leaves) != len(fresh):
        raise ValueError(f"saved tree has {len(leaves)} leaves, the template "
                         f"{len(fresh)}")

    def leaf(h, f):
        if not isinstance(f, torch.Tensor):
            return type(f)(np.asarray(h).item())
        t = h if isinstance(h, torch.Tensor) else torch.from_numpy(
            np.array(h, copy=True))
        return t.to(device=f.device if device is None else device,
                    dtype=f.dtype, copy=True)

    return unflatten(structure, [leaf(h, f) for h, f in zip(leaves, fresh)])


def tree_to_numpy(tree):
    """Every leaf as a numpy array; tensors leave the device (a
    synchronising copy from the card; on the CPU the array may share the
    tensor's memory)."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return host_tree_map(leaf, tree)


def serialize_weights(tree) -> bytes:
    """A host tree as bytes: an ``.npz`` of its leaves beside its
    structure. A bf16 tensor leaf (numpy has no bf16) is stored as its
    int16 bits and comes back as a CPU bf16 tensor; every other leaf comes
    back as numpy. The structure is pickled, so deserialize only bytes
    this process's own code wrote."""
    leaves, st = flatten(tree)
    arrays, bf16 = [], []
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
            bf16.append(i)
            x = x.detach().cpu().view(torch.int16)
        arrays.append(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x))
    buf = io.BytesIO()
    np.savez(buf, *arrays)
    return pickle.dumps({"structure": st, "npz": buf.getvalue(),
                         "bf16": bf16})


def npz_leaves(blob: bytes) -> list:
    """The arrays of an ``np.savez`` blob, in the order they were saved."""
    with np.load(io.BytesIO(blob)) as npz:
        return [npz[f"arr_{i}"] for i in range(len(npz.files))]


def deserialize_weights(data: bytes):
    return weights_from_payload(pickle.loads(data))


def weights_from_payload(payload: dict):
    """The tree of an unpickled :func:`serialize_weights` payload."""
    leaves = npz_leaves(payload["npz"])
    for i in payload.get("bf16", ()):
        leaves[i] = torch.from_numpy(leaves[i]).view(torch.bfloat16)
    return unflatten(payload["structure"], leaves)


def serialize_keras_model(model) -> dict:
    """A Keras 3 model as ``{"model": architecture JSON, "weights": [numpy
    arrays]}``, the reference's ``serialize_keras_model``
    (``model.to_json()`` and ``model.get_weights()``)."""
    return {"model": model.to_json(),
            "weights": [np.asarray(w) for w in model.get_weights()]}


def deserialize_keras_model(payload: Mapping):
    """The Keras model :func:`serialize_keras_model` described, rebuilt
    with its weights (Keras is imported here, never at package import)."""
    import keras

    model = keras.models.model_from_json(payload["model"])
    model.set_weights(payload["weights"])
    return model


def uniform_weights(tree, bounds=(-0.5, 0.5), seed: int = 0):
    """Every leaf redrawn uniformly in ``bounds`` from a ``torch.Generator``
    seeded with ``seed`` (the reference's ``uniform_weights``; the JAX
    package draws from ``jax.random``, so the numbers differ). Leaves keep
    their dtype and, for tensors, their device."""
    lo, hi = float(bounds[0]), float(bounds[1])
    gen = torch.Generator().manual_seed(int(seed))

    def leaf(x):
        shape = tuple(x.shape)
        u = torch.rand(shape, generator=gen, dtype=torch.float32) \
            * (hi - lo) + lo
        if isinstance(x, torch.Tensor):
            return u.to(device=x.device, dtype=x.dtype)
        return u.numpy().astype(np.asarray(x).dtype)

    return host_tree_map(leaf, tree)


def shuffle(dataset):
    """The reference's ``shuffle(df)``: the dataset's rows in a new
    order."""
    return dataset.shuffle()


def new_dataframe_row(row: Mapping, name: str, value) -> dict:
    """The reference's ``new_dataframe_row``: the row with one more
    column."""
    out = dict(row)
    out[name] = value
    return out


def to_vector(label, n: int) -> np.ndarray:
    """Integer class label → one-hot float vector of length ``n``."""
    v = np.zeros(n, dtype=np.float32)
    v[int(label)] = 1.0
    return v


def to_dense_vector(values, indices=None, n: int | None = None) -> np.ndarray:
    """Sparse ``(indices, values)`` → dense float vector of length ``n``;
    with ``indices=None`` a dense float cast of ``values``."""
    if indices is None:
        return np.asarray(values, dtype=np.float32)
    out = np.zeros(n, dtype=np.float32)
    out[np.asarray(indices, dtype=np.int64)] = values
    return out


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

    def val_losses(self) -> list[float]:
        """The held-out losses of the trainers' ``validation_data``."""
        return [r["val_loss"] for r in self.records if "val_loss" in r]

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
