"""Checkpoint and resume: atomic epoch snapshots of the training state.

Port of ``distkeras_tpu/checkpoint.py`` (its single-process format). A
checkpoint is one file, ``ckpt_<step:012d>.dkc``: a
``utils.serialize_weights`` blob (an npz of the leaves beside the tree's
structure) written under a temporary name and renamed into place, with a
``latest.json`` sidecar naming the newest step and ``keep`` pruning of the
older ones. ``AsyncCheckpointer`` takes the host copy on the caller's
thread and serializes and writes it on a background thread.

A checkpoint written by the JAX package restores here too. Its ``.dkc``
pickles a jax ``PyTreeDef`` beside the same npz; :func:`load_checkpoint`
opens it with an unpickler that turns every global of jax, jaxlib, flax,
optax and the JAX package into an inert stub, and rebuilds the tree from
the stub's node list (post-order ``(kind, arity, data, type, leaves,
nodes)`` tuples) with the npz leaves in JAX flatten order: dict keys
sorted, the JAX ``TrainState``'s fields as a dict in the order ``center,
workers, nt, opt_state, step``, optax's states as plain tuples. No JAX is
needed. What crosses packages is the center (through
``convert.center_from_jax``), the epoch and the parameter server's
``num_updates``: optax's moments and the port's optimizer state differ in
layout, so worker state restarts and the trainers resume the elastic way
(:func:`warn_elastic_resume`). The port does not write files the JAX
package reads (it cannot pickle a jax treedef).

The process-sharded format of multi-process runs (``.dks``) waits for
``ROADMAP.md`` A12: a step held only in it raises ``NotImplementedError``.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import threading
import warnings
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from distkeras_tpu_torch import utils

Tree = Any

_PREFIX = "ckpt_"
_SUFFIX = ".dkc"
#: the JAX package's process-sharded format: one file a process plus a
#: meta file, in the same step namespace
_SHARD_SUFFIX = ".dks"

#: top-level packages whose pickled globals become inert stubs
_STUBBED = ("jax", "jaxlib", "flax", "optax", "distkeras_tpu", "distkeras")

#: field order of the JAX package's ``TrainState`` (a flax struct, walked
#: in declaration order)
_REFERENCE_FIELDS = {
    "distkeras_tpu.parallel.local_sgd.TrainState":
        ("center", "workers", "nt", "opt_state", "step"),
}

# jaxlib's PyTreeKind
_LEAF, _NONE, _TUPLE, _NAMEDTUPLE, _LIST, _DICT, _CUSTOM, _DATACLASS = \
    range(8)


def host_copy(tree: Tree) -> Tree:
    """A host copy that shares no memory with ``tree``: tensors leave the
    device (a synchronising copy from the card), CPU tensors and arrays
    are copied."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    return utils.host_tree_map(leaf, tree)


class AsyncCheckpointer:
    """Background checkpoint writer. ``save()`` copies the state to the host
    on the caller's thread, complete before it returns (the next window
    may overwrite or free the state's buffers), then serializes and writes
    it on one background thread, overlapping the next epoch. One save in
    flight: a newer ``save()`` (or ``wait()``) joins the previous one first
    and re-raises its error, so a failure surfaces at the next checkpoint
    boundary."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def save(self, directory, tree: Tree, step: int, keep: int = 3) -> None:
        self.wait()
        host_tree = host_copy(tree)

        def work():
            try:
                save_checkpoint(directory, host_tree, step, keep)
            except BaseException as e:  # surfaced by the next wait()
                self._err = e

        self._thread = threading.Thread(
            target=work, name=f"distkeras-ckpt-{step}", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save (if any) and re-raise its failure."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self._err = self._err, None
        if err is not None:
            raise err


def warn_elastic_resume(ckpt_workers: int, trainer_workers: int) -> None:
    """Both backends' elastic resume: the center carries over, per-worker
    optimizer state restarts."""
    warnings.warn(
        f"elastic resume: checkpoint has {ckpt_workers} workers, trainer "
        f"has {trainer_workers}; resuming from the center with fresh "
        f"per-worker optimizer state", stacklevel=3)


def should_checkpoint(epoch: int, every: int, num_epoch: int) -> bool:
    """The epoch-checkpoint cadence of both backends: every ``every``
    epochs, plus the final one."""
    return (epoch + 1) % every == 0 or epoch + 1 == num_epoch


def save_checkpoint(directory, tree: Tree, step: int, keep: int = 3) -> Path:
    """Atomically write ``tree`` as checkpoint ``step``; prune old ones."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    blob = utils.serialize_weights(tree)
    final = directory / f"{_PREFIX}{step:012d}{_SUFFIX}"
    _atomic_write(final, blob)
    _atomic_write(directory / "latest.json",
                  json.dumps({"step": step, "file": final.name}).encode())
    _prune_old_steps(directory, keep, current=step)
    return final


def _atomic_write(path: Path, blob: bytes) -> None:
    tmp = path.parent / f".tmp_{path.name}"
    tmp.write_bytes(blob)
    os.replace(tmp, path)


def _all_checkpoint_files(directory):
    """Every checkpoint file of either format, with its parsed step."""
    directory = Path(directory)
    for pattern in (f"{_PREFIX}*{_SUFFIX}", f"{_PREFIX}*{_SHARD_SUFFIX}"):
        for p in directory.glob(pattern):
            yield int(p.name[len(_PREFIX):].split(".")[0]), p


def _prune_old_steps(directory, keep: int, current: int | None = None):
    """Prune after writing step ``current``, across both formats (one step
    namespace). Saving ``current`` declares the live timeline: higher
    steps are an abandoned future (a run resumed from a rollback) and are
    truncated, so ``latest_step`` never resumes a dead timeline; among the
    rest the newest ``keep`` survive."""
    by_step: dict[int, list[Path]] = {}
    for step, p in _all_checkpoint_files(directory):
        by_step.setdefault(step, []).append(p)
    doomed = [s for s in by_step if current is not None and s > current]
    live = sorted(s for s in by_step if s not in set(doomed))
    doomed += live[:-keep]
    for step in doomed:
        for p in by_step[step]:
            p.unlink(missing_ok=True)


def latest_step(directory) -> int | None:
    """Newest checkpoint step in ``directory``, across both formats."""
    steps = [step for step, p in _all_checkpoint_files(directory)
             if p.suffix == _SUFFIX
             or p.name.endswith(f".meta{_SHARD_SUFFIX}")]
    return max(steps) if steps else None


class Restored(NamedTuple):
    """A loaded checkpoint: its tree, its step, and which package wrote it
    (``"port"`` or ``"jax"``)."""

    tree: Any
    step: int
    origin: str


def restore_checkpoint(directory, step: int | None = None) -> tuple:
    """Load checkpoint ``step`` (default: the latest): ``(tree, step)``.
    A file the JAX package wrote comes back as plain containers
    (:func:`load_checkpoint`)."""
    r = load_checkpoint(directory, step)
    return r.tree, r.step


def load_checkpoint(directory, step: int | None = None) -> Restored:
    """:func:`restore_checkpoint` with the writer's package. A step held in
    the process-sharded format raises ``NotImplementedError`` (A12)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    plain = directory / f"{_PREFIX}{step:012d}{_SUFFIX}"
    meta = directory / f"{_PREFIX}{step:012d}.meta{_SHARD_SUFFIX}"
    if meta.exists() and (not plain.exists()
                          or _sharded_is_newer(directory, step, plain, meta)):
        raise NotImplementedError(
            f"checkpoint {step} under {directory} is in the process-sharded "
            f"format (.dks), which is not ported yet: ROADMAP.md A12 "
            f"(meshes across cards)")
    if not plain.exists():
        raise FileNotFoundError(f"no checkpoint {step} under {directory}")
    tree, origin = _read_checkpoint(plain.read_bytes())
    return Restored(tree, step, origin)


def _sharded_is_newer(directory: Path, step: int, plain: Path,
                      meta: Path) -> bool:
    """Both formats hold ``step`` (a directory reused across a topology
    change): ``latest.json`` names the writer that ran last, mtime is the
    fallback."""
    rec = {}
    latest = directory / "latest.json"
    if latest.exists():
        try:
            rec = json.loads(latest.read_text())
        except ValueError:
            rec = {}
    if rec.get("step") == step and rec.get("file") in (meta.name,
                                                        plain.name):
        return rec["file"] == meta.name
    return meta.stat().st_mtime >= plain.stat().st_mtime


def _read_checkpoint(blob: bytes) -> tuple:
    """``(tree, origin)`` of one ``.dkc`` file's bytes, the port's or the
    JAX package's."""
    try:
        payload = _StubbingUnpickler(io.BytesIO(blob)).load()
    except Exception as e:
        raise ValueError(f"checkpoint is truncated or corrupt "
                         f"({type(e).__name__}: {e})") from e
    if not isinstance(payload, dict) or "npz" not in payload:
        raise ValueError("not a checkpoint: no npz payload")
    if "structure" in payload:
        return utils.weights_from_payload(payload), "port"
    if "treedef" in payload:
        return _reference_tree(payload["treedef"],
                               utils.npz_leaves(payload["npz"])), "jax"
    raise ValueError("checkpoint carries neither a structure nor a treedef")


class _Inert:
    """An inert stand-in for a pickled global of the JAX stack: it keeps
    what the pickle hands it and does nothing else."""

    where = ""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _StubbingUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _STUBBED:
            return type(name, (_Inert,), {"where": f"{module}.{name}"})
        return super().find_class(module, name)


def _reference_tree(treedef, leaves: list):
    """Rebuild a JAX ``PyTreeDef`` (stubbed) over its leaves. A node list
    that does not consume exactly the npz's leaves into one tree raises:
    a misread never loads quietly."""
    state = getattr(treedef, "state", None)
    try:
        _registry, nodes = state
        nodes = [tuple(n) for n in nodes]
    except (TypeError, ValueError) as e:
        raise ValueError(f"unrecognised PyTreeDef state {state!r}") from e
    it = iter(leaves)
    stack: list = []
    for node in nodes:
        kind, arity = int(node[0]), int(node[1])
        if arity > len(stack):
            raise ValueError(f"PyTreeDef node {node} has {arity} children, "
                             f"{len(stack)} are built")
        kids = stack[len(stack) - arity:]
        del stack[len(stack) - arity:]
        if kind == _LEAF:
            try:
                stack.append(next(it))
            except StopIteration:
                raise ValueError("PyTreeDef has more leaves than the npz "
                                 f"({len(leaves)})") from None
        elif kind == _NONE:
            stack.append(None)
        elif kind == _DICT:
            stack.append(dict(zip(node[2], kids)))
        elif kind == _LIST:
            stack.append(list(kids))
        elif kind in (_TUPLE, _NAMEDTUPLE):
            stack.append(tuple(kids))
        elif kind in (_CUSTOM, _DATACLASS):
            where = next((getattr(x, "where", "") for x in node[2:4]
                          if isinstance(x, type)
                          and issubclass(x, _Inert)), "")
            fields = _REFERENCE_FIELDS.get(where)
            stack.append(dict(zip(fields, kids))
                         if fields and len(fields) == arity else tuple(kids))
        else:
            raise ValueError(f"unknown PyTreeDef node kind {kind}")
    if len(stack) != 1 or next(it, None) is not None:
        raise ValueError(f"PyTreeDef does not cover the npz's "
                         f"{len(leaves)} leaves")
    return stack[0]


__all__ = ["AsyncCheckpointer", "Restored", "host_copy", "latest_step",
           "load_checkpoint", "restore_checkpoint", "save_checkpoint",
           "should_checkpoint", "warn_elastic_resume"]
