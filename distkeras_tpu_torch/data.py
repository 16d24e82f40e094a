"""Column-batch dataset — the Spark DataFrame replacement.

Port of ``distkeras_tpu/data.py`` (framework-free, kept as the port's own
copy). In the reference, training data lived in a Spark DataFrame whose RDD
was repartitioned to ``num_workers`` partitions; each partition became one
worker's shard (reference ``distkeras/trainers.py``, ``rdd.repartition`` +
``mapPartitionsWithIndex``; SURVEY.md §1). Here a host-side column store
assembles *superbatches* shaped ``[num_workers, window, batch, …]``: the
leading worker axis is the stacked-worker axis the engine vmaps, and the
``window`` axis is walked by the engine's window loop on the device.

Rows are never materialized as Python objects: all columns are contiguous
NumPy arrays, shuffles are index permutations, and shard assembly is a single
reshape/transpose — the host never becomes the bottleneck the Spark driver was.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Sequence

import numpy as np


class Dataset:
    """Immutable named-column store (all columns share the leading row count)."""

    def __init__(self, columns: Mapping[str, np.ndarray]):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        lengths = {k: len(v) for k, v in columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"column length mismatch: {lengths}")
        self._columns = {k: np.asarray(v) for k, v in columns.items()}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_arrays(cls, features, labels, features_col="features", label_col="label"):
        return cls({features_col: features, label_col: labels})

    # -- basic frame ops ----------------------------------------------------

    @property
    def columns(self) -> list[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return len(next(iter(self._columns.values())))

    num_rows = property(__len__)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        cols = dict(self._columns)
        cols[name] = np.asarray(values)
        return Dataset(cols)

    def select(self, names: Sequence[str]) -> "Dataset":
        return Dataset({n: self._columns[n] for n in names})

    def drop(self, name: str) -> "Dataset":
        return Dataset({k: v for k, v in self._columns.items() if k != name})

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._columns.items()})

    def gather(self, idx: np.ndarray) -> "Dataset":
        return Dataset({k: v[idx] for k, v in self._columns.items()})

    def concat(self, other: "Dataset") -> "Dataset":
        return Dataset(
            {k: np.concatenate([v, other[k]]) for k, v in self._columns.items()}
        )

    def split(self, fraction: float, seed: int = 0) -> tuple["Dataset", "Dataset"]:
        """Random train/test split. Parity: Spark ``df.randomSplit``."""
        n = len(self)
        perm = np.random.default_rng(seed).permutation(n)
        cut = int(n * fraction)
        return self.gather(perm[:cut]), self.gather(perm[cut:])

    def shuffle(self, seed: int = 0) -> "Dataset":
        """Full shuffle as an index permutation.

        Parity: reference ``distkeras/utils.py :: shuffle(df)``.
        """
        perm = np.random.default_rng(seed).permutation(len(self))
        return self.gather(perm)

    # -- sharding / batching -------------------------------------------------

    def superbatches(
        self,
        num_workers: int,
        batch_size: int,
        window: int,
        columns: Sequence[str],
        *,
        seed: int | None = None,
        drop_remainder: bool = True,
    ) -> Iterator[tuple[np.ndarray, ...]]:
        """Yield one epoch of superbatches ``[num_workers, window, batch, …]``.

        This is the rebuilt ``rdd.repartition(num_workers)`` +
        per-partition minibatch assembly (reference ``distkeras/workers.py``):
        a worker's row range plays the role of its Spark partition. With
        ``drop_remainder=True`` (default) rows left over after filling whole
        superbatches are dropped (the reference's partition tails were likewise
        truncated to whole minibatches); with ``drop_remainder=False`` the tail
        superbatch is filled by wrapping around to the start, so every row
        appears at least once (some up to twice) — shapes stay static.
        """
        n = len(self)
        n_super, rows_per_super = self._superbatch_counts(
            num_workers, batch_size, window, cover_all=not drop_remainder
        )
        idx = (
            np.random.default_rng(seed).permutation(n)
            if seed is not None
            else np.arange(n)
        )
        if n < n_super * rows_per_super:  # wrap-pad the tail superbatch
            idx = np.resize(idx, n_super * rows_per_super)
        for s in range(n_super):
            sl = idx[s * rows_per_super : (s + 1) * rows_per_super]
            out = []
            for c in columns:
                col = self._columns[c][sl]
                # Layout [window, W, batch, …] → [W, window, batch, …] so that
                # axis 0 is each worker's own stream.
                col = col.reshape((window, num_workers, batch_size) + col.shape[1:])
                out.append(np.swapaxes(col, 0, 1))
            yield tuple(out)

    def worker_shards(
        self,
        num_workers: int,
        batch_size: int,
        window: int,
        columns: Sequence[str],
        *,
        seed: int | None = None,
        cover_all: bool = False,
    ) -> tuple[np.ndarray, ...]:
        """Per-worker row shards ``[num_workers, rows_per_worker, …]``.

        The device-resident staging layout: upload once, then each epoch is
        reshaped/shuffled on device (``LocalSGDEngine.run_epoch_resident``).
        Rows are assigned to workers with the SAME window-major interleave as
        :meth:`superbatches` — a worker's shard flattens as
        ``[n_super, window, batch]`` — so resident and streaming training see
        identical data order when unshuffled, and class-sorted datasets never
        give a worker a single-class shard.

        ``cover_all=True`` wraps the tail so every row appears at least once
        (some twice); ``False`` drops the tail like :meth:`superbatches`.
        """
        n_super, rows_per_super = self._superbatch_counts(
            num_workers, batch_size, window, cover_all
        )
        idx = (
            np.random.default_rng(seed).permutation(len(self))
            if seed is not None
            else np.arange(len(self))
        )
        if len(idx) < n_super * rows_per_super:  # wrap-pad (cover_all)
            idx = np.resize(idx, n_super * rows_per_super)
        idx = idx[: n_super * rows_per_super]
        out = []
        for c in columns:
            col = self._columns[c][idx]
            col = col.reshape(
                (n_super, window, num_workers, batch_size) + col.shape[1:]
            )
            # [S, win, W, B, …] → [W, S, win, B, …] → [W, rows_per_worker, …]
            col = np.moveaxis(col, 2, 0)
            out.append(
                col.reshape(
                    (num_workers, n_super * window * batch_size) + col.shape[4:]
                )
            )
        return tuple(out)

    def _superbatch_counts(
        self, num_workers: int, batch_size: int, window: int,
        cover_all: bool = False,
    ) -> tuple[int, int]:
        """Shared sizing/validation for all superbatch assemblies."""
        n = len(self)
        rows_per_super = num_workers * batch_size * window
        n_super = n // rows_per_super
        if cover_all:
            n_super = -(-n // rows_per_super)
        elif n_super == 0:
            raise ValueError(
                f"dataset of {n} rows too small for one superbatch of "
                f"{rows_per_super} rows (workers={num_workers} × "
                f"window={window} × batch={batch_size})"
            )
        return n_super, rows_per_super

    def batches(
        self,
        batch_size: int,
        columns: Sequence[str],
        *,
        seed: int | None = None,
        drop_remainder: bool = True,
    ) -> Iterator[tuple[np.ndarray, ...]]:
        """Plain single-stream minibatches (the ``SingleTrainer`` path)."""
        for sb in self.superbatches(
            1, batch_size, 1, columns, seed=seed, drop_remainder=drop_remainder
        ):
            yield tuple(a[0, 0] for a in sb)

    def __repr__(self):
        cols = ", ".join(
            f"{k}:{v.dtype}{list(v.shape[1:])}" for k, v in self._columns.items()
        )
        return f"Dataset({len(self)} rows; {cols})"


def place_on(device):
    """A ``place`` callable for :func:`prefetch_to_device`: a tuple of host
    arrays → tensors on ``device``. For a CUDA device each array is copied
    into pinned (page-locked) host memory and sent with a non-blocking copy
    on the current stream, so the host thread does not wait for the
    transfer; PyTorch's pinned-memory allocator keeps the staging buffer
    alive until the copy has run."""
    import torch

    device = torch.device(device)

    def place(arrays):
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a))
                        for a in arrays)
        if device.type != "cuda":
            return tuple(t.to(device) for t in tensors)
        return tuple(t.pin_memory().to(device, non_blocking=True)
                     for t in tensors)

    return place


def prefetch_to_device(iterable, place, depth: int = 2):
    """Run ``place`` (host→device placement) ``depth`` items ahead of the
    consumer, on a background thread.

    The streaming input pipeline (SURVEY.md §7.3 hard part #4 — "sharded
    per-chip streams that don't bottleneck the chip"): CUDA launches are
    already asynchronous, so what a naive feed loop serializes with the
    device is the HOST work per step — numpy slicing/assembly in
    ``superbatches`` and the staging copy (:func:`place_on`). This generator
    moves that work off the consumer's critical path: a bounded queue of
    already-placed batches stays ``depth`` deep, so the device never waits
    for batch ``k+1``'s host prep while ``k`` computes.

    Exceptions from the producer (bad batch, placement failure) re-raise in
    the consumer; an early-exiting consumer (e.g. a raised training error)
    unblocks and joins the thread via generator close. Ordering is exactly
    the source iterable's, so prefetched training is bit-identical to the
    plain loop.

    Memory: up to ``depth + 1`` placed batches are resident at once (the
    queue plus the producer's in-flight one) on top of the consumer's —
    size ``depth`` for the device-memory headroom you have. Depth 1
    (double buffering) already hides the host prep; more only helps when
    step times vary a lot.
    """
    import queue
    import threading

    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def put_until_stopped(item) -> bool:
        """Deliver unless the consumer already left; never give up early —
        a dropped _END/_ERR sentinel would strand the consumer on q.get()."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put_until_stopped(place(item)):
                    return
            put_until_stopped(_END)
        except BaseException as e:  # surface in the consumer, don't die silent
            put_until_stopped((_ERR, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a producer stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)


def padded_chunks(
    cols: Sequence[np.ndarray], batch_size: int
) -> Iterator[tuple[list[np.ndarray], int]]:
    """Fixed-size chunks of column arrays for static-shape inference/eval.

    The tail chunk is padded by repeating its last row so every chunk has
    the SAME shape, so the downstream apply sees one shape. Yields
    ``(chunk_cols, n_real)``; callers trim or mask the ``batch_size -
    n_real`` pad rows. Shared by ``ModelPredictor.predict`` and the
    trainers' ``validation_data`` evaluator.
    """
    n = len(cols[0])
    for start in range(0, n, batch_size):
        chunk = [c[start : start + batch_size] for c in cols]
        real = len(chunk[0])
        pad = batch_size - real
        if pad:
            chunk = [
                np.concatenate([c, np.repeat(c[-1:], pad, axis=0)])
                for c in chunk
            ]
        yield chunk, real


def next_token_dataset(tokens: np.ndarray) -> Dataset:
    """``[N, L+1]`` token rows → Dataset with ``features`` ``[N, L]`` and the
    next-token ``label`` ``[N, L]`` (inputs shifted left by one) — the
    causal LM's training columns (``models.lm.transformer_lm_spec``)."""
    tokens = np.asarray(tokens, np.int32)
    return Dataset({"features": tokens[:, :-1], "label": tokens[:, 1:]})
