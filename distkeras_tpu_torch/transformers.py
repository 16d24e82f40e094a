"""Spark-ML-style feature transformers over :class:`distkeras_tpu_torch.data.Dataset`.

The port's own copy of ``distkeras_tpu/transformers.py`` (numpy, no
framework): ``LabelIndexTransformer, OneHotTransformer, MinMaxTransformer,
StandardScaleTransformer, ReshapeTransformer, DenseTransformer,
SequencePadTransformer`` and :class:`TransformerPipeline`. Each
``transform`` is one vectorized NumPy pass over a column, keeping the
reference's ``transform(dataset) -> dataset`` calling convention; the card
never sees untransformed data.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.data import Dataset


class Transformer:
    def transform(self, ds: Dataset) -> Dataset:
        raise NotImplementedError

    def __call__(self, ds: Dataset) -> Dataset:
        return self.transform(ds)


class LabelIndexTransformer(Transformer):
    """One-hot / score column → integer class index column.

    Parity: reference ``distkeras/transformers.py :: LabelIndexTransformer``
    (used to turn prediction vectors into label indices).
    """

    def __init__(self, output_dim: int | None = None,
                 input_col="prediction", output_col="prediction_index"):
        self.output_dim = output_dim
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, ds: Dataset) -> Dataset:
        col = ds[self.input_col]
        if col.ndim == 1:
            idx = np.round(col).astype(np.int32)
        else:
            idx = np.argmax(col, axis=-1).astype(np.int32)
        return ds.with_column(self.output_col, idx)


class OneHotTransformer(Transformer):
    """Integer label column → one-hot float column.

    Parity: reference ``distkeras/transformers.py :: OneHotTransformer``.
    """

    def __init__(self, output_dim: int, input_col="label", output_col="label_onehot"):
        self.output_dim = output_dim
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, ds: Dataset) -> Dataset:
        labels = ds[self.input_col].astype(np.int64).reshape(-1)
        onehot = np.zeros((len(labels), self.output_dim), dtype=np.float32)
        onehot[np.arange(len(labels)), labels] = 1.0
        return ds.with_column(self.output_col, onehot)


class MinMaxTransformer(Transformer):
    """Affine rescale of a feature column to ``[o_min, o_max]``.

    Parity: reference ``distkeras/transformers.py :: MinMaxTransformer``
    (constructor took the current and target ranges).
    """

    def __init__(self, n_min=0.0, n_max=1.0, o_min=0.0, o_max=255.0,
                 input_col="features", output_col=None):
        self.n_min, self.n_max = float(n_min), float(n_max)
        self.o_min, self.o_max = float(o_min), float(o_max)
        self.input_col = input_col
        self.output_col = output_col or input_col

    def transform(self, ds: Dataset) -> Dataset:
        x = ds[self.input_col].astype(np.float32)
        scale = (self.n_max - self.n_min) / (self.o_max - self.o_min)
        return ds.with_column(self.output_col, (x - self.o_min) * scale + self.n_min)


class StandardScaleTransformer(Transformer):
    """Zero-mean unit-variance scaling (extension beyond the reference)."""

    def __init__(self, input_col="features", output_col=None, eps=1e-8):
        self.input_col = input_col
        self.output_col = output_col or input_col
        self.eps = eps

    def transform(self, ds: Dataset) -> Dataset:
        x = ds[self.input_col].astype(np.float32)
        mean = x.mean(axis=0, keepdims=True)
        std = x.std(axis=0, keepdims=True)
        return ds.with_column(self.output_col, (x - mean) / (std + self.eps))


class ReshapeTransformer(Transformer):
    """Reshape each row of a column (e.g. flat 784 → (28, 28, 1) for CNNs).

    Parity: reference ``distkeras/transformers.py :: ReshapeTransformer``.
    """

    def __init__(self, input_col, output_col, shape):
        self.input_col = input_col
        self.output_col = output_col
        self.shape = tuple(shape)

    def transform(self, ds: Dataset) -> Dataset:
        x = ds[self.input_col]
        return ds.with_column(self.output_col, x.reshape((len(ds),) + self.shape))


class DenseTransformer(Transformer):
    """Sparse (indices, values) representation → dense vectors.

    Parity: reference ``distkeras/transformers.py :: DenseTransformer`` (Spark
    sparse vectors → dense). Input column holds ``(idx, val)`` object pairs or
    an already-dense array (then it's a no-op cast).
    """

    def __init__(self, input_col="features", output_col="features_dense", dim=None):
        self.input_col = input_col
        self.output_col = output_col
        self.dim = dim

    def transform(self, ds: Dataset) -> Dataset:
        col = ds[self.input_col]
        if col.dtype != object:
            return ds.with_column(self.output_col, col.astype(np.float32))
        if self.dim is None:
            raise ValueError("dim required to densify sparse rows")
        out = np.zeros((len(col), self.dim), dtype=np.float32)
        for i, (idx, val) in enumerate(col):
            out[i, np.asarray(idx, dtype=np.int64)] = val
        return ds.with_column(self.output_col, out)


class SequencePadTransformer(Transformer):
    """Pad/truncate variable-length int sequences to a static length + mask.

    The IMDB-LSTM path pads here on the host (the kernels take static
    shapes) and carries a mask column for the masked loss.
    """

    def __init__(self, maxlen: int, input_col="sequence",
                 output_col="tokens", mask_col="mask", pad_value=0):
        self.maxlen = maxlen
        self.input_col = input_col
        self.output_col = output_col
        self.mask_col = mask_col
        self.pad_value = pad_value

    def transform(self, ds: Dataset) -> Dataset:
        col = ds[self.input_col]
        n = len(col)
        tokens = np.full((n, self.maxlen), self.pad_value, dtype=np.int32)
        mask = np.zeros((n, self.maxlen), dtype=np.float32)
        for i, seq in enumerate(col):
            seq = np.asarray(seq, dtype=np.int32)[: self.maxlen]
            tokens[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1.0
        return ds.with_column(self.output_col, tokens).with_column(self.mask_col, mask)


class TransformerPipeline(Transformer):
    """Apply a list of transformers in order (Spark ``Pipeline`` analogue)."""

    def __init__(self, stages):
        self.stages = list(stages)

    def transform(self, ds: Dataset) -> Dataset:
        for stage in self.stages:
            ds = stage.transform(ds)
        return ds
